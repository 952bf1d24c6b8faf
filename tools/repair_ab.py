"""Before and after on one card: the decoder paths that the loops'
warm-ups, LineSync's carried head and ATVDecoder's chroma loop change.

Each tree (this one, and a parent unpacked with ``git archive <commit> |
tar -x -C _scratch/parent``) runs in a process of its own, with its own
chip_smoke.py and its own kernels built from its sources, in the order
parent, change, change, parent. Each run measures:

- hrpt-3M: ``HRPTDecoder(device="cuda")`` over chip_smoke's HRPT pass
  (HRPT_FRAMES minor frames in 262,144-sample blocks), clean and in noise
  (HRPT_NOISE a component): the median CUDA-event and host ms a block
  (blocks 2..), and the wrong words of each frame;
- atv-11p25: ``ATVDecoder(device="cuda")`` over ATV_AB_BLOCKS 40-ms blocks
  of chip_smoke's PAL composite: the median CUDA-event and host ms a
  block (blocks 2..);
- line_sync_walk at each of chip_smoke's line cases: CUDA-event ms a
  call (20 calls after a warm-up).

    python tools/repair_ab.py --parent _scratch/parent [--out FILE]

prints the card's name and power limit, each run's line, and last one
JSON object: each metric's values in run order, keyed by tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ATV_AB_BLOCKS = 8
LINE_REPS = 20


def run_tree(tree: Path) -> dict:
    """The measurements in ``tree``'s own code (imported from it)."""
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as C
    from sdrpp_tpu_torch.decoders.atv import ATVDecoder
    from sdrpp_tpu_torch.decoders.hrpt import HRPTDecoder
    from sdrpp_tpu_torch.ops import sync_walks as W
    from sdrpp_tpu_torch.utils import cuda_lib

    for name in ("loop_scan", "mm_clock", "viterbi", "decim_fir",
                 "sync_walk"):
        cuda_lib.build(name)
    cuda_lib.build_host("kernels_host")
    dev = torch.device("cuda")
    out = {"hrpt": {}, "line": {}}
    words, clean = C.hrpt_pass()
    for sig, iq in (("clean", clean),
                    ("noisy", C.hrpt_pass(noise=C.HRPT_NOISE)[1])):
        dec = HRPTDecoder(C.HRPT_FS, device=dev)
        blocks, ms, wall, _ = C.run_decoder(dec, iq, dev="cuda")
        frames = sum(blocks, [])
        out["hrpt"][sig] = {
            "ms": float(np.median(ms[1:])),
            "host_ms": 1e3 * float(np.median(wall[1:])),
            "frames": len(frames),
            "wrong_words": [int((f.words != w).sum())
                            for f, w in zip(frames, words)]}
    iq = C.atv_composite(ATV_AB_BLOCKS * C.ATV_BLOCK // 720)
    dec = ATVDecoder(device=dev)
    ms, wall = [], []
    for k in range(ATV_AB_BLOCKS):
        x = torch.from_numpy(iq[k * C.ATV_BLOCK:(k + 1) * C.ATV_BLOCK]).to(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        dec.process(x)
        e1.record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        ms.append(e0.elapsed_time(e1))
    out["atv"] = {"ms": float(np.median(ms[1:])),
                  "host_ms": 1e3 * float(np.median(wall[1:]))}
    for kind, _, args in C.line_walk_cases(dev):
        C.warm(lambda a=args: W.line_sync_walk(*a), calls=3)
        out["line"][kind] = C.cuda_ms(lambda a=args: W.line_sync_walk(*a),
                                      LINE_REPS)
    return out


def main() -> int:
    argv = sys.argv[1:]
    if "--tree" in argv:
        res = run_tree(Path(argv[argv.index("--tree") + 1]).resolve())
        print(json.dumps(res), flush=True)
        return 0
    parent = (ROOT / argv[argv.index("--parent") + 1]).resolve()
    out_path = Path(argv[argv.index("--out") + 1]) if "--out" in argv \
        else None
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu, flush=True)
    runs = []
    for name, tree in (("parent", parent), ("change", ROOT),
                       ("change", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tree", str(tree)], capture_output=True,
                              text=True, timeout=1500)
        if proc.returncode:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"the {name} run failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(name, json.dumps(res), flush=True)
        runs.append((name, res))

    def series(get):
        got = {}
        for name, res in runs:
            try:
                got.setdefault(name, []).append(get(res))
            except KeyError:
                got.setdefault(name, []).append(None)
        return got

    summary = {"device": gpu}
    for sig in ("clean", "noisy"):
        for key in ("ms", "host_ms", "wrong_words"):
            summary[f"hrpt {sig} {key}"] = series(
                lambda r, s=sig, k=key: r["hrpt"][s][k])
    for key in ("ms", "host_ms"):
        summary[f"atv {key}"] = series(lambda r, k=key: r["atv"][k])
    for kind in dict.fromkeys(k for _, r in runs for k in r["line"]):
        summary[f"line_sync_walk {kind} ms"] = series(
            lambda r, k=kind: r["line"][k])
    text = json.dumps(summary)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
