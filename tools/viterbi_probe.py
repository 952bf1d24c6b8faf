"""Where the general Viterbi ACS spends its time, the floors of its chain,
and the package's kernel against the one it replaced.

    python3 tools/viterbi_probe.py [--out viterbi_probe.json] [--steps T]

Builds tools/viterbi_probe.cu (an instrumented copy of the one-step-a-
barrier ``acs_cta_kernel`` that csrc/viterbi.cu had before its radix-4
redesign, the "baseline", and the chain floors, see its header) and the
package's csrc/viterbi.cu, then for S = 128, 256, 512 and 1024 states,
uint8 soft bits at R = 2 (a K = 8 ... 11 code's seeded noisy stream,
``chip_smoke.viterbi_stream``), T steps:

1. the split (S = 128 and 256; at 512 and 1024 mode 0 alone): each
   probe mode (one part of the step taken out) timed with CUDA events
   and thread 0's clock64() cycles a trellis step; mode 0 is the
   baseline kernel;
2. the floors: the chain alone at radix 2, 4 and 8 (one barrier every 1,
   2 or 3 steps), clock64 cycles a step;
3. the package's ``viterbi_acs_batched`` on the same stream: its decisions
   equal the baseline's (``equal``), its cycles a step (the kernel's own
   clock64 output) and both timed in turns (baseline, package, package,
   baseline).

Needs one CUDA card. Prints the card's name, power limit and maximum SM
clock, then one JSON object (also written to --out).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from sdrpp_tpu_torch.ops import fec as F  # noqa: E402
from sdrpp_tpu_torch.ops import fec_kernels as FK  # noqa: E402
from sdrpp_tpu_torch.utils import cuda_lib  # noqa: E402

ACS_MODES = {0: "baseline kernel", 1: "no barrier",
             2: "no predecessor reads", 4: "no branch metrics",
             8: "no ballot / store", 16: "no renormalisation bookkeeping",
             28: "the chain alone (barrier, reads, ACS, store)",
             31: "ACS and store only"}
FLOOR_LEVELS = {1: "radix 2", 2: "radix 4", 3: "radix 8"}
REPS = 5


def build_probe() -> ctypes.CDLL:
    src = ROOT / "tools" / "viterbi_probe.cu"
    out = Path(tempfile.mkdtemp()) / "libviterbi_probe.so"
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=900)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on the probe")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.acs_probe.argtypes = [p, p, p, i, i, i, i, p, p]
    lib.acs_floor.argtypes = [p, i, i, i, p, p, p]
    lib.acs_probe.restype = lib.acs_floor.restype = ctypes.c_int
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def timed(fn):
    fn()
    C.warm(fn, calls=2)
    return C.cuda_ms(fn, REPS)


def case(order: int, T: int):
    """(soft [T, 2] uint8 on the card, expected [2S, 2]) of a rate-1/2
    code of ``order`` (libcorrect's polynomials)."""
    polys = {8: F.CONV_R12_8, 9: F.CONV_R12_9}.get(order) or \
        C.fec_polys(2, order)
    code = F.ConvCode(2, order, polys, device="cuda")
    rng = np.random.default_rng(40 + order)
    soft = torch.from_numpy(C.viterbi_stream(rng, code, T)).cuda()
    return soft, code._expected


def probe_states(lib, S: int, T: int, split: bool = True) -> dict:
    soft, expected = case(S.bit_length(), T)
    R = soft.shape[1]
    dec = torch.empty((T, S // 32), dtype=torch.int32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")

    def probe(mode):
        rc = lib.acs_probe(soft.data_ptr(), expected.data_ptr(),
                           dec.data_ptr(), T, R, S, mode, cyc.data_ptr(),
                           stream())
        assert rc == 0, rc

    res = {"states": S, "steps": T, "split": {}, "floor": {}}
    for mode, name in ACS_MODES.items() if split else [(0, ACS_MODES[0])]:
        ms = timed(lambda: probe(mode))
        probe(mode)
        torch.cuda.synchronize()
        cps = int(cyc.item()) / T
        res["split"][name] = {"ms": ms, "cycles_per_step": cps}
        print(f"  S={S} mode {mode:2d} {name:44s} {ms:.4f} ms, {cps:.1f} "
              f"cycles a step", flush=True)
    probe(0)
    base = dec.clone()
    words = FK.viterbi_acs_batched(soft, torch.zeros(1, dtype=torch.int32,
                                                     device="cuda"), T,
                                   expected, cyc)
    torch.cuda.synchronize()
    res["package_cycles_per_step"] = int(cyc.item()) / T
    res["equal"] = bool(torch.equal(words.reshape(-1).view(torch.int32),
                                    base.reshape(-1)))
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    times = {"baseline": [], "package": []}
    for who in ("baseline", "package", "package", "baseline"):
        fn = (lambda: probe(0)) if who == "baseline" else (
            lambda: FK.viterbi_acs_batched(soft, start, T, expected))
        times[who].append(timed(fn))
    res.update(baseline_ms=times["baseline"], package_ms=times["package"])
    print(f"  S={S} package: equal {res['equal']}, "
          f"{res['package_cycles_per_step']:.1f} cycles a step, {times}",
          flush=True)
    res["floor"] = floors(lib, S, T, expected)
    return res


def floors(lib, S, T, expected=None) -> dict:
    if expected is None:
        expected = case(S.bit_length(), 16)[1]
    out = torch.empty(S, dtype=torch.float32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    res = {}
    for levels, name in FLOOR_LEVELS.items():
        def run():
            rc = lib.acs_floor(expected.data_ptr(), T, S, levels,
                               out.data_ptr(), cyc.data_ptr(), stream())
            assert rc == 0, rc
        ms = timed(run)
        run()
        torch.cuda.synchronize()
        steps = T // levels * levels
        res[name] = {"ms": ms, "cycles_per_step": int(cyc.item()) / steps}
        print(f"  S={S} floor {name}: {res[name]['cycles_per_step']:.1f} "
              f"cycles a step", flush=True)
    return res


def main() -> int:
    out_path = Path(sys.argv[sys.argv.index("--out") + 1]) \
        if "--out" in sys.argv else None
    T = int(sys.argv[sys.argv.index("--steps") + 1]) \
        if "--steps" in sys.argv else 16384
    if not torch.cuda.is_available():
        print("viterbi_probe: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    lib = build_probe()
    print(cuda_lib.build("viterbi").with_suffix(".log").read_text(),
          flush=True)
    result = {"device": gpu, "states": {}}
    for S in (128, 256, 512, 1024):
        result["states"][S] = probe_states(lib, S, T, split=S <= 256)
    text = json.dumps(result)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(text)
    print(text)
    ok = all(e.get("equal", True) for e in result["states"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
