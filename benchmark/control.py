"""The output check's two readings, from which its limits are set.

    python3 benchmark/control.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 --seconds 3 [--out readings.json]

In one process, on the card:

- the program's readings: a run of the cell (``harness.run_cell``, its
  own window at the cell's size and load, ``--seconds`` long) for each of
  ``--seeds``, and the numbers its output check compared;
- the control's readings: for each of ``--control-seeds``, the
  reference computed in the precision below the configuration's (its
  ``Reference(..., control=True)``: TF32 convolutions, float32
  elsewhere) put in the program's place, over as many blocks as a run
  keeps, drawn from the seed at window positions, and compared by the
  same numbers.

The benchmark's own runs never run this. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, traffic  # noqa: E402
from benchmark.harness import WARM_BLOCKS, run_cell  # noqa: E402
from benchmark.spec import load_cell  # noqa: E402

__all__ = ["program_readings", "control_readings"]


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def program_readings(cell, seeds, seconds, *, device="cuda", log=print,
                     **over) -> list[dict]:
    out = []
    for s in seeds:
        res, info = run_cell(cell, s, seconds, False, device=device,
                             log=log, **over)
        out.append({"seed": s, "correct": res["correct"],
                    "blocks": info["blocks_in_window"],
                    **{k: v["value"] for k, v in res["checks"].items()}})
        log(f"program seed {s}: {out[-1]}")
    return out


def control_readings(cell, seeds, span: int, *, device="cuda", log=print,
                     block=None, pool_blocks=None, check_blocks=None
                     ) -> list[dict]:
    """The control in the program's place: ``check_blocks`` block indices
    drawn from the seed in [WARM_BLOCKS, WARM_BLOCKS + span)."""
    tr = cell.traffic
    n = int(block or tr["block"])
    keep = int(check_blocks or tr["check_blocks"])
    ref_mod = cell.reference()
    ctl = ref_mod.Reference(cell.config, n, device=device, control=True)
    fs, offsets = cell.system().band(cell.config)
    out = []
    for s in seeds:
        pool = traffic.make_recording(tr, fs, offsets, s, device, block=n,
                                      pool_blocks=pool_blocks)
        rng = np.random.default_rng([s, 3])
        ks = sorted(int(k) for k in rng.choice(
            np.arange(WARM_BLOCKS, WARM_BLOCKS + span), keep, replace=False))
        got = {k: v.astype(np.float32) for k, v in
               ctl.run(pool, ks).items()}
        numbers, failing = check.compare(cell, ref_mod, pool, got, n, device)
        out.append({"seed": s, "blocks": ks, "failing": failing,
                    **{k: v["value"] for k, v in numbers.items()}})
        log(f"control seed {s}: {out[-1]}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="1-3")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py runs on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    t = time.perf_counter()
    prog = program_readings(cell, _seeds(args.seeds), args.seconds, log=log)
    span = int(np.median([r["blocks"] for r in prog]))
    ctl = control_readings(cell, _seeds(args.control_seeds), span, log=log)
    numbers = [k for k in ctl[0] if k not in ("seed", "blocks", "failing")]
    res = {"workload": cell.name, "program": prog, "control": ctl,
           "lower": {k: max(r[k] for r in prog) for k in numbers},
           "upper": {k: min(r[k] for r in ctl) for k in numbers},
           "seconds": time.perf_counter() - t}
    text = json.dumps(res)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
