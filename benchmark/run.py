"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints what it saw (the card, its power
limit and clocks, peak device memory, launches a block) on earlier
lines, each number of the output check beside its limit as the last
lines on standard error, and the result as one JSON object on the last
line of standard output. Exits non-zero, printing no result, without a
CUDA card (or with fewer cards than the cell asks for), or when JAX or
the JAX package was loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _err(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} CUDA card(s); this "
             f"process sees {torch.cuda.device_count()}")
        return 2

    from benchmark.harness import FORBIDDEN, run_cell

    result, info = run_cell(cell, args.seed % (1 << 64), args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, log=_err)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if info["jax_modules"] or loaded:
        _err(f"JAX or the JAX package was loaded: "
             f"{sorted(set(info['jax_modules'] + loaded))}")
        return 3
    print(f"card: {result['device']['kind']}, power limit, sm clock, "
          f"max sm clock: {info.pop('power')}")
    print(f"peak device memory: {result['device']['memory_peak_bytes']} "
          f"bytes")
    for k, v in info.items():
        print(f"{k}: {v}")
    for k, v in result["checks"].items():
        _err(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
