"""Where the LineSync, ChromaPLL and CyclicSync walks spend their time,
and the package's kernels against the ones they replaced.

    python3 tools/sync_walk_probe.py [--out walk_probe.json]
                                     [--only line,chroma,cyclic]

Builds tools/sync_walk_probe.cu (instrumented copies of the kernels
csrc/sync_walk.cu had before its redesigns, the "baseline", see its
header) and the package's csrc/sync_walk.cu, then on chip_smoke.py's walk
cases (``line_walk_cases``, ``chroma_walk_case``, ``cyclic_walk_cases``):

1. the split: each probe mode (one part of the walker's step taken out)
   timed with CUDA events and the walker's clock64() cycles a line, step
   or sample; mode 0 is the baseline kernel; for LineSync also the chain
   floor (``line_floor``: the one-warp sync chain alone);
2. the package's kernels against mode 0 on every case: outputs bit for
   bit (``equal``, and by output ``equal_fields``; CyclicSync must be
   equal, ChromaPLL's design differs by ulps: ``max_abs_diff``), times
   side by side in turns (baseline, package, package, baseline); LineSync
   is held bit for bit to its plain version instead (the baseline counts
   positions in float32 from the block start, given here the case's base
   + pos, where the package carries an integer base and a fraction and a
   compensated frequency), and its time also taken in SPREAD_ROUNDS
   rounds (``package_spread_ms``);
3. the package's kernels built with their stamps (``stamped``): each
   role's clock64() cycles a line, step or sample, outputs equal the
   package's.

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
from sdrpp_tpu_torch.ops import sync_walks as W  # noqa: E402
from sdrpp_tpu_torch.utils import cuda_lib  # noqa: E402

CHROMA_MODES = {0: "baseline kernel", 1: "no sincos", 2: "no atan2",
                4: "no fmodf wrap", 8: "no load / store",
                15: "none of the four"}
LINE_MODES = {0: "baseline kernel", 1: "no buffer loads",
              2: "no barriers", 4: "no shuffle trees", 8: "no update",
              16: "no line stores", 31: "none of the five"}
CYCLIC_MODES = {0: "baseline kernel", 1: "no buffer store",
                2: "branch-free emit", 3: "neither",
                11: "average chain alone", 7: "compare/select chain alone"}
REPS = 5
SPREAD_ROUNDS = 20   # rounds of REPS calls for the package's line spread


def build_probe() -> ctypes.CDLL:
    src = ROOT / "tools" / "sync_walk_probe.cu"
    out = Path(tempfile.mkdtemp()) / "libsync_walk_probe.so"
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=900)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on the probe")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chroma_probe.argtypes = ([p, i, i] + [p] * 5 + [i, i] + [f] * 4
                                 + [i, p, p])
    lib.cyclic_probe.argtypes = ([p, p, i] + [p] * 3 + [i, f, f] + [p] * 4
                                 + [i, p, i, p, p])
    lib.chroma_probe.restype = lib.cyclic_probe.restype = ctypes.c_int
    lib.chroma_burst_walk.argtypes = W._BURST_ARGS
    lib.cyclic_sync_walk.argtypes = W._CYCLIC_ARGS
    lib.line_probe.argtypes = ([p, i, i] + [p] * 7 + [i] + [f] * 6
                               + [i, p, p])
    lib.line_floor.argtypes = [p, i, i, p, p, i] + [f] * 6 + [p, p, p]
    lib.line_probe.restype = lib.line_floor.restype = ctypes.c_int
    lib.line_sync_walk.argtypes = W._LINE_ARGS
    lib.walk_stamps.argtypes = [p]
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def chroma_probe(lib, args, mode):
    burst, refs, carry, pre, post, a, b, lo, hi = args
    L, nb = burst.shape
    line_phase = carry.new_empty((L, 4))
    out = burst.new_empty((L, nb))
    carry_out = carry.new_empty(2)
    cycles = torch.zeros(3, dtype=torch.int64, device=burst.device)
    rc = lib.chroma_probe(burst.data_ptr(), L, nb, refs.data_ptr(),
                          carry.data_ptr(), carry_out.data_ptr(),
                          line_phase.data_ptr(), out.data_ptr(), pre, post,
                          *(float(np.float32(v)) for v in (a, b, lo, hi)),
                          mode, cycles.data_ptr(), stream())
    assert rc == 0, rc
    return (line_phase, out, carry_out), cycles


def cyclic_probe(lib, args, mode):
    rcorr, vals, carry, since, symbuf, max_syms, agc = args
    n, sym = rcorr.shape[0], symbuf.shape[0]
    dev = rcorr.device
    emits = torch.empty(max_syms, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    carry_out = carry.new_empty(3)
    since_out = torch.empty((), dtype=torch.int32, device=dev)
    symbuf_out = symbuf.new_empty(sym)
    cycles = torch.zeros(3, dtype=torch.int64, device=dev)
    agc = float(np.float32(agc))
    rc = lib.cyclic_probe(rcorr.data_ptr(), vals.data_ptr(), n,
                          carry.data_ptr(), since.data_ptr(),
                          symbuf.data_ptr(), sym, agc,
                          float(np.float32(1) - np.float32(agc)),
                          carry_out.data_ptr(), since_out.data_ptr(),
                          symbuf_out.data_ptr(), emits.data_ptr(), max_syms,
                          count.data_ptr(), mode, cycles.data_ptr(),
                          stream())
    assert rc == 0, rc
    return (emits, count, carry_out, since_out, symbuf_out), cycles


def baseline_carry(carry, base):
    """The baseline kernels' carry: float32 [2] (base + pos, freq)."""
    return torch.stack([(base[0].double() + carry[0].double()).float(),
                        carry[1]])


def line_probe(lib, args, mode):
    buf, bank, carry, base, locked, max_lines = args[:6]
    carry = baseline_carry(carry, base)
    head = args[12]
    n = buf.shape[0] - head
    dev = buf.device
    lines = buf.new_empty((max_lines, W.LINE_LEN))
    count = torch.empty((), dtype=torch.int32, device=dev)
    carry_out = carry.new_empty(2)
    locked_out = torch.empty((), dtype=torch.bool, device=dev)
    cycles = torch.zeros(2, dtype=torch.int64, device=dev)
    rc = lib.line_probe(buf.data_ptr(), n, head, bank.data_ptr(),
                        carry.data_ptr(), locked.data_ptr(),
                        carry_out.data_ptr(), locked_out.data_ptr(),
                        lines.data_ptr(), count.data_ptr(), max_lines,
                        *(float(np.float32(v)) for v in args[6:12]), mode,
                        cycles.data_ptr(), stream())
    assert rc == 0, rc
    return (lines, count, carry_out, locked_out), cycles


def line_floor(lib, args):
    """The one-warp sync chain alone (``line_floor_kernel``): clock64
    cycles a line."""
    buf, bank, carry, base, locked, max_lines = args[:6]
    carry = baseline_carry(carry, base)
    head = args[12]
    carry_out = carry.new_empty(2)
    cycles = torch.zeros(2, dtype=torch.int64, device=buf.device)

    def run():
        rc = lib.line_floor(buf.data_ptr(), buf.shape[0] - head, head,
                            bank.data_ptr(), carry.data_ptr(), max_lines,
                            *(float(np.float32(v)) for v in args[6:12]),
                            carry_out.data_ptr(), cycles.data_ptr(), stream())
        assert rc == 0, rc
    run()
    C.warm(run, calls=2)
    ms = C.cuda_ms(run, REPS)
    run()
    torch.cuda.synchronize()
    cyc, lines = cycles.cpu().tolist()
    return {"ms": ms, "cycles_per_line": cyc / max(lines, 1),
            "lines": lines}


def bits_of(x):
    return x.view(torch.uint8) if x.is_complex() else x


def same_bits(a, b):
    return all(torch.equal(bits_of(x), bits_of(y)) for x, y in zip(a, b))


def stamped(lib, entry, wrapper, args, steps, roles):
    """The package's kernel built with stamps (this file's library, its C
    entry ``entry``), launched once through ``wrapper``'s own arguments:
    each role's cycles a step, and its outputs equal the package's."""
    seen = {}

    def launch(fn, device, *cargs):
        seen["rc"] = fn(*cargs, stream())
        return seen["rc"]

    real = (W.cuda_lib.bind, W.cuda_lib.launch)
    W.cuda_lib.bind = lambda name, e, argtypes: getattr(lib, entry)
    W.cuda_lib.launch = launch
    try:
        stamps = (ctypes.c_ulonglong * 8)()
        lib.walk_stamps(stamps)
        got = wrapper(*args)
        torch.cuda.synchronize()
        lib.walk_stamps(stamps)
        wrapper.launches -= 1
    finally:
        W.cuda_lib.bind, W.cuda_lib.launch = real
    ref = wrapper(*args)
    wrapper.launches -= 1
    torch.cuda.synchronize()
    fields = [bool(torch.equal(bits_of(g), bits_of(r)))
              for g, r in zip(got, ref)]
    per = {role: stamps[k] / steps / div for k, (role, div) in
           enumerate(roles)}
    return {"cycles_per_step": per, "equal_fields": fields}


def split(fn, steps):
    """{mode name: ms, cycles a step, raw stamps} of one probe over its
    modes."""
    res = {}
    for mode in fn.modes:
        fn(mode)
        C.warm(lambda: fn(mode), calls=2)
        ms = C.cuda_ms(lambda: fn(mode), REPS)
        _, cyc = fn(mode)
        torch.cuda.synchronize()
        cyc = cyc.cpu().tolist()
        # a line probe counts its own lines (a mode may walk others)
        per = max(cyc[1], 1) if fn.modes is LINE_MODES else steps
        res[fn.modes[mode]] = {"ms": ms, "cycles_per_step": cyc[0] / per,
                               "cycles": cyc}
        print(f"  mode {mode:2d} {fn.modes[mode]:28s} {ms:.4f} ms, "
              f"{cyc[0] / per:.1f} cycles a step; {cyc}", flush=True)
    return res


def versus(probe, package, plain=None):
    """The baseline kernel (probe mode 0) against the package's on the same
    arguments: equal bit for bit (to ``plain``'s outputs where given, the
    plain version's on the CPU), and both timed in turns."""
    ref = plain() if plain else probe(0)[0]
    got = tuple(g.cpu() for g in package()) if plain else package()
    torch.cuda.synchronize()
    equal = same_bits(got, ref)
    fields = [bool(torch.equal(bits_of(g), bits_of(r)))
              for g, r in zip(got, ref)]
    diff = max(float(((g - r) if g.is_complex() else
                      (g.double() - r.double())).abs().max())
               for g, r in zip(got, ref) if g.numel())
    times = {"baseline": [], "package": []}
    for who in ("baseline", "package", "package", "baseline"):
        fn = (lambda: probe(0)) if who == "baseline" else package
        C.warm(fn, calls=2)
        times[who].append(C.cuda_ms(fn, REPS))
    return {"equal": bool(equal), "equal_fields": fields,
            "max_abs_diff": diff, "baseline_ms": times["baseline"],
            "package_ms": times["package"]}


def spread(fn, rounds: int = SPREAD_ROUNDS):
    """fn's ms a call (CUDA events, REPS calls) in each of ``rounds``
    rounds back to back: the spread of a kernel whose warps wait on each
    other."""
    C.warm(fn, calls=2)
    return [C.cuda_ms(fn, REPS) for _ in range(rounds)]


def main() -> int:
    out_path = Path(sys.argv[sys.argv.index("--out") + 1]) \
        if "--out" in sys.argv else None
    only = (sys.argv[sys.argv.index("--only") + 1].split(",")
            if "--only" in sys.argv else ["line", "chroma", "cyclic"])
    if not torch.cuda.is_available():
        print("sync_walk_probe: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)
    lib = build_probe()
    print(cuda_lib.build("sync_walk").with_suffix(".log").read_text(),
          flush=True)
    dev = torch.device("cuda")
    result = {"device": gpu, "line": {}, "chroma": {}, "cyclic": {}}
    for kind, _, args in C.line_walk_cases(dev) if "line" in only else ():
        lines = int(W.line_sync_walk_plain(*(
            a.cpu() if isinstance(a, torch.Tensor) else a
            for a in args))[1])

        def probe(mode, args=args):
            return line_probe(lib, args, mode)
        probe.modes = LINE_MODES
        print(f"line {kind} [{args[0].shape[0]}] {lines} lines", flush=True)
        entry = {"split": split(probe, max(lines, 1)) if kind == "atv"
                 else None, "lines": lines}
        if kind == "atv":
            entry["floor"] = line_floor(lib, args)
            print(f"  chain floor {entry['floor']}", flush=True)
        entry.update(versus(
            probe, lambda a=args: W.line_sync_walk(*a),
            plain=lambda a=args: W.line_sync_walk_plain(*(
                x.cpu() if isinstance(x, torch.Tensor) else x for x in a))))
        entry["package_spread_ms"] = spread(
            lambda a=args: W.line_sync_walk(*a))
        entry["stamped"] = stamped(lib, "line_sync_walk", W.line_sync_walk,
                                   args, max(lines, 1),
                                   (("walker", 1), ("stager", 1),
                                    ("drawer", 11)))
        print(f"  package vs plain, and timed beside the baseline: {entry}",
              flush=True)
        result["line"][kind] = entry
    for kind in ("locked", "wrap") if "chroma" in only else ():
        args, _ = C.chroma_walk_case(dev, kind)
        L, nb = args[0].shape

        def probe(mode, args=args):
            return chroma_probe(lib, args, mode)
        probe.modes = CHROMA_MODES
        print(f"chroma {kind} [{L}, {nb}]", flush=True)
        entry = {"split": split(probe, L * nb) if kind == "locked" else None}
        entry.update(versus(probe, lambda a=args: W.chroma_burst_walk(*a)))
        entry["stamped"] = stamped(lib, "chroma_burst_walk",
                                   W.chroma_burst_walk, args, L * nb,
                                   (("walker", 1), ("staging", 3)))
        print(f"  package vs baseline: {entry}", flush=True)
        result["chroma"][kind] = entry
    for kind, _, args in C.cyclic_walk_cases(dev) if "cyclic" in only \
            else ():
        n = args[0].shape[0]

        def probe(mode, args=args):
            return cyclic_probe(lib, args, mode)
        probe.modes = CYCLIC_MODES
        print(f"cyclic {kind} [{n}] sym {args[4].shape[0]}", flush=True)
        entry = {"split": split(probe, n) if kind == "dab" else None}
        entry.update(versus(probe, lambda a=args: W.cyclic_sync_walk(*a)))
        entry["stamped"] = stamped(lib, "cyclic_sync_walk",
                                   W.cyclic_sync_walk, args, n,
                                   (("average", 1), ("walker", 1),
                                    ("buffer", 1), ("stager", 1)))
        print(f"  package vs baseline: {entry}", flush=True)
        result["cyclic"][kind] = entry
    text = json.dumps(result)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(text)
    print(text)
    ok = all(e["equal"] for k in ("line", "cyclic")
             for e in result[k].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
