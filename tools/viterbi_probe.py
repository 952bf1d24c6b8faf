"""Where the general Viterbi kernels spend their time, the floors of the
ACS's chain, and the package's kernels against the ones they replaced.

    python3 tools/viterbi_probe.py [--out viterbi_probe.json] [--steps T]
                                   [--only acs|traceback]

Builds tools/viterbi_probe.cu (which includes the package's
csrc/viterbi.cu; see its header) and the package's csrc/viterbi.cu.

The ACS section (``--only acs``): an instrumented copy of the one-step-a-
barrier ``acs_cta_kernel`` that csrc/viterbi.cu had before its radix-4
redesign (the "baseline") and the chain floors, for S = 128, 256, 512 and
1024 states, uint8 soft bits at R = 2 (a K = 8 ... 11 code's seeded noisy
stream, ``chip_smoke.viterbi_stream``), T steps:

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

The traceback section (``--only traceback``): the one-lane
``traceback_wide_kernel`` the package ran for S > 64 before its
segment-parallel walk (the baseline) against the package's
``viterbi_traceback_batched``, on the words of the package's ACS over
fec-k9's stream ([1, 2097162] at S = 256, ``chip_smoke.fec_path_soft``),
over [64, 4288] windows of noisy K = 8 and K = 9 streams (S = 128 and
256) and, at fec-k9's shape, the rotation words (state s takes s & 1: no
two walks ever merge):

1. baseline and package in turns (baseline, package, package, baseline),
   bits equal (``equal``);
2. the package's phases at its own segment length L, each timed alone
   with CUDA events: the maps (clock64 cycles a segment, and a walk step
   of a thread), the chain (clock64 cycles a window, and a link) and the
   bits;
3. at fec-k9, the sweep L = 256 ... 4096: the maps with and without the
   merge shortcut (the probe's variant: a CTA stops once its walkers
   merge), the chain with its rows from a shared-memory ring (the
   package's) and from global memory, the bits, and the three phases
   together.

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
    lib.tb_baseline.argtypes = [p, p, i, i, i, p, p]
    lib.tb_phase.argtypes = [i, p, p, i, i, i, i, p, p, p]
    lib.tb_baseline.restype = lib.tb_phase.restype = ctypes.c_int
    lib.tb_scratch.argtypes = [i, i, i, i]
    lib.tb_scratch.restype = ctypes.c_longlong
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


TB_PHASES = {"maps": 1, "chain": 2, "bits": 3, "maps_merge": 4,
             "chain_l2": 5, "all": 0}
TB_SWEEP = (256, 512, 1024, 2048, 4096)


def tb_words(kind: str, T_k9: int = 0):
    """(label, words [B, T, S / 64] int64 on the card, S): the package's ACS
    over fec-k9's stream ("k9"), [64, 4288] windows of a noisy K = 8 or 9
    stream ("w128", "w256"), or fec-k9's shape with the rotation words
    ("rotation": bit s & 31 of each 32-bit word equal to s & 1)."""
    if kind == "k9":
        _, soft, polys = C.fec_path_soft(9)
        code = F.ConvCode(2, 9, polys, device="cuda")
        start = torch.zeros(1, dtype=torch.int32, device="cuda")
        words = FK.viterbi_acs_batched(torch.from_numpy(soft).cuda(), start,
                                       soft.shape[0], code._expected)
        return "fec-k9", words, 256
    if kind == "rotation":  # 0xAAAA...: bit n is n & 1
        w = torch.full((1, T_k9, 4), -0x5555555555555556, dtype=torch.int64,
                       device="cuda")
        return f"rotation [1, {T_k9}]", w, 256
    order = {"w128": 8, "w256": 9}[kind]
    code = F.ConvCode(2, order, C.fec_polys(2, order), device="cuda")
    rng = np.random.default_rng(70 + order)
    total = C.FEC_WINDOWS * C.VIT_L - 1000
    soft = torch.from_numpy(C.viterbi_stream(rng, code, total)).cuda()
    starts = torch.from_numpy(C.viterbi_starts(total)).cuda()
    words = FK.viterbi_acs_batched(soft, starts, C.VIT_T, code._expected)
    S = code.num_states
    return f"windows [64, 4288] S={S}", words, S


def tb_run(lib, phase, words, bits, S, L, scratch, cyc):
    rc = lib.tb_phase(phase, words.data_ptr(), bits.data_ptr(),
                      words.shape[0], words.shape[1], S, L,
                      scratch.data_ptr(), 0 if cyc is None else cyc.data_ptr(),
                      stream())
    assert rc == 0, rc


def tb_scratch(lib, B, T, S, L):
    return torch.empty(lib.tb_scratch(B, T, S, L), dtype=torch.uint8,
                       device="cuda")


def tb_phases(lib, words, S, L, ref) -> dict:
    """Each phase of the package's walk at segment length L, timed alone:
    {phase: {"ms", and clock64 figures}}; "equal": the three phases' bits
    equal ``ref``."""
    B, T = words.shape[:2]
    nseg = -(-T // L)
    bits = torch.empty((B, T), dtype=torch.uint8, device="cuda")
    scratch = tb_scratch(lib, B, T, S, L)
    seg_cyc = torch.zeros(B * nseg, dtype=torch.int64, device="cuda")
    win_cyc = torch.zeros(B, dtype=torch.int64, device="cuda")
    out = {}
    for name in ("maps", "maps_merge", "chain", "chain_l2", "bits", "all"):
        ph = TB_PHASES[name]
        cyc = seg_cyc if ph in (1, 4) else win_cyc if ph in (0, 2, 5) else None
        if name == "chain_l2" or name == "chain":
            tb_run(lib, 1, words, bits, S, L, scratch, None)  # fresh maps
        ms = timed(lambda: tb_run(lib, ph, words, bits, S, L, scratch, None))
        tb_run(lib, ph, words, bits, S, L, scratch, cyc)
        torch.cuda.synchronize()
        e = {"ms": ms}
        if ph in (1, 4):
            c = seg_cyc.double()
            e.update(cycles_per_segment=float(c.mean()),
                     cycles_per_segment_max=float(c.max()),
                     cycles_per_thread_step=float(c.mean()) / L
                     / min(16, S // 128))
        elif ph in (0, 2, 5):
            c = float(win_cyc.double().mean())
            e.update(chain_cycles_per_window=c, cycles_per_link=c / nseg)
        out[name] = e
        if name == "maps_merge":  # the maps again, complete, for the rest
            tb_run(lib, 1, words, bits, S, L, scratch, None)
    out["equal"] = bool(torch.equal(bits, ref))
    return out


def probe_traceback(lib) -> dict:
    res = {"cases": []}
    T_k9 = 0
    for kind in ("k9", "w128", "w256", "rotation"):
        label, words, S = tb_words(kind, T_k9)
        T_k9 = T_k9 or words.shape[1]
        B, T = words.shape[:2]
        L = FK.wide_segment_steps(T)
        base_bits = torch.empty((B, T), dtype=torch.uint8, device="cuda")

        def base():
            rc = lib.tb_baseline(words.data_ptr(), base_bits.data_ptr(), B,
                                 T, S, 0, stream())
            assert rc == 0, rc

        base()
        pkg_bits = FK.viterbi_traceback_batched(words, num_states=S)
        torch.cuda.synchronize()
        equal = bool(torch.equal(base_bits, pkg_bits))
        times = {"baseline": [], "package": []}
        for who in ("baseline", "package", "package", "baseline"):
            fn = base if who == "baseline" else (
                lambda: FK.viterbi_traceback_batched(words, num_states=S))
            times[who].append(timed(fn))
        case = {"case": label, "shape": [B, T], "states": S,
                "segment_steps": L, "equal": equal,
                "baseline_ms": times["baseline"],
                "package_ms": times["package"],
                "phases": tb_phases(lib, words, S, L, base_bits)}
        print(f"  traceback {label}: L={L}, equal {equal}, {times}, "
              f"phases {case['phases']}", flush=True)
        if kind == "k9":
            sweep = {}
            for Ls in TB_SWEEP:
                sweep[Ls] = tb_phases(lib, words, S, Ls, base_bits)
                print(f"  traceback sweep L={Ls}: {sweep[Ls]}", flush=True)
            case["sweep"] = sweep
        res["cases"].append(case)
        del words
        torch.cuda.empty_cache()
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
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None
    result = {"device": gpu, "states": {}}
    if only in (None, "acs"):
        for S in (128, 256, 512, 1024):
            result["states"][S] = probe_states(lib, S, T, split=S <= 256)
    if only in (None, "traceback"):
        result["traceback"] = probe_traceback(lib)
    text = json.dumps(result)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(text)
    print(text)
    ok = all(e.get("equal", True) for e in result["states"].values()) and \
        all(c["equal"] and c["phases"]["equal"]
            and all(v["equal"] for v in c.get("sweep", {}).values())
            for c in result.get("traceback", {}).get("cases", []))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
