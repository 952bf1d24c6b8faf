#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (sdrpp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's receive path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. device: a CUDA card is required; prints nvidia-smi's name and power limit;
2. build: compiles csrc/loop_scan.cu for sm_90a from this checkout;
3. kernels: ``lane_scan`` (PLL [640, 128], AGC [4230, 6]) and
   ``single_scan`` (AGC [6544], PLL [65440]) against their plain PyTorch
   versions on the card, same seeded inputs, with times from CUDA events;
4. the slice: a 2.4 Msps composite (WFM stereo at +300 kHz, AM at
   -500 kHz, USB at -700 kHz) through ``Receiver(2.4e6, block_size=654400,
   device="cuda")`` for 8 blocks; both kernels' launch counts must rise,
   outputs must be finite, each tone must land with SNR > 30 dB and the
   WFM L/R separation must exceed 20 dB;
5. card against CPU: the first two blocks again on device="cpu" (plain
   loop versions); audio RMS difference below -40 dB;
6. the normal entry point: ``cli.main(["run", ...])`` on the card writes
   48 kHz stereo WAV audio.

The last lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FS = 2.4e6
BLOCK = 654400
NBLOCKS = 8
VFOS = {"wfm": dict(mode="wfm", offset=300e3, deemphasis="50us"),
        "am": dict(mode="am", offset=-500e3),
        "usb": dict(mode="usb", offset=-700e3)}
# the USB channel's passband is [-1350, +1350] Hz around its VFO and is
# shifted up by 1350 Hz, so a 1.5 kHz audio tone sits 150 Hz above it
TONES = {"am": 1000.0, "usb": 1500.0}
SETTLE = 1000  # audio samples of the zero-state start-up transient
KERNEL_SOURCE = "sdrpp_tpu_torch/csrc/loop_scan.cu"
REPLACES = {"lane_scan": "sdrpp_tpu/ops/scans_pallas.py:147",
            "single_scan": "sdrpp_tpu/ops/scans_pallas.py:68"}
# kernel vs plain version: the same float32 operations in the same order,
# no FMA contraction (--fmad=false), IEEE division -> expected 0. The
# tolerance is 1e-6 on PLL phasors, 1e-6 of the largest gain for the AGC.
KERNEL_TOL = 1e-6


def log(*args):
    print(*args, flush=True)


def composite(n: int, seed: int = 0) -> np.ndarray:
    """The 2.4 Msps test signal: WFM stereo (L 1 kHz, R 3 kHz, 19 kHz pilot,
    75 kHz deviation) at +300 kHz, AM (1 kHz, 50 %) at -500 kHz, USB
    (1.5 kHz tone) at -700 kHz, and seeded noise."""
    t = np.arange(n) / FS
    l = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    r = 0.5 * np.sin(2 * np.pi * 3000.0 * t)
    mpx = (0.45 * (l + r) + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
           + 0.45 * (l - r) * np.sin(2 * np.pi * 38000.0 * t))
    x = 0.5 * np.exp(1j * (2 * np.pi * 300e3 * t
                           + np.cumsum(2 * np.pi * 75000.0 * mpx / FS)))
    x += 0.2 * (1 + 0.5 * np.sin(2 * np.pi * 1000.0 * t)) \
        * np.exp(-2j * np.pi * 500e3 * t)
    x += 0.05 * np.exp(2j * np.pi * (-700e3 + 150.0) * t)
    rng = np.random.default_rng(seed)
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def band_power(audio: np.ndarray, fs: float, f0: float, halfwidth: float = 20.0):
    """(power within +-halfwidth of f0, power in 100 Hz..15 kHz elsewhere)."""
    w = np.hanning(len(audio))
    p = np.abs(np.fft.rfft(audio * w)) ** 2
    f = np.fft.rfftfreq(len(audio), 1.0 / fs)
    near = np.abs(f - f0) <= halfwidth
    band = (f >= 100.0) & (f <= 15000.0)
    return p[near].sum(), p[band & ~near].sum()


def snr_db(audio, fs, f0):
    s, n = band_power(audio, fs, f0)
    return 10 * np.log10(s / max(n, 1e-30))


def rms_db(got, want):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    ref = np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)) + 1e-30
    return float(20 * np.log10(np.sqrt(np.mean(d ** 2)) / ref + 1e-30))


def cuda_ms(fn, reps: int):
    """Mean milliseconds of fn() over reps calls, from CUDA events."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev):
    """Each entry point at the slice's shapes against its plain version."""
    import torch
    from sdrpp_tpu_torch.ops import scans_kernels as K
    from sdrpp_tpu_torch.ops.mix import hz_to_rads
    from sdrpp_tpu_torch.ops.scans import _critically_damped

    rng = np.random.default_rng(1)
    alpha, beta = _critically_damped(25000.0 / 240000.0)
    pll = K.pll_body(alpha, beta, hz_to_rads(18750.0, 240000.0),
                     hz_to_rads(19250.0, 240000.0))
    w19 = hz_to_rads(19000.0, 240000.0)

    def agc(fs):
        return K.agc_body(1.0, 50.0 / fs, 5.0 / fs, 10e6, 10.0)

    def phases(n, c):
        ph = (w19 * np.arange(n)[:, None] + rng.uniform(-np.pi, np.pi, c)
              + 0.2 * rng.standard_normal((n, c)))
        return np.angle(np.exp(1j * ph)).astype(np.float32)

    def amps(n, c, level):
        return (level * np.abs(rng.standard_normal((n, c)))).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def suffix(a):
        return np.flip(np.maximum.accumulate(np.flip(a, 0), 0), 0)

    a6 = amps(4230, 6, 0.05)
    a1 = amps(6544, 1, 0.2)[:, 0]
    cases = [
        ("lane_scan", "pll", [640, 128], K.lane_scan, K.lane_scan_plain, pll,
         t(np.stack([np.zeros(128), np.full(128, w19)]).astype(np.float32)),
         [t(phases(640, 128))]),
        ("lane_scan", "agc", [4230, 6], K.lane_scan, K.lane_scan_plain,
         agc(48000.0), t(np.stack([np.full(6, 0.05), np.full(6, 20.0)])
                          .astype(np.float32)),
         [t(a6), t(suffix(a6))]),
        ("single_scan", "agc", [6544], K.single_scan, K.single_scan_plain,
         agc(24000.0), t(np.array([0.0, 1e7], np.float32)),
         [t(a1), t(suffix(a1))]),
        ("single_scan", "pll", [65440], K.single_scan, K.single_scan_plain,
         pll, t(np.array([0.0, w19], np.float32)),
         [t(phases(65440, 1)[:, 0])]),
    ]
    results = []
    for entry, body_name, shape, fn, plain, body, state, streams in cases:
        out, fin = fn(body, state, streams)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: fn(body, state, streams), reps=20)
        ref = {}

        def run_plain():
            ref["out"], ref["fin"] = plain(body, state, streams)

        plain_ms = cuda_ms(run_plain, reps=1)
        if body_name == "pll":  # wrapped phases: compare phasors
            err = max(float((torch.polar(torch.ones_like(a), a)
                             - torch.polar(torch.ones_like(b), b)).abs().max())
                      for a, b in ((out, ref["out"]), (fin, ref["fin"])))
            tol = KERNEL_TOL
        else:  # gains: absolute error, tolerance relative to the largest
            err = max(float((a - b).abs().max())
                      for a, b in ((out, ref["out"]), (fin, ref["fin"])))
            tol = KERNEL_TOL * float(ref["out"].abs().max())
        log(f"kernel {entry}[{body_name}] {shape}: max abs err {err:.3g} "
            f"(tol {tol:.3g}), kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        if not err <= tol:
            raise AssertionError(f"{entry}[{body_name}] disagrees with its "
                                 f"plain version: {err} > {tol}")
        results.append(dict(entry=entry, body=body_name, shape=shape,
                            max_abs_err=err, tol=tol, ms=ms,
                            plain_ms=plain_ms))
    return results


def make_receiver(device):
    from sdrpp_tpu_torch.receiver import Receiver

    rx = Receiver(FS, block_size=BLOCK, device=device)
    for name, cfg in VFOS.items():
        rx.create_vfo(name, **cfg)
    return rx


def phase_slice(iq):
    """The main path on the card; returns per-block audio and timings."""
    import torch
    from sdrpp_tpu_torch.ops import scans_kernels as K

    rx = make_receiver("cuda")
    audio = {name: [] for name in VFOS}
    block_ms, wall_s = [], []
    K.lane_scan.launches = 0
    K.single_scan.launches = 0
    for k in range(NBLOCKS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out, _ = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        block_ms.append(start.elapsed_time(end))
        for name, a in out.items():
            audio[name].append(a.cpu().numpy())
    launches = {"lane_scan": K.lane_scan.launches,
                "single_scan": K.single_scan.launches}
    log(f"slice launches: {launches}")
    for entry, count in launches.items():
        if count < 1:
            raise AssertionError(f"{entry} was not launched on the main path")
    for name, blocks in audio.items():
        for a in blocks:
            if not np.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite audio")
    return audio, block_ms, wall_s, launches


def check_audio(audio):
    """Tone SNRs and the WFM stereo separation, over blocks 2..8."""
    fs = 48000.0
    checks = {}
    for name, f0 in TONES.items():
        a = np.concatenate(audio[name][1:])
        checks[f"{name}_snr_db"] = snr_db(a, fs, f0)
    st = np.concatenate(audio["wfm"][1:])
    left, right = st[:, 0], st[:, 1]
    # separation at each tone's own frequency, so de-emphasis cancels
    sep_1k = 10 * np.log10(band_power(left, fs, 1000.0)[0]
                           / band_power(right, fs, 1000.0)[0])
    sep_3k = 10 * np.log10(band_power(right, fs, 3000.0)[0]
                           / band_power(left, fs, 3000.0)[0])
    mono = left + right
    s1, _ = band_power(mono, fs, 1000.0)
    s3, rest = band_power(mono, fs, 3000.0)
    checks["wfm_snr_db"] = 10 * np.log10((s1 + s3) / max(rest - s1, 1e-30))
    checks["wfm_separation_db"] = min(sep_1k, sep_3k)
    for key, value in checks.items():
        log(f"{key}: {value:.2f}")
    for name in ("am", "usb", "wfm"):
        if not checks[f"{name}_snr_db"] > 30.0:
            raise AssertionError(f"{name}: SNR {checks[f'{name}_snr_db']:.2f} dB")
    if not checks["wfm_separation_db"] > 20.0:
        raise AssertionError(f"WFM separation {checks['wfm_separation_db']:.2f} dB")
    return checks


def phase_cpu(iq, audio):
    """The first two blocks on the CPU (plain loops) against the card."""
    rx = make_receiver("cpu")
    cpu = {name: [] for name in VFOS}
    for k in range(2):
        out, _ = rx.process_block(iq[k * BLOCK:(k + 1) * BLOCK])
        for name, a in out.items():
            cpu[name].append(a.numpy())
    diffs = {}
    for name in VFOS:
        got = np.concatenate(audio[name][:2])
        want = np.concatenate(cpu[name])
        diffs[name] = {"settled_db": rms_db(got[SETTLE:], want[SETTLE:]),
                       "whole_db": rms_db(got, want)}
        log(f"card vs cpu {name}: {diffs[name]['settled_db']:.1f} dB from "
            f"audio sample {SETTLE}, {diffs[name]['whole_db']:.1f} dB whole")
        if not diffs[name]["settled_db"] < -40.0:
            raise AssertionError(f"{name}: card and CPU disagree")
    return diffs


def phase_cli():
    from sdrpp_tpu.io.wav import read_wav
    from sdrpp_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "wfm.wav"
        rc = cli.main(["run", "--source", "test:2400000", "--mode", "wfm",
                       "--blocks", "4", "--device", "cuda", "--out", str(out)])
        if rc:
            raise AssertionError(f"cli run returned {rc}")
        info, data = read_wav(out)
    log(f"cli run: {data.shape[0]} frames, {info.channels} channels at "
        f"{info.samplerate} Hz")
    if info.samplerate != 48000 or info.channels != 2 or data.shape[0] == 0:
        raise AssertionError("cli run did not write 48 kHz stereo audio")
    return {"frames": int(data.shape[0])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sdrpp_tpu_torch.utils import cuda_lib

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = cuda_lib.build("loop_scan")
    build_s = time.perf_counter() - t0
    log(f"build: {lib.name} in {build_s:.2f} s")
    log(lib.with_suffix(".log").read_text().strip())

    dev = torch.device("cuda")
    kernels = phase_kernels(dev)

    iq = composite(NBLOCKS * BLOCK)
    audio, block_ms, wall_s, launches = phase_slice(iq)
    med_ms = float(np.median(block_ms[1:]))
    med_wall = float(np.median(wall_s[1:]))
    msps = BLOCK / (med_ms / 1e3) / 1e6
    log(f"slice: median {med_ms / 1e3:.4f} s/block (CUDA events; host "
        f"{med_wall:.4f} s) over blocks 2..{NBLOCKS}, {msps:.2f} Msamp/s "
        f"input = {msps / (FS / 1e6):.2f}x the 2.4 Msps real-time rate")
    checks = check_audio(audio)
    cpu = phase_cpu(iq, audio)
    cli_res = phase_cli()

    rows = []
    for entry in ("lane_scan", "single_scan"):
        mine = [k for k in kernels if k["entry"] == entry]
        on_path = [k for k in mine if k["shape"] != [65440]]
        rows.append({
            "name": entry, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[entry], "launches": launches[entry],
            "max_abs_err": max(k["max_abs_err"] for k in mine),
            "ms": sum(k["ms"] for k in on_path),
            "plain_ms": sum(k["plain_ms"] for k in on_path),
            "cases": mine})
    log(json.dumps({"slice": {"block_ms": block_ms, "wall_s": wall_s,
                              "launches": launches, **checks},
                    "card_vs_cpu": cpu, "cli": cli_res}))
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
