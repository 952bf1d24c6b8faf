"""The system under test for a scanner-bank configuration: the port's
``parallel/vfo_bank.ScannerBank`` built as ``cli bank`` builds it, and a
check that it runs as the configuration states.

A system module gives the harness (``harness.run_cell``) what it drives:

- ``band(config)``: (sample rate, channel centres in Hz), where the
  traffic generator places its signals;
- ``source(recording, config)``: what the program's ``Prefetcher``
  reads, an object with ``samplerate`` and ``read(n)``;
- ``build(config, device, n)``: the entry, called as ``entry(state, x)
  -> (state, y)`` on each block ``x`` of ``n`` samples;
- ``init_state(entry)``: the entry's first state;
- ``layers(entry)``: {range name: attribute} of the members whose calls
  the traced run wraps in a profiler range;
- ``counters()``: {name: object with ``launches``} of the kernel
  wrappers whose launches a block the run prints.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import Replay

__all__ = ["band", "source", "build", "init_state", "layers", "counters"]


def band(config: dict):
    """The channel plan: ``channels`` centres evenly over ``span`` of the
    band (bench.py's linspace(-0.4, 0.4) x fs for a span of 0.8)."""
    bank = config["bank"]
    fs = float(bank["samplerate"])
    return fs, np.linspace(-bank["span"] / 2, bank["span"] / 2,
                           bank["channels"]) * fs


def source(recording: np.ndarray, config: dict):
    return Replay(recording, band(config)[0])


def build(config: dict, device, n: int):
    """ScannerBank of the configuration's ``bank`` object, on ``device``.
    Raises where ``n`` is not a whole number of the bank's blocks, or
    where the port's defaults differ from what the configuration states
    (the demod's AGC)."""
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank

    bank = config["bank"]
    fs, offsets = band(config)
    sb = ScannerBank(offsets, fs, mode=bank["mode"],
                     if_rate=float(bank["if_rate"]),
                     bandwidth=float(bank["bandwidth"]),
                     squelch_level=bank.get("squelch_db"),
                     channelizer=bank["channelizer"], device=device)
    if n % sb.block_multiple:
        raise ValueError(f"block {n} is not a multiple of "
                         f"{sb.block_multiple}")
    if "agc" in bank:
        agc, want = sb.demod.agc, bank["agc"]
        fs_if = float(bank["if_rate"])
        got = {"attack": float(agc.attack) * fs_if,
               "decay": float(agc.decay) * fs_if,
               "max_gain": float(agc.max_gain),
               "max_output_amp": float(agc.max_output_amp)}
        for k, v in got.items():
            if not np.isclose(v, want[k], rtol=1e-6):
                raise ValueError(f"the port's AGC {k} is {v}, the "
                                 f"configuration states {want[k]}")
        if not agc.enabled:
            raise ValueError("the port's AGC is off; the configuration "
                             "states it on")
    return sb


def init_state(sb):
    return sb.init_state()


def layers(sb) -> dict:
    out = {"vfo_bank": "vfo", "demod": "demod"}
    if sb.squelch is not None:
        out["squelch"] = "squelch"
    return out


def counters() -> dict:
    from sdrpp_tpu_torch.ops import fir_kernels, scans_kernels

    return {"decim_fir": fir_kernels.decimating_fir,
            "lane_scan": scans_kernels.lane_scan}
