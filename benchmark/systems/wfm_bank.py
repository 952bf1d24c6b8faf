"""The system under test for a broadcast-FM band: the port's
``parallel/vfo_bank.ScannerBank`` in WFM mode with de-emphasis, built as
``cli bank --mode wfm --deemphasis`` builds it, one channel on each
channel of a channel plan, and a check that it runs as the configuration
states. The functions are the ones ``systems/scanner_bank.py`` lists.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import Replay

__all__ = ["band", "source", "build", "init_state", "layers", "counters"]


def band(config: dict):
    """The channel plan: ``channels`` centres ``spacing_hz`` apart from
    ``first_hz``, as offsets from the capture's centre ``centre_hz``."""
    b = config["bank"]
    return float(b["samplerate"]), (
        float(b["first_hz"]) + float(b["spacing_hz"])
        * np.arange(int(b["channels"])) - float(b["centre_hz"]))


def source(recording: np.ndarray, config: dict):
    return Replay(recording, band(config)[0])


def build(config: dict, device, n: int):
    """ScannerBank of the configuration's ``bank`` object, on ``device``.
    Raises where ``n`` is not a whole number of the bank's blocks, or
    where the port's stages differ from what the configuration states
    (the discriminator's deviation, the audio rate, the de-emphasis)."""
    from sdrpp_tpu_torch.parallel.vfo_bank import ScannerBank

    b = config["bank"]
    fs, offsets = band(config)
    sb = ScannerBank(offsets, fs, mode="wfm", if_rate=float(b["if_rate"]),
                     bandwidth=float(b["bandwidth"]),
                     squelch_level=b.get("squelch_db"),
                     audio_rate=float(b["audio_rate"]),
                     deemphasis=b["deemphasis"],
                     channelizer=b["channelizer"], device=device)
    if n % sb.block_multiple:
        raise ValueError(f"block {n} is not a multiple of "
                         f"{sb.block_multiple}")
    if_rate = float(b["if_rate"])
    dev = if_rate / (2.0 * np.pi * sb.demod.demod.inv_deviation)
    got = {"deviation": dev, "audio_rate": sb.af.out_samplerate}
    want = {"deviation": float(b["bandwidth"]) / 2.0,
            "audio_rate": float(b["audio_rate"])}
    for k, v in got.items():
        if not np.isclose(v, want[k], rtol=1e-6):
            raise ValueError(f"the port's {k} is {v}, the configuration "
                             f"states {want[k]}")
    if sb.demod.rds_out or not sb.demod.stereo or sb.deemph is None:
        raise ValueError("the port's WFM bank is not the stereo, "
                         "de-emphasised one the configuration states")
    return sb


def init_state(sb):
    return sb.init_state()


def layers(sb) -> dict:
    out = {"vfo_bank": "vfo", "demod": "demod", "af": "af"}
    if sb.squelch is not None:
        out["squelch"] = "squelch"
    return out


def counters() -> dict:
    from sdrpp_tpu_torch.ops import fir_kernels, scans_kernels

    return {"decim_fir": fir_kernels.decimating_fir,
            "lane_scan": scans_kernels.lane_scan}
