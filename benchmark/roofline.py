"""The yardstick's peaks and the least bytes of each kernel and layer.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense, at
its 700 W limit; a card set below it runs slower, so a run prints the
card's limit beside its shares. Bytes count each input read once and
each output written once, whatever a kernel reads again.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak", "decim_fir_bytes", "lane_scan_bytes",
           "vfo_bank_bytes"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12},
}

C64, F32 = 8, 4


def peak(kind: str) -> dict:
    """The card's peaks; an H100 by another name takes the H100 SXM's."""
    if kind in PEAKS:
        return PEAKS[kind]
    if "H100" in kind:
        return PEAKS["NVIDIA H100 80GB HBM3"]
    raise KeyError(f"no peaks for {kind!r}")


def decim_fir_bytes(rows: int, n_in: int, taps: int, r: int,
                    sample: int = C64) -> int:
    """One decimating-FIR launch: x [rows, n_in] and the tail [rows, m-1]
    read, y [rows, n_in / r] and the new tail written, the taps read."""
    return (sample * rows * (n_in + 2 * (taps - 1) + n_in // r)
            + F32 * taps)


def lane_scan_bytes(lanes: int, steps: int, streams: int, carries: int
                    ) -> int:
    """One loop-scan launch: ``streams`` float32 inputs and one float32
    output per lane and step, the carries read and written."""
    return F32 * lanes * (steps * (streams + 1) + 2 * carries)


def vfo_bank_bytes(n: int, channels: int, n_if: int) -> int:
    """The VFO bank's least bytes a block: the [n] complex64 input read
    once, the [channels, n_if] complex64 IF written once."""
    return C64 * (n + channels * n_if)
