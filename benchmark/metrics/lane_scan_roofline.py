"""Kernels (``csrc/loop_scan.cu`` ``lane_scan``, the SSB demod's AGC):
the launch's least bytes (the amplitude and look-ahead streams read, the
gains written, [channels, n / ratio] float32 each, the two carries read
and written) at the card's peak bandwidth, as a share of its device
time. Returns nothing where the traced blocks' demod launched other than
one loop scan a block."""

from benchmark.roofline import lane_scan_bytes


def read(ctx):
    if ctx.trace is None or not ctx.trace.blocks:
        return None
    count, secs = ctx.trace.kernels("loop_scan_kernel", layer="demod")
    if not secs or count != ctx.trace.blocks:
        return None
    g = ctx.geometry
    least = lane_scan_bytes(g["channels"], g["n_if"], streams=2, carries=2)
    return 100.0 * least * count / ctx.peak()["bytes_per_s"] / secs
