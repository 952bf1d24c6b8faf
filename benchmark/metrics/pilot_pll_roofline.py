"""Kernels (``csrc/loop_scan.cu`` ``lane_scan``, WFM's pilot loop): the
loop's least bytes a block (the input phases read and the loop's phases
written, [channels, n_if] float32 each, the two carries read and
written), the same work whatever implements the loop, at the card's
peak bandwidth, as a share of the device time of the loop-scan launches
inside the ``demod`` range. Returns nothing where the traced blocks'
demod launched other than one loop scan a block."""

from benchmark.roofline import lane_scan_bytes


def read(ctx):
    if ctx.trace is None or not ctx.trace.blocks:
        return None
    count, secs = ctx.trace.kernels("loop_scan_kernel", layer="demod")
    if not secs or count != ctx.trace.blocks:
        return None
    g = ctx.geometry
    least = lane_scan_bytes(g["channels"], g["n_if"], streams=1, carries=2)
    return 100.0 * least * count / ctx.peak()["bytes_per_s"] / secs
