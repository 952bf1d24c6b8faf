"""VFO bank: its least bytes a block (the [n] complex64 input read once,
the [channels, n / ratio] complex64 IF written once) at the card's peak
bandwidth, as a share of ``vfo_bank.device_ms``. Whatever implements
the layer, the work is the same."""

from benchmark.roofline import vfo_bank_bytes


def read(ctx):
    s = ctx.trace.layer_s("vfo_bank") if ctx.trace is not None else None
    per = ctx.per_block_s(s)
    if not per:
        return None
    g = ctx.geometry
    least = vfo_bank_bytes(ctx.n, g["channels"], g["n_if"]) \
        / ctx.peak()["bytes_per_s"]
    return 100.0 * least / per
