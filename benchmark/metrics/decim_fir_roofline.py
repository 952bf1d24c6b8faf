"""Kernels (``csrc/decim_fir.cu``): the decimating-FIR launches' least
bytes (each input read once, each output written once, from each
launch's shapes: the cascade's stages of decimation >= 8 in the
yardstick's plan, over [channels, n_in] complex64 rows) at the card's
peak bandwidth, as a share of their device time. Returns nothing where
the traced blocks' launches are not one for each such stage."""

from benchmark.roofline import decim_fir_bytes


def read(ctx):
    if ctx.trace is None or not ctx.trace.blocks:
        return None
    count, secs = ctx.trace.kernels("decim_fir")
    g = ctx.geometry
    n_in, least, launches = ctx.n, 0, 0
    for r, taps in ctx.ref_mod.decim_stages(g["ratio"]):
        if r >= 8:
            least += decim_fir_bytes(g["channels"], n_in, taps.shape[0], r)
            launches += 1
        n_in //= r
    if not secs or count != launches * ctx.trace.blocks:
        return None
    return 100.0 * least * ctx.trace.blocks / ctx.peak()["bytes_per_s"] \
        / secs
