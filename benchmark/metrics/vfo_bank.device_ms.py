"""VFO bank (``parallel/vfo_bank.VFOBank``): device ms of the kernels
launched inside the ``vfo_bank`` range, a traced block."""


def read(ctx):
    s = ctx.trace.layer_s("vfo_bank") if ctx.trace is not None else None
    per = ctx.per_block_s(s)
    return None if per is None else per * 1e3
