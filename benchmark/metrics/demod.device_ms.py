"""Demod (``models/analog.NFMDemod``, ``SSBDemod``): device ms of the
kernels launched inside the ``demod`` range, a traced block."""


def read(ctx):
    s = ctx.trace.layer_s("demod") if ctx.trace is not None else None
    per = ctx.per_block_s(s)
    return None if per is None else per * 1e3
