"""VFO bank (``ops/resample.RationalResampler``: the power-of-2 cascade,
B3 at r >= 8, and the polyphase stage): device ms of the program's
``vfo.resample`` span, a traced block."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vfo.resample")
