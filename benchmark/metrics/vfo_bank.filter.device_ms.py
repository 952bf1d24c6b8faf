"""VFO bank (``ops/fir.FIR``, the channel filter): device ms of the
program's ``vfo.filter`` span, a traced block."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vfo.filter")
