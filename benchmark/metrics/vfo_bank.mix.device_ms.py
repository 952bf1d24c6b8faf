"""VFO bank (``ops/mix.FrequencyXlatorBank``, a first use's tables
included): device ms of the program's ``vfo.mix`` span, a traced block."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "vfo.mix")
