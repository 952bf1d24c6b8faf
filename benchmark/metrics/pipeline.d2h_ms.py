"""Host pipeline (``utils/pipeline.DeferredWriter.push``): device ms of
the program's ``writer.d2h`` span, a block: the audio's copy to pinned
host memory on the compute stream, in series with the bank's work."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "writer.d2h")
