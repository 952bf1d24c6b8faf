"""AF chain (``parallel/vfo_bank.ScannerBank``'s WFM AF stage): device
ms of the program's ``bank.af`` span, a traced block: the stereo pair's
resampler to the audio rate and, where the bank has it, the
de-emphasis."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "bank.af")
