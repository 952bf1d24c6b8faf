"""Demod (``models/analog.WFMDemod``): device ms of the program's
``wfm.pilot`` span, a traced block: the 19-kHz pilot's band-pass and the
pilot loop."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "wfm.pilot")
