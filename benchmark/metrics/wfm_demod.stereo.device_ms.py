"""Demod (``models/analog.WFMDemod``): device ms of the program's
``wfm.stereo`` span, a traced block: the L+R and L-R delays, the 38-kHz
product, the L/R matrix and the two 15-kHz audio low-passes."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx, "wfm.stereo")
