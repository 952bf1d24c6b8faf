"""Entry (``parallel/vfo_bank.ScannerBank.__call__``): host-clock ms
around each call of the window's untraced blocks, the mean a block: what
the host spends enqueueing a block's work."""

from benchmark.stats import mean_ms


def read(ctx):
    return mean_ms(ctx.host["call"])
