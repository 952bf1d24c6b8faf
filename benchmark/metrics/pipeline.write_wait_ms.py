"""Host pipeline (``utils/pipeline.DeferredWriter``): host-clock ms
around each ``push`` of the window's untraced blocks, the mean a block. A
push enqueues this block's D2H copy and waits on the block before it,
then hands that block's audio to the sink: the time the host waits for
the card."""

from benchmark.stats import mean_ms


def read(ctx):
    return mean_ms(ctx.host["push"])
