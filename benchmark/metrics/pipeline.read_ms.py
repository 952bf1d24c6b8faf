"""Host pipeline (``utils/pipeline.Prefetcher``): host-clock ms around
each ``Prefetcher.read`` of the window's untraced blocks, the mean a
block. The read waits for the reader thread's block, copies it into a
pinned slot and enqueues the H2D copy on the side stream."""

from benchmark.stats import mean_ms


def read(ctx):
    return mean_ms(ctx.host["read"])
