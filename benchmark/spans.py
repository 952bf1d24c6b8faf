"""Reading the program's own spans (``sdrpp_tpu_torch.utils.tracing``):
the device ms of one span name, a block, over the records the program
kept while the traced run's profiler ran.

A span records only under a profiler, so the records are the traced
blocks' alone. Each record's ``device_ms`` is the time between the
span's two CUDA events on its stream; its ``block`` is the number of
the block it ran in.
"""

from __future__ import annotations

__all__ = ["device_ms", "program_spans"]


def program_spans():
    """The program's span records, or None where the program keeps none
    (a version without ``tracing.spans``)."""
    try:
        from sdrpp_tpu_torch.utils.tracing import spans
    except ImportError:
        return None
    return spans()


def device_ms(ctx, name: str, records=None):
    """Mean device ms a block of the spans named ``name`` (their device
    ms summed, over the distinct blocks they ran in); None without a
    trace, on the CPU, or where no record of that name has device time.
    ``records`` defaults to the program's."""
    if ctx.trace is None or ctx.card.get("platform") != "gpu":
        return None
    if records is None:
        records = program_spans()
    mine = [r for r in records or ()
            if r["name"] == name and r["device_ms"] is not None]
    if not mine:
        return None
    return sum(r["device_ms"] for r in mine) / len({r["block"] for r in mine})
