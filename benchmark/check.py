"""The output check that decides ``correct``, and the context the
per-layer readers read.

``compare`` runs the configuration's plain reference (its module's
``Reference``) over every block the sink kept (a sample of the window's
blocks drawn from the seed) and returns each number compared with its
limit: those of the reference module's ``compare``, and ``none_checked``,
1 where no block was kept (a window in which no block's output arrived;
limit 0).
"""

from __future__ import annotations

__all__ = ["compare", "Context"]


def compare(cell, ref_mod, pool, kept: dict, n: int, device):
    """(numbers, failing blocks): the numbers compared for the kept
    blocks, each {"value", "limit"}, and how many kept blocks fail one."""
    want = ref_mod.Reference(cell.config, n, device=device).run(
        pool, sorted(kept))
    numbers, failing = ref_mod.compare(cell.config, kept, want)
    numbers["none_checked"] = {"value": int(not kept), "limit": 0}
    return numbers, failing


class Context:
    """What a per-layer reader reads: the cell, the block size ``n``, the
    card, the parsed trace (None when the run was not traced or the
    profiler saw no device), ``host``, the host-clock seconds of each
    ``Prefetcher.read`` (``read``), entry call (``call``) and
    ``DeferredWriter.push`` (``push``) over the blocks of the window that
    ran untraced, the configuration's plain reference module
    (``ref_mod``) and its ``geometry`` at ``n``."""

    def __init__(self, cell, n, card, trace, host, ref_mod):
        self.cell = cell
        self.n = n
        self.card = card
        self.trace = trace
        self.host = host
        self.ref_mod = ref_mod
        self.geometry = ref_mod.geometry(cell.config, n)

    def per_block_s(self, seconds):
        """Device seconds over the traced blocks, a block; None without a
        trace or traced blocks."""
        if seconds is None or self.trace is None or not self.trace.blocks:
            return None
        return seconds / self.trace.blocks

    def peak(self):
        from benchmark.roofline import peak
        return peak(self.card["kind"])
