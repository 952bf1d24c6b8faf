"""Execution model: stateful block callables over torch tensors.

The counterpart of ``sdrpp_tpu.utils.blocks``. A block is a callable
``(state, x) -> (state, y)``; static configuration lives on ``self``,
carried state (filter tails, NCO phases, loop carries) in the tree that
``init_state()`` returns: dicts and tuples of tensors with the JAX state
tree's keys and shapes, so a JAX state read back as numpy can seed the
port (``state_from_numpy``) and the port's state can be compared with
JAX's (``state_to_numpy``). Blocks run eagerly; nothing is traced.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Block", "Chain", "scan_blocks", "state_from_numpy",
           "state_to_numpy"]

State = Any


class Block:
    """Base class for stateful DSP blocks.

    Subclasses implement ``init_state()`` returning a tree of tensors and
    ``__call__(state, x) -> (state, y)``. Stateless blocks return ``()``.
    """

    def init_state(self) -> State:
        return ()

    def __call__(self, state: State, x):  # pragma: no cover - interface
        raise NotImplementedError


class Chain(Block):
    """Linear pipeline of blocks with per-block enable/bypass
    (reference: core/src/dsp/chain.h:32-142)."""

    def __init__(self, blocks: Sequence[Block], enabled: Sequence[bool] | None = None):
        self.blocks = list(blocks)
        self.enabled = list(enabled) if enabled is not None else [True] * len(self.blocks)

    def set_enabled(self, idx: int, enabled: bool) -> None:
        self.enabled[idx] = enabled

    def init_state(self) -> State:
        return tuple(b.init_state() for b in self.blocks)

    def __call__(self, state: State, x):
        new_states = []
        for block, st, en in zip(self.blocks, state, self.enabled):
            if en:
                st, x = block(st, x)
            new_states.append(st)
        return tuple(new_states), x


def _stack(trees):
    """A list of like trees of tensors -> one tree of tensors stacked on a
    new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def scan_blocks(block: Block, state: State, xs):
    """Run ``block`` over the leading axis of ``xs``, carrying the state
    from each block to the next -> (final state, the outputs stacked on
    that axis, trees of tensors as trees); the JAX package's ``lax.scan``
    form (sdrpp_tpu/utils/blocks.py:70)."""
    ys = []
    for x in xs:
        state, y = block(state, x)
        ys.append(y)
    return state, _stack(ys)


def state_from_numpy(tree, device) -> State:
    """numpy (or array-like) leaves -> tensors on ``device``, keeping the
    dict/tuple/list structure. Dtypes are kept (complex64, float32, int32,
    bool)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def state_to_numpy(state: State):
    """Tensor leaves -> numpy arrays (on the host), same structure."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()
