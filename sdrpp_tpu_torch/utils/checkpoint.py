"""DSP-state checkpoint/resume.

The counterpart of ``sdrpp_tpu.utils.checkpoint``, writing and reading the
same file format: a flat .npz keyed by the state tree's paths (dict keys,
and tuple/list indices as digits, joined by ``/``), plus the source stream
offset under ``__stream_offset__`` and caller metadata under
``__meta_<name>__``. The JAX package flattens with
``jax.tree_util.tree_flatten_with_path``: dict keys in sorted order,
sequences in order, ``None`` and empty containers holding no leaf. This
module walks the dict/tuple tree the same way, so a checkpoint of one
chain written by either package loads in the other (the state trees share
keys, shapes and dtypes; tests/test_torch_run_options.py).

``load_state`` checks the saved key set, and every leaf's shape and dtype,
against a template from ``init_state()`` of the same graph, and puts each
leaf on the template leaf's device.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_state", "load_state"]

_SEP = "/"


def _leaves(state, prefix=()):
    """Yield (path tuple, leaf) in the order of JAX's tree flattening."""
    if state is None:
        return
    if isinstance(state, dict):
        for k in sorted(state):
            yield from _leaves(state[k], prefix + (str(k),))
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, state


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _leaves(state)}


def save_state(path, state, stream_offset: int = 0,
               metadata: dict | None = None):
    """Save a state tree + source stream offset to ``path`` (.npz).

    Device leaves are read back to the host (one copy each)."""
    flat = _flatten(state)
    flat["__stream_offset__"] = np.int64(stream_offset)
    for k, v in (metadata or {}).items():
        flat[f"__meta_{k}__"] = np.asarray(v)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # a temp .npz then a rename: np.savez appends ".npz" to a name without
    # it, and the replace is atomic, so a crash mid-save never corrupts
    # the previous checkpoint
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


def _rebuild(template, prefix, data):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, prefix + (str(k),), data)
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, prefix + (str(i),), data)
                              for i, v in enumerate(template))
    key = _SEP.join(prefix)
    arr = data[key]
    want = _to_numpy(template)
    if arr.shape != want.shape or arr.dtype != want.dtype:
        raise ValueError(f"leaf {key}: saved {arr.shape}/{arr.dtype} vs "
                         f"graph {want.shape}/{want.dtype}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(template.device)
    return arr


def load_state(path, template):
    """Load into the structure of ``template`` -> (state, stream_offset).

    ``template`` is a freshly initialized state tree of the SAME graph;
    its leaves are replaced by the saved arrays (key set, shape and dtype
    checked; a mismatch raises ValueError), each on its template leaf's
    device.
    """
    data = dict(np.load(path, allow_pickle=False))
    offset = int(data.pop("__stream_offset__", 0))
    for k in list(data):
        if k.startswith("__meta_"):
            data.pop(k)
    keys = {_SEP.join(p) for p, _ in _leaves(template)}
    missing = keys - set(data)
    extra = set(data) - keys
    if missing or extra:
        raise ValueError(f"checkpoint/graph mismatch: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    return _rebuild(template, (), data), offset
