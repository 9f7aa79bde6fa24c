"""Checkpoint / resume for op and chain state (port of
``tpudsp/io/checkpoint.py``; SURVEY.md section 5).

The reference cannot serialize a chain mid-stream (liquid state is opaque;
closest affordance is warm-starting the AGC gain, agc.hpp:49-51). Here
every op / chain state is an explicit tree, so checkpointing is a plain
save / load of arrays -- state is KBs, making per-block snapshots and
recovery cheap.

The tree is walked by the port's own rule, that of ``kernels.lanes.
tree_map``: NamedTuples, tuples and dicts (keys in sorted order) are
nodes, None is a node with no leaf, anything else is a leaf. The snapshot
records the structure as a string under that rule. Tensor leaves are
saved through ``.cpu()``; the port's uint32 states (int64 tensors masked
to 32 bits) round-trip as int64.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.base import to_numpy


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in walk order; return its
    structure."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}(" + ", ".join(
                f"{f}={_flatten(v, leaves)}" for f, v in zip(tree._fields, tree)) + ")"
        return "(" + ", ".join(_flatten(v, leaves) for v in tree) + ",)"
    leaves.append(tree)
    return "*"


def _unflatten(like, saved):
    """``like``'s tree with its leaves taken in walk order from the iterator
    ``saved``, each as what ``like``'s leaf is: a tensor on that leaf's
    device, a Python scalar of its type, or a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], saved) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, tuple):
        vals = [_unflatten(v, saved) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    leaf = next(saved)
    if torch.is_tensor(like):
        return torch.from_numpy(leaf).to(like.device)
    if isinstance(like, (bool, int, float, complex)):
        return type(like)(leaf.item())
    return leaf


def save_state(path: str, state) -> None:
    """Save any state tree (op.state, chain state, dict of them) to .npz."""
    leaves: list = []
    structure = _flatten(state, leaves)
    np.savez(path, __treedef__=np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8),
             **{f"leaf_{i}": to_numpy(leaf) for i, leaf in enumerate(leaves)})


def load_state(path: str, like):
    """Load a state tree saved by save_state; ``like`` provides the tree
    structure (e.g. the op's current state). The snapshot's own recorded
    structure and per-leaf shapes are validated against ``like`` -- a stale
    or mismatched snapshot raises instead of silently mis-assigning
    compatible-shaped leaves. Returns the restored tree."""
    with np.load(path, allow_pickle=False) as data:
        # copies: an npz member reads back read-only
        leaves = [np.array(data[f"leaf_{i}"]) for i in range(len(data.files) - 1)]
        saved_structure = json.loads(bytes(data["__treedef__"]).decode())
    like_leaves: list = []
    structure = _flatten(like, like_leaves)
    if saved_structure != structure:
        raise ValueError(
            f"checkpoint {path!r} holds a different state structure:\n"
            f"  saved:    {saved_structure}\n  expected: {structure}")
    if len(leaves) != len(like_leaves):
        raise ValueError(f"checkpoint {path!r} has {len(leaves)} leaves, "
                         f"expected {len(like_leaves)}")
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(f"checkpoint {path!r} leaf {i} has shape {tuple(got.shape)}, "
                             f"expected {tuple(np.shape(want))}")
    return _unflatten(like, iter(leaves))
