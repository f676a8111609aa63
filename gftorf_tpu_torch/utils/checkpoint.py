"""Pytree checkpoints in the JAX package's npz layout, without JAX.

Port of ``gftorf_tpu/utils/checkpoint.py``. ``save_pytree`` stores the
leaves of ``jax.tree.flatten(tree)`` as ``leaf_0``, ``leaf_1``, ... plus
an optional JSON ``__meta__``. Here a tree is nested dicts, tuples
(NamedTuples included) and lists of arrays or tensors, flattened as JAX
flattens them: dict entries in sorted key order, tuple and NamedTuple
entries in order. A file written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, List, Sequence, Tuple

import numpy as np
import torch


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tree_leaves(x)
    else:
        yield tree


def tree_unflatten(like, leaves: Sequence[Any]):
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template tree holds")
    return out


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(tree_leaves(tree))}
    if meta:
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str) -> Tuple[List[np.ndarray], dict]:
    """Leaves of a saved pytree in ``jax.tree.flatten`` order, and its meta."""
    with np.load(path, allow_pickle=False) as data:
        meta = {}
        if "__meta__" in data:
            meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = []
        while f"leaf_{len(leaves)}" in data:
            leaves.append(data[f"leaf_{len(leaves)}"])
    return leaves, meta
