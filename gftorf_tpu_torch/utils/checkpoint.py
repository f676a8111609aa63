"""Read the JAX package's npz pytree files with numpy only.

Port of ``gftorf_tpu/utils/checkpoint.py::load_pytree``. ``save_pytree``
stores the leaves of ``jax.tree.flatten(tree)`` as ``leaf_0``,
``leaf_1``, ... plus an optional JSON ``__meta__``; without JAX the
caller knows the tree's structure, so this returns the leaves in their
flatten order and the meta dict.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np


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
