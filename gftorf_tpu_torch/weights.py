"""Carry parameters across from the JAX package.

The JAX package's ``GaussianParams`` and ``DeformParams``, given as numpy
arrays (``np.asarray`` of each leaf), become the port's. The tests use
this to feed both packages the same state; a user can use it to serve a
model that lives in memory in the JAX package's layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from gftorf_tpu_torch.models.deform import HEADS, DeformConfig, DeformNetwork
from gftorf_tpu_torch.models.gaussians import GaussianParams
from gftorf_tpu_torch.utils.runtime import resolve_device


def gaussian_params_from_numpy(arrays: Mapping[str, np.ndarray],
                               device=None) -> GaussianParams:
    """GaussianParams from a dict of its fields' arrays (float32).
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return GaussianParams(**{
        name: torch.as_tensor(np.asarray(arrays[name], np.float32), device=dev)
        for name in GaussianParams._fields
    })


def deform_params_from_numpy(hidden_w: Sequence[np.ndarray],
                             hidden_b: Sequence[np.ndarray],
                             head_w: Dict[str, np.ndarray],
                             head_b: Dict[str, np.ndarray],
                             config: DeformConfig,
                             device=None) -> DeformNetwork:
    """DeformNetwork from the JAX ``DeformParams`` leaves: hidden weights
    (in, W) and biases per layer, head weights (W, out) and biases by head
    name. ``config`` gives the embedding widths the arrays cannot tell."""
    dev = resolve_device(device)
    net = DeformNetwork(config)
    if len(hidden_w) != config.depth or len(hidden_b) != config.depth:
        raise ValueError(f"{len(hidden_w)} hidden layers given, config has "
                         f"depth {config.depth}")

    def put(layer, w, b):
        w = torch.as_tensor(np.asarray(w, np.float32)).T
        b = torch.as_tensor(np.asarray(b, np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not fit {layer}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)

    with torch.no_grad():
        for layer, w, b in zip(net.hidden, hidden_w, hidden_b):
            put(layer, w, b)
        for name in HEADS:
            put(net.heads[name], head_w[name], head_b[name])
    return net.to(dev)
