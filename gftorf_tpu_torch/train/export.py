"""Inference-artifact loading: how a trained model arrives to be served.

Port of the loading half of ``gftorf_tpu/train/export.py``: the
``point_cloud_full.ply`` written by ``save_scene_artifacts`` (attribute
names of the reference's GaussianModel.save_ply, gaussian_model.py:315-367)
and the ``deform_model.npz`` pytree of the deform MLP.
"""

from __future__ import annotations

import numpy as np

from gftorf_tpu_torch.models.deform import DeformConfig, DeformNetwork
from gftorf_tpu_torch.utils.checkpoint import load_pytree
from gftorf_tpu_torch.utils.ply import read_ply
from gftorf_tpu_torch.weights import (
    deform_params_from_numpy,
    gaussian_params_from_numpy,
)

# jax.tree.flatten orders a dict's leaves by sorted key.
_HEADS_SORTED = tuple(sorted(("xyz", "rot", "r", "g", "b", "a")))


def load_gaussians_from_ply(path: str, sh_degree: int = 3, device=None):
    """Load a point_cloud_full.ply into GaussianParams, like
    GaussianModel.load_ply (gaussian_model.py:378-454). ``device=None``
    means the CUDA card."""
    props = read_ply(path)
    n = len(props["x"])
    m = (sh_degree + 1) ** 2
    xyz = np.stack([props["x"], props["y"], props["z"]], -1)

    sh_color = np.zeros((n, m, 3), np.float32)
    for i in range(3):
        sh_color[:, 0, i] = props[f"f_dc_{i}"]
    rest = np.stack(
        [props[f"f_rest_{i}"] for i in range(3 * (m - 1))], -1
    ).reshape(n, 3, m - 1)
    sh_color[:, 1:, :] = rest.transpose(0, 2, 1)

    def seq(prefix, count):
        return np.stack([props[f"{prefix}_{i}"] for i in range(count)], -1)

    sh_phase = np.concatenate(
        [props["phase_f_dc_0"][:, None], seq("phase_f_rest", m - 1)], -1
    )
    sh_amp = np.concatenate(
        [props["amp_f_dc_0"][:, None], seq("amp_f_rest", m - 1)], -1
    )
    n_scale = len([k for k in props if k.startswith("scale_")])
    seg = (seq("f_seg_color", 3) if "f_seg_color_0" in props
           else np.zeros((n, 3), np.float32))
    return gaussian_params_from_numpy(
        dict(
            xyz=xyz, sh_color=sh_color, sh_phase=sh_phase, sh_amp=sh_amp,
            scaling=seq("scale", n_scale), rotation=seq("rot", 4),
            opacity=props["opacity"][:, None], seg_color=seg,
            phase_offset=np.zeros((1,)), dc_offset=np.zeros((1,)),
        ),
        device=device,
    )


def load_deform_model(path: str, config: DeformConfig,
                      device=None) -> DeformNetwork:
    """Load ``deform_model.npz`` (``save_pytree`` of the JAX
    ``DeformParams``). Its leaves are in ``jax.tree.flatten`` order: the
    ``hidden_w`` tuple, then ``hidden_b``, then ``head_w`` and ``head_b``,
    each dict in sorted key order."""
    leaves, _ = load_pytree(path)
    d = config.depth
    if len(leaves) != 2 * d + 2 * len(_HEADS_SORTED):
        raise ValueError(f"{path}: {len(leaves)} leaves do not fit a deform "
                         f"MLP of depth {d}")
    heads = 2 * d
    nh = len(_HEADS_SORTED)
    head_w = dict(zip(_HEADS_SORTED, leaves[heads:heads + nh]))
    head_b = dict(zip(_HEADS_SORTED, leaves[heads + nh:]))
    return deform_params_from_numpy(leaves[:d], leaves[d:heads], head_w,
                                    head_b, config, device=device)
