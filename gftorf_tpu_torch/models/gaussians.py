"""Gaussian scene parameters and their activations.

Port of the serving half of ``gftorf_tpu/models/gaussians.py`` (the
reference's GaussianModel activations, scene/gaussian_model.py:28-43,
147-161). Densification and Adam come with the training slice.

SH layout: color coefficients are (C, M, 3); phase/amp are (C, M) each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianParams(NamedTuple):
    """Scene parameters, capacity-C leading dim except the offsets."""

    xyz: torch.Tensor  # (C, 3)
    sh_color: torch.Tensor  # (C, M, 3) DC at index 0
    sh_phase: torch.Tensor  # (C, M)
    sh_amp: torch.Tensor  # (C, M)
    scaling: torch.Tensor  # (C, S) log-scale; S=1 isotropic else 3
    rotation: torch.Tensor  # (C, 4) unnormalized quats
    opacity: torch.Tensor  # (C, 1) logit
    seg_color: torch.Tensor  # (C, 3) frozen motion-segmentation color
    phase_offset: torch.Tensor  # (1,)
    dc_offset: torch.Tensor  # (1,)


def get_scaling(params: GaussianParams) -> torch.Tensor:
    s = torch.exp(params.scaling)
    if s.shape[-1] == 1:
        s = s.expand(*s.shape[:-1], 3)
    return s


def get_rotation(params: GaussianParams) -> torch.Tensor:
    # rsqrt(sum + eps): zero-quaternion rows (dead capacity slots) stay
    # finite through the normalization.
    q = params.rotation
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-20)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_motion_mask(params: GaussianParams) -> torch.Tensor:
    """Red-channel threshold on frozen seg colors (gaussian_model.py:159-161)."""
    return params.seg_color[:, 0] > 0.5


def get_features_phasor(params: GaussianParams) -> torch.Tensor:
    """(C, M, 2) packed (phase, amp) like get_features_phasor (:147-153)."""
    return torch.stack([params.sh_phase, params.sh_amp], dim=-1)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))
