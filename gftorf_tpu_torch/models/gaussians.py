"""Gaussian scene state: parameters, activations, Adam and densify stats.

Port of ``gftorf_tpu/models/gaussians.py``: the fixed-capacity state
(``GaussianParams``, ``GaussianAux``, ``AdamState``,
``GaussianModelState``), the reference's GaussianModel activations
(scene/gaussian_model.py:28-43, 147-161), ``adam_update`` and
``add_densification_stats``. Every function here returns new tensors and
leaves its inputs as they were, like the JAX package: the training step
is pure, so a caller can keep the pre-step state to roll back. The
densify/prune/grow/sort events come with the Trainer.

SH layout: color coefficients are (C, M, 3); phase/amp are (C, M) each.
Per-coefficient learning rates (DC vs rest/20, gaussian_model.py:247-274)
are tensors broadcast against the parameter, so one Adam serves every
group; this is why ``torch.optim.Adam`` (one lr per group, in-place
updates) does not serve.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

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


class GaussianAux(NamedTuple):
    """Non-optimized per-point state."""

    alive: torch.Tensor  # (C,) bool
    max_radii2d: torch.Tensor  # (C,) float
    xyz_grad_accum: torch.Tensor  # (C,) float
    denom: torch.Tensor  # (C,) float


class AdamState(NamedTuple):
    """Adam moments shaped like the parameters (a GaussianParams, or the
    deform MLP's name -> tensor dict) and the shared step counter."""

    mu: Any
    nu: Any
    step: torch.Tensor  # () int32


class GaussianModelState(NamedTuple):
    params: GaussianParams
    aux: GaussianAux
    adam: AdamState


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a NamedTuple or dict of tensors (and the
    matching leaves of ``rest``), keeping the container type."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return type(tree)(*(fn(*leaves) for leaves in zip(tree, *rest)))


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


# ---------------------------------------------------------------------------
# Adam (torch.optim.Adam semantics, eps=1e-15, gaussian_model.py:274)


def adam_update(params, grads, adam: AdamState, lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15, on=None):
    """One Adam step with per-leaf learning rates (floats or tensors that
    broadcast against the leaf). Returns (new_params, new AdamState).

    ``on`` (a host value): when it is not > 0 the step is skipped
    entirely: params, moments and the step counter pass through unchanged,
    matching the reference's conditional ``optimizer.step()``
    (train.py:469-472). An lr of 0 would not be the same: it still decays
    the gradients into mu/nu and advances the shared bias correction.
    """
    if on is not None and not on > 0:
        return params, AdamState(mu=adam.mu, nu=adam.nu, step=adam.step)
    step = adam.step + 1
    step_f = step.to(torch.float32)
    bc1 = 1.0 - b1 ** step_f
    bc2 = 1.0 - b2 ** step_f
    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, adam.mu, grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, adam.nu, grads)
    new_p = tree_map(
        lambda p, m, v, lr: p - lr / bc1 * m / (torch.sqrt(v) / torch.sqrt(bc2) + eps),
        params, new_m, new_v, lrs,
    )
    return new_p, AdamState(mu=new_m, nu=new_v, step=step)


# ---------------------------------------------------------------------------
# Densification statistics


def add_densification_stats(
    aux: GaussianAux,
    mean2d_grad: torch.Tensor,  # (C, 2) grad w.r.t. NDC means
    radii: torch.Tensor,  # (C,) int32
    pixels: torch.Tensor,  # (C,) touched-pixel counts
    apply_mask: Optional[torch.Tensor] = None,
) -> GaussianAux:
    """Update max radii and pixel-weighted screen-gradient stats
    (train.py:443-449, gaussian_model.py:648-654)."""
    update = radii > 0
    sel = update if apply_mask is None else (update & apply_mask)
    gnorm = torch.linalg.vector_norm(mean2d_grad, dim=-1)
    return aux._replace(
        max_radii2d=torch.where(
            update, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
            aux.max_radii2d,
        ),
        xyz_grad_accum=torch.where(
            sel, aux.xyz_grad_accum + gnorm * pixels, aux.xyz_grad_accum
        ),
        denom=torch.where(sel, aux.denom + pixels, aux.denom),
    )
