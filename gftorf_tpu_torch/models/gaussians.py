"""Gaussian scene state: parameters, activations, Adam and densify stats.

Port of ``gftorf_tpu/models/gaussians.py``: the fixed-capacity state
(``GaussianParams``, ``GaussianAux``, ``AdamState``,
``GaussianModelState``), the reference's GaussianModel activations
(scene/gaussian_model.py:28-43, 147-161), ``adam_update`` and
``add_densification_stats``, and the Trainer's model events:
``init_from_pcd``, ``grow_capacity``, ``sort_layout``,
``densify_and_prune``, ``prune_only`` and the opacity resets. Every
function here returns new tensors and leaves its inputs as they were,
like the JAX package: the training step is pure, so a caller can keep the
pre-step state to roll back.

Capacity: every per-point array has a fixed capacity C with an ``alive``
mask, as in the JAX package. Pruning clears alive bits; clone and split
write new rows into free slots and zero their Adam moments (the
reference's cat-with-zeroed-state, gaussian_model.py:524-525); when the
free slots run out, ``densify_and_prune`` reports how many points it
dropped and the caller grows the capacity and runs it again.

SH layout: color coefficients are (C, M, 3); phase/amp are (C, M) each.
Per-coefficient learning rates (DC vs rest/20, gaussian_model.py:247-274)
are tensors broadcast against the parameter, so one Adam serves every
group; this is why ``torch.optim.Adam`` (one lr per group, in-place
updates) does not serve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from gftorf_tpu_torch.ops.covariance import quat_to_rotmat


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


def map_rows(fn, state: GaussianModelState, capacity: int) -> GaussianModelState:
    """``fn`` over every per-point leaf of the state (leading dim
    ``capacity``: params, aux and both Adam moments); other leaves (the
    offsets, the Adam step) pass through."""

    def leaf(x):
        return fn(x) if x.ndim >= 1 and x.shape[0] == capacity else x

    params, aux, adam = state
    return GaussianModelState(
        params=tree_map(leaf, params),
        aux=tree_map(leaf, aux),
        adam=AdamState(mu=tree_map(leaf, adam.mu), nu=tree_map(leaf, adam.nu),
                       step=adam.step),
    )


# ---------------------------------------------------------------------------
# Construction


def init_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    phases: Optional[np.ndarray],
    amplitudes: Optional[np.ndarray],
    seg_colors: Optional[np.ndarray],
    capacity: int,
    sh_degree: int = 3,
    initial_opacity: float = 0.1,
    isotropic: bool = False,
    init_static_first: bool = False,
    device=None,
) -> GaussianModelState:
    """Initialize from a point cloud (create_from_pcd,
    gaussian_model.py:180-236). Scales come from the mean 3-NN distance
    (``ops/knn.py``, on ``device``); when ``init_static_first`` the
    static and dynamic halves get independent KNN (:193-196).
    ``device=None`` means the CUDA card."""
    from gftorf_tpu_torch.ops.knn import mean_knn_sq_dist
    from gftorf_tpu_torch.ops.sh import pa2sh, rgb2sh
    from gftorf_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")
    m = (sh_degree + 1) ** 2

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pts = t32(points)
    if init_static_first:
        dist2 = torch.cat([mean_knn_sq_dist(pts[: n // 2]),
                           mean_knn_sq_dist(pts[n // 2:])])
    else:
        dist2 = mean_knn_sq_dist(pts)
    log_scale = torch.log(torch.sqrt(dist2.clamp(min=1e-7)))[:, None]
    scaling = log_scale if isotropic else log_scale.repeat(1, 3)

    sh_color = torch.zeros((n, m, 3), device=dev)
    sh_color[:, 0, :] = rgb2sh(t32(colors))
    sh_phase = torch.zeros((n, m), device=dev)
    if phases is not None:
        sh_phase[:, 0] = pa2sh(t32(phases))
    sh_amp = torch.zeros((n, m), device=dev)
    if amplitudes is not None:
        sh_amp[:, 0] = pa2sh(t32(amplitudes))
    rot = torch.zeros((n, 4), device=dev)
    rot[:, 0] = 1.0
    opac = inverse_sigmoid(initial_opacity * torch.ones((n, 1), device=dev))
    seg = t32(seg_colors) if seg_colors is not None else torch.zeros((n, 3), device=dev)

    def pad(x):
        return torch.cat([x, x.new_zeros((capacity - n,) + x.shape[1:])])

    params = GaussianParams(
        xyz=pad(pts), sh_color=pad(sh_color), sh_phase=pad(sh_phase),
        sh_amp=pad(sh_amp), scaling=pad(scaling), rotation=pad(rot),
        opacity=pad(opac), seg_color=pad(seg),
        phase_offset=torch.zeros((1,), device=dev),
        dc_offset=torch.zeros((1,), device=dev),
    )
    aux = GaussianAux(
        alive=torch.arange(capacity, device=dev) < n,
        max_radii2d=torch.zeros((capacity,), device=dev),
        xyz_grad_accum=torch.zeros((capacity,), device=dev),
        denom=torch.zeros((capacity,), device=dev),
    )
    zeros = tree_map(torch.zeros_like, params)
    adam = AdamState(mu=zeros, nu=tree_map(torch.zeros_like, params),
                     step=torch.zeros((), dtype=torch.int32, device=dev))
    return GaussianModelState(params=params, aux=aux, adam=adam)


def grow_capacity(state: GaussianModelState, new_capacity: int) -> GaussianModelState:
    """Pad every per-point array with dead slots up to ``new_capacity``."""
    old = state.aux.alive.shape[0]
    extra = new_capacity - old
    if extra <= 0:
        return state
    return map_rows(lambda x: torch.cat([x, x.new_zeros((extra,) + x.shape[1:])]),
                    state, old)


def sort_layout(state: GaussianModelState) -> GaussianModelState:
    """Permute per-point rows into [dynamic+alive | static+alive | dead].

    A stable sort (two sorts compose to the identity) that moves params,
    aux accumulators and Adam moments together. The Trainer re-sorts at
    every event that changes the alive or motion partition (densify,
    prune, checkpoint restore), so the training step can compact with
    slices (``StepStatic.compact_layout``): the alive rows are exactly
    [0, n_alive) with the dynamic ones first.
    """
    params, aux, _ = state
    C = aux.alive.shape[0]
    motion = get_motion_mask(params)
    cls = torch.where(aux.alive, torch.where(motion, 0, 1), 2)
    perm = torch.argsort(cls, stable=True)
    return map_rows(lambda x: x[perm], state, C)


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
# Densification (gaussian_model.py:568-654)


@dataclasses.dataclass(frozen=True)
class DensifyHyper:
    grad_threshold: float = 0.0002
    min_opacity: float = 0.01
    percent_dense: float = 0.01
    split_n: int = 2
    split_scale_shrink: float = 0.8  # new scale = old / (shrink * N)


def _f32(x, dev):
    return torch.tensor(x, dtype=torch.float32, device=dev)


def densify_masks(state: GaussianModelState, hyper: DensifyHyper,
                  scene_extent: float, max_screen_size: float):
    """The decisions of ``densify_and_prune``: the (C,) clone, split and
    prune masks (the prune mask holds the split originals too)."""
    params, aux, _ = state
    dev = params.xyz.device
    alive = aux.alive
    max_scale = get_scaling(params).max(dim=-1).values
    # Thresholds in float32, as the JAX package forms them on the device.
    extent = _f32(scene_extent, dev)

    grads = aux.xyz_grad_accum / aux.denom.clamp(min=1e-30)
    grads = torch.where(aux.denom > 0, grads, 0.0)
    high = alive & (grads >= hyper.grad_threshold)
    dense_thr = _f32(hyper.percent_dense, dev) * extent
    clone_m = high & (max_scale <= dense_thr)
    split_m = high & (max_scale > dense_thr)

    # Prune (:624-638); the screen-size rule is inert in the reference
    # (max_radii2D is zeroed before it is read, :566), so only the
    # world-size rules apply. Split originals are replaced (:600-601).
    prune = alive & (get_opacity(params)[:, 0] < hyper.min_opacity)
    if max_screen_size > 0:
        prune = prune | (alive & ((max_scale > _f32(0.05, dev) * extent)
                                  | (max_scale < _f32(0.001, dev) * extent)))
    return clone_m, split_m, prune | split_m


def densify_and_prune(
    state: GaussianModelState,
    noise: Union[torch.Tensor, torch.Generator],
    hyper: DensifyHyper,
    scene_extent: float,
    max_screen_size: float,  # 0.0 disables the world-size prune terms
):
    """Clone small/high-grad, split large/high-grad, prune low-opacity/huge
    (densify_and_prune of the JAX package, gaussians.py:307-464).

    ``noise`` is the split draw, a (split_n, C, 3) standard-normal tensor
    (the JAX package's ``jax.random.normal(key, (n, C, 3))``), or a
    ``torch.Generator`` on the state's device to draw it from.

    Returns (new_state, dropped): ``dropped`` (a 0-d tensor) > 0 means the
    free slots did not hold every new point; the caller grows the
    capacity and runs it again with the same draw.
    """
    params, aux, adam = state
    C = aux.alive.shape[0]
    dev = params.xyz.device
    alive = aux.alive
    scal = get_scaling(params)
    clone_m, split_m, prune = densify_masks(state, hyper, scene_extent,
                                            max_screen_size)

    n = hyper.split_n
    if isinstance(noise, torch.Generator):
        noise = torch.randn((n, C, 3), generator=noise, device=dev)
    samples = noise * scal[None]
    rotm = quat_to_rotmat(get_rotation(params))  # (C, 3, 3)
    offsets = torch.einsum("cij,ncj->nci", rotm, samples)
    split_xyz = params.xyz[None] + offsets  # (n, C, 3)
    if params.scaling.shape[-1] == 1:
        # isotropic: shrink the activated 1-channel scale (:582-583)
        split_scaling = torch.log(torch.exp(params.scaling)
                                  / (hyper.split_scale_shrink * n))
    else:
        split_scaling = torch.log(scal / (hyper.split_scale_shrink * n))

    survivors = alive & ~prune
    free = ~survivors
    i32 = torch.int32
    free_rank = torch.cumsum(free.to(i32), 0) - 1  # rank among free slots
    clone_rank = torch.cumsum(clone_m.to(i32), 0) - 1
    split_rank = torch.cumsum(split_m.to(i32), 0) - 1
    n_clone = clone_m.sum()
    n_split = split_m.sum()
    total_new = n_clone + n * n_split
    dropped = (total_new - free.sum()).clamp(min=0)

    # Free slot of rank r takes new point r: clones [0, n_clone), then
    # split copy k of point j at n_clone + k * n_split + rank_j.
    slot_ids = torch.arange(C, device=dev)

    def inverse(mask, rank):
        # rank -> source slot; slot C collects the masked-out rows.
        inv = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
        inv[torch.where(mask, rank.to(torch.int64), C)] = slot_ids
        return inv[:C]

    clone_src = inverse(clone_m, clone_rank)
    split_src = inverse(split_m, split_rank)
    is_new = free & (free_rank < total_new)
    q = torch.where(is_new, free_rank, 0).to(torch.int64)
    is_clone_slot = q < n_clone
    src_clone = clone_src[q.clamp(0, C - 1)]
    q_split = q - n_clone
    per = n_split.clamp(min=1)
    copy_k = torch.where(is_clone_slot, 0,
                         torch.div(q_split, per, rounding_mode="floor"))
    src_split = split_src[torch.remainder(q_split, per).clamp(0, C - 1)]
    src = torch.where(is_clone_slot, src_clone, src_split).clamp(0, C - 1)

    def bc(mask, like):
        return mask.reshape(mask.shape + (1,) * (like.ndim - 1))

    def fill(dst, split_vals=None):
        """Survivors keep ``dst``; new slots copy their source row, or
        take ``split_vals`` (n, C, ...) for split copies."""
        newv = dst[src]
        if split_vals is not None:
            splitted = split_vals[copy_k.clamp(0, n - 1), src]
            newv = torch.where(bc(is_clone_slot, newv), newv, splitted)
        return torch.where(bc(is_new, newv), newv, dst)

    new_params = GaussianParams(
        xyz=fill(params.xyz, split_xyz),
        sh_color=fill(params.sh_color),
        sh_phase=fill(params.sh_phase),
        sh_amp=fill(params.sh_amp),
        scaling=fill(params.scaling, split_scaling[None].expand(
            (n,) + params.scaling.shape)),
        rotation=fill(params.rotation),
        opacity=fill(params.opacity),
        seg_color=fill(params.seg_color),
        phase_offset=params.phase_offset,
        dc_offset=params.dc_offset,
    )

    # Adam moments of new slots start at zero (gaussian_model.py:463-464,
    # 524-525).
    def zero_new(x):
        if x.ndim >= 1 and x.shape[0] == C:
            return torch.where(bc(is_new, x), torch.zeros_like(x), x)
        return x

    new_adam = AdamState(mu=tree_map(zero_new, adam.mu),
                         nu=tree_map(zero_new, adam.nu), step=adam.step)
    new_aux = GaussianAux(
        alive=survivors | is_new,
        max_radii2d=torch.zeros_like(aux.max_radii2d),
        xyz_grad_accum=torch.zeros_like(aux.xyz_grad_accum),
        denom=torch.zeros_like(aux.denom),
    )
    return GaussianModelState(new_params, new_aux, new_adam), dropped


def prune_only(state: GaussianModelState, min_opacity: float) -> GaussianModelState:
    """Opacity-only pruning (gaussian_model.py:642-646)."""
    params, aux, adam = state
    alive = aux.alive & (get_opacity(params)[:, 0] >= min_opacity)
    return GaussianModelState(params, aux._replace(alive=alive), adam)


def reset_opacity(params: GaussianParams,
                  apply_mask: Optional[torch.Tensor] = None) -> GaussianParams:
    """Clamp opacity to <= 0.01 (gaussian_model.py:369-376)."""
    new = inverse_sigmoid(torch.clamp(get_opacity(params), max=0.01))
    if apply_mask is not None:
        new = torch.where(apply_mask[:, None], new, params.opacity)
    return params._replace(opacity=new)


def reset_opacity_state(state: GaussianModelState,
                        apply_mask: Optional[torch.Tensor] = None
                        ) -> GaussianModelState:
    """Opacity reset with the Adam-state zeroing of the reference's
    replace_tensor_to_optimizer (gaussian_model.py:369-376, 456-471): the
    opacity group's moments become zeros. Stale moments would drift every
    point that gets no gradient by about lr per iteration after the reset,
    and the next prune would take half the scene; with zeroed moments a
    zero-gradient point stays at exactly 0.01."""
    params = reset_opacity(state.params, apply_mask)
    adam = state.adam._replace(
        mu=state.adam.mu._replace(opacity=torch.zeros_like(state.adam.mu.opacity)),
        nu=state.adam.nu._replace(opacity=torch.zeros_like(state.adam.nu.opacity)),
    )
    return state._replace(params=params, adam=adam)


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
