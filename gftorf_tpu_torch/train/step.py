"""The evaluation path's share of ``gftorf_tpu/train/step.py``.

``StepStatic`` with the fields the eval path reads, ``FrameData``, the
deform query (``_deform_slots``, ``_query_deform``: the reference's
query_dmlp + F-ToRF interpolation, train.py:164-177) and the
static/dynamic composition ``_compose`` (gaussian_renderer/__init__.py:
81-105). The training step itself comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from gftorf_tpu_torch.models.deform import DeformConfig, DeformNetwork, embed_xyz
from gftorf_tpu_torch.models.gaussians import (
    GaussianParams,
    get_features_phasor,
    get_motion_mask,
    get_opacity,
    get_rotation,
    get_scaling,
)
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig


class FrameData(NamedTuple):
    """Per-frame observations (one frame, no leading axis)."""

    frame_id: torch.Tensor  # () int32
    cam_color: CameraSpec
    cam_tof: CameraSpec
    gt_image: torch.Tensor  # (3, Hc, Wc)
    gt_phasor: torch.Tensor  # (3, Ht, Wt) real/imag/amp
    gt_quad: torch.Tensor  # (4, Ht, Wt)
    gt_distance: torch.Tensor  # (1, Ht, Wt)
    forward_flow: torch.Tensor  # (2, Ht, Wt)
    backward_flow: torch.Tensor  # (2, Ht, Wt)
    has_forward_flow: torch.Tensor  # () bool
    has_backward_flow: torch.Tensor  # () bool
    phase_offset: torch.Tensor  # () camera-calibrated phase offset
    dc_offset: torch.Tensor  # ()
    intrinsics_tof: torch.Tensor  # (3, 3) K_tof
    intrinsics_color: torch.Tensor  # (3, 3) K color


@dataclasses.dataclass(frozen=True)
class StepStatic:
    """Static configuration of a render; the fields of the JAX
    ``StepStatic`` that the eval path reads, with the same meanings."""

    scene_type: str  # 'torf' | 'ftorf' | 'color'
    config_color: RasterConfig
    config_tof: RasterConfig
    deform: DeformConfig
    active_sh_degree: int
    total_num_views: int
    render_regions: Tuple[str, ...]
    dynamic_on: bool  # dataset.dynamic and iteration > warm_up
    use_quad: bool
    num_phasor_channels: int
    optimize_phase_offset: bool
    optimize_dc_offset: bool
    tof_inverse_permutation: Tuple[int, ...] = (0, 1, 2, 3)
    scene_extent: float = 1.0
    # F-ToRF: identical color/ToF cameras, so one render serves both.
    single_camera: bool = False
    # train.py:168 `fid % 4 == 0 or iteration <= optimize_sync_iters`.
    deform_sync: bool = False
    # Rows are sorted [dynamic+alive | static+alive | dead]: the deform
    # bucket is the static slice [0, deform_bucket).
    compact_layout: bool = False
    # Dynamic-compaction bucket for the deform MLP (0 = all rows).
    deform_bucket: int = 0
    # Trust region on the deformation: ||d_xyz|| <= deform_clip *
    # scene_extent per point (0 = off).
    deform_clip: float = 0.0


def _deform_slots(static: StepStatic, params: GaussianParams, alive):
    """Dynamic-compacted MLP input rows (step.py:439-484).

    Returns (xyz_n_rows, expand) where expand maps (B, ...) -> (N, ...)
    with zeros on non-dynamic slots (identity when compaction is off).
    """
    xyz_n = params.xyz.detach() / static.scene_extent
    n = xyz_n.shape[0]
    b = static.deform_bucket
    if not b or b >= n or alive is None:
        return xyz_n, (lambda d: d)
    mask = get_motion_mask(params) & alive
    if static.compact_layout:
        rows = xyz_n[:b]

        def expand(d_b):
            out = torch.cat([d_b, d_b.new_zeros((n - b,) + d_b.shape[1:])])
            keep = mask.reshape((n,) + (1,) * (d_b.ndim - 1))
            return torch.where(keep, out, 0.0)

        return rows, expand
    # The first b dynamic+alive rows, padded with the out-of-range index n
    # (jnp.where(mask, size=b, fill_value=n)).
    idx = torch.nonzero(mask).flatten()[:b]
    idx = torch.cat([idx, idx.new_full((b - idx.numel(),), n)])
    rows = xyz_n[idx.clamp(max=n - 1)]

    def expand(d_b):
        # Scatter with the padding index dropped: one extra row, sliced off.
        out = d_b.new_zeros((n + 1,) + d_b.shape[1:])
        out[idx] = d_b
        return out[:n]

    return rows, expand


def _query_deform(static: StepStatic, deform: DeformNetwork,
                  params: GaussianParams, fid: int, alive=None):
    """Deformation for every point (step.py:487-555); returns
    (d_xyz, d_rot, d_sh, d_sh_p, d_curr, d_next). ``fid`` is the frame
    index (a Python int or a 0-d tensor)."""
    fid = int(fid)
    xyz_n, expand = _deform_slots(static, params, alive)
    denom = max(static.total_num_views - 1, 1)

    def clip_dxyz(d):
        if static.deform_clip <= 0.0:
            return d
        max_norm = static.deform_clip * static.scene_extent
        norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return d * torch.clamp(max_norm / norm.clamp(min=1e-12), max=1.0)

    def times(t_value, rows):
        return torch.full((rows, 1), t_value, dtype=torch.float32,
                          device=xyz_n.device)

    if static.scene_type == "torf":
        d = deform(xyz_n, times(_f32_div(fid, denom), xyz_n.shape[0]))
        d = (clip_dxyz(d[0]),) + tuple(d[1:])
        d_xyz, d_rot, d_sh, d_sh_p = (expand(x) for x in d)
        return d_xyz, d_rot, d_sh, d_sh_p, d_xyz, d_xyz
    # ftorf: lerp between the neighboring integration (multiple-of-4)
    # frames, one stacked MLP call for both samples. The reference keeps
    # only d_xyz here (train.py:171): d_rot/d_sh/d_sh_p stay zero.
    curr = (fid // 4) * 4
    nxt = curr + 4
    b = xyz_n.shape[0]
    t2 = torch.cat([times(_f32_div(curr, denom), b),
                    times(_f32_div(nxt, denom), b)])
    x_emb1 = embed_xyz(static.deform, xyz_n)
    d2 = deform(torch.cat([xyz_n, xyz_n]), t2,
                x_emb=torch.cat([x_emb1, x_emb1]))[0]
    d_curr = expand(clip_dxyz(d2[:b]))
    d_next = expand(clip_dxyz(d2[b:]))
    if static.deform_sync or fid % 4 == 0:
        d_xyz = d_curr
    else:
        frac_next = float(fid - curr)
        frac_curr = float(nxt - fid)
        d_xyz = 0.25 * (frac_next * d_next + frac_curr * d_curr)
    n = d_xyz.shape[0]
    m = (static.deform.sh_degree + 1) ** 2
    d_rot = d_xyz.new_zeros((n, 4))
    d_sh = d_xyz.new_zeros((n, m, 3))
    d_sh_p = d_xyz.new_zeros((n, m, 2))
    return d_xyz, d_rot, d_sh, d_sh_p, d_curr, d_next


def _f32_div(a: int, b: int) -> float:
    """a / b rounded as the JAX package's float32 division rounds it."""
    return (torch.tensor(a, dtype=torch.float32)
            / torch.tensor(b, dtype=torch.float32)).item()


def _compose(static: StepStatic, params: GaussianParams, d_xyz, d_rot, d_sh,
             alive):
    """Static/dynamic composition (gaussian_renderer/__init__.py:81-105).

    Returns (means3d, scales, rotations, opacity, shs, shs_p, include);
    excluded points are dropped from binning by the caller via include.
    """
    motion = get_motion_mask(params)
    inc_static = "static" in static.render_regions
    inc_dynamic = "dynamic" in static.render_regions
    include = torch.where(motion, inc_dynamic, inc_static) & alive

    m = motion[:, None]
    means3d = torch.where(m, params.xyz + d_xyz, params.xyz)
    rotations = torch.where(
        m, get_rotation(params._replace(rotation=params.rotation + d_rot)),
        get_rotation(params),
    )
    shs = torch.where(motion[:, None, None], params.sh_color + d_sh,
                      params.sh_color)
    return (
        means3d,
        get_scaling(params),
        rotations,
        get_opacity(params)[:, 0],
        shs,
        get_features_phasor(params),
        include,
    )
