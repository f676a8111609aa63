"""Per-Gaussian preprocessing: cull, project, build conics and features.

Port of ``gftorf_tpu/render/preprocess.py`` (the reference's preprocess
kernel, cuda_rasterizer/forward.cu:251-419) as batched torch ops over
(P, ...) tensors. The clamp/clip/stop-gradient forms of the JAX version
are kept so that autograd matches the reference backward
(backward.cu:265-606); tests/test_torch_rasterize_grad.py holds every
input's gradient against ``jax.grad``:
 - the color and amplitude clamps at 0 are ``clamp(min=0)``;
 - the 1.3*tan(fov) view clip is ``torch.clamp`` (ops/covariance.py);
 - the phase DC removal subtracts a ``.detach()``-ed SH_C0 * sh_p[0];
 - quaternions are used unnormalized (forward.cu:181).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gftorf_tpu_torch.ops.covariance import (
    build_cov3d,
    conic_from_cov2d,
    ewa_project_cov2d,
    screen_radius,
)
from gftorf_tpu_torch.ops.sh import SH_C0, eval_sh
from gftorf_tpu_torch.ops.tof import phasor_channels
from gftorf_tpu_torch.ops.transforms import (
    ndc2pix,
    transform_point_4x3,
    transform_point_4x4,
)
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig


class PreprocessOutputs(NamedTuple):
    valid: torch.Tensor  # (P,) bool — survives culling
    mean2d: torch.Tensor  # (P, 2) pixel coords
    depth_view: torch.Tensor  # (P,) view-space z (sort key)
    conic: torch.Tensor  # (P, 3) inverse 2D covariance
    opacity: torch.Tensor  # (P,)
    rgb: torch.Tensor  # (P, 3)
    phasor: torch.Tensor  # (P, 7)
    dist: torch.Tensor  # (P,) distance to light
    dist_ndc: torch.Tensor  # (P,) NDC-mapped distance
    radius: torch.Tensor  # (P,) float radius (ceil applied)
    rect: torch.Tensor  # (P, 4) int32 tile rect [x0, y0, x1, y1)
    tiles_touched: torch.Tensor  # (P,) int32


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    shs_p: Optional[torch.Tensor],
    phase_offset,
    dc_offset,
    means2d_ndc: torch.Tensor,
    camera: CameraSpec,
    config: RasterConfig,
    active_sh_degree: int,
    colors_precomp: Optional[torch.Tensor] = None,
    phasors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> PreprocessOutputs:
    """Preprocess all Gaussians for one camera (same arguments and
    semantics as the JAX ``preprocess``; see its docstring)."""
    P = means3d.shape[0]
    opacities = opacities.reshape(P)

    # --- Projection & frustum cull (forward.cu:290-305)
    p_view = transform_point_4x3(means3d, camera.viewmatrix)
    depth_view = p_view[..., 2]
    in_frustum = (depth_view >= camera.znear) & (depth_view <= camera.zfar)
    # Culled Gaussians never contribute, but their values stay finite.
    p_view = torch.where(in_frustum[..., None], p_view, torch.ones_like(p_view))

    p_hom = transform_point_4x4(means3d, camera.projmatrix)
    denom = p_hom[..., 3] + 1e-7
    p_w = 1.0 / torch.where(in_frustum, denom, torch.ones_like(denom))
    p_proj = p_hom[..., :3] * p_w[..., None]
    ndc_xy = p_proj[..., :2] + means2d_ndc
    mean2d = torch.stack(
        [ndc2pix(ndc_xy[..., 0], config.width), ndc2pix(ndc_xy[..., 1], config.height)],
        dim=-1,
    )

    # --- Covariance (forward.cu:307-337)
    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = build_cov3d(scales, config.scale_modifier, rotations)
    cov2d = ewa_project_cov2d(
        p_view, cov3d, camera.viewmatrix, camera.focal_x, camera.focal_y,
        camera.tan_fovx, camera.tan_fovy,
    )
    conic, det = conic_from_cov2d(cov2d)
    det_ok = det != 0.0
    radius = screen_radius(cov2d, det)

    # --- Tile rect (auxiliary.h:49-59)
    gw, gh = config.grid_w, config.grid_h
    r = radius.detach()
    m2d = mean2d.detach()
    tw, th = config.tile_w, config.tile_h
    x0 = torch.clamp(torch.floor((m2d[..., 0] - r) / tw), 0, gw).to(torch.int32)
    y0 = torch.clamp(torch.floor((m2d[..., 1] - r) / th), 0, gh).to(torch.int32)
    x1 = torch.clamp(torch.floor((m2d[..., 0] + r + tw - 1) / tw), 0, gw).to(torch.int32)
    y1 = torch.clamp(torch.floor((m2d[..., 1] + r + th - 1) / th), 0, gh).to(torch.int32)
    tiles_touched = (x1 - x0) * (y1 - y0)
    # Zero-opacity cull, as in the JAX package: exact-zero opacity slots
    # contribute nothing but would occupy lanes in every tile they touch.
    valid = in_frustum & det_ok & (tiles_touched > 0) & (opacities > 0.0)
    tiles_touched = torch.where(valid, tiles_touched, torch.zeros_like(tiles_touched))
    rect = torch.stack([x0, y0, x1, y1], dim=-1)

    # --- View direction for SH; rsqrt(sum + eps) keeps the gradient
    # finite at the origin (dead slots may sit on the camera).
    dir_raw = means3d - camera.campos
    dir_n = dir_raw * torch.rsqrt((dir_raw * dir_raw).sum(-1, keepdim=True) + 1e-20)

    # --- Color (forward.cu:344-359)
    if shs is not None:
        rgb = eval_sh(active_sh_degree, shs.transpose(-1, -2), dir_n) + 0.5
        rgb = torch.clamp(rgb, min=0.0)
    elif colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = torch.zeros((P, 3), dtype=means3d.dtype, device=means3d.device)

    # --- ToF phasor (forward.cu:361-407)
    dist = torch.linalg.vector_norm(p_view, dim=-1)
    dist_ndc = camera.zfar / (camera.zfar - camera.znear) * (1.0 - camera.znear / dist)

    if shs_p is not None:
        pa = eval_sh(active_sh_degree, shs_p.transpose(-1, -2), dir_n) + 0.5
        phase_sh = pa[..., 0] - (0.5 + SH_C0 * shs_p[..., 0, 0]).detach()
        amp = torch.clamp(pa[..., 1], min=0.0)
        phasor = phasor_channels(
            dist, phase_sh, amp, camera.depth_range, phase_offset, dc_offset,
            config.use_view_dependent_phase,
        )
    elif phasors_precomp is not None:
        # The reference's precomp branch omits phase_offset (forward.cu:367).
        phasor = phasor_channels(
            dist, phasors_precomp[..., 0], phasors_precomp[..., 1],
            camera.depth_range, 0.0, dc_offset,
            config.use_view_dependent_phase,
        )
    else:
        phasor = torch.zeros((P, 7), dtype=means3d.dtype, device=means3d.device)

    radius_out = torch.where(valid, radius, torch.zeros_like(radius))
    return PreprocessOutputs(
        valid=valid,
        mean2d=mean2d,
        depth_view=depth_view,
        conic=conic,
        opacity=opacities,
        rgb=rgb,
        phasor=phasor,
        dist=dist,
        dist_ndc=dist_ndc,
        radius=radius_out,
        rect=rect,
        tiles_touched=tiles_touched,
    )
