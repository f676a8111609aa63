"""Public renderer bridge: ``render``, ``render_flow`` and ``render_eval``.

Port of ``gftorf_tpu/renderer.py`` (the reference's
gaussian_renderer/__init__.py:19-300 API): the functional state
(GaussianParams + deformation offsets) in, the reference's output dict
out. ``render`` and ``render_eval`` serve and run without autograd;
``render_flow`` is differentiable with respect to the flow vectors (its
geometry is detached, as in the reference).
"""

from __future__ import annotations

from typing import Sequence

import torch

from gftorf_tpu_torch.models.gaussians import (
    GaussianParams,
    get_features_phasor,
    get_motion_mask,
    get_opacity,
    get_rotation,
    get_scaling,
)
from gftorf_tpu_torch.render.rasterize import rasterize
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig
from gftorf_tpu_torch.utils.runtime import check_on


def _compose(params: GaussianParams, d_xyz, d_rot, d_sh, d_sh_p,
             render_regions: Sequence[str], alive=None):
    """Static/dynamic composition (gaussian_renderer/__init__.py:81-105)."""
    motion = get_motion_mask(params)
    include = torch.where(motion, "dynamic" in render_regions,
                          "static" in render_regions)
    if alive is not None:
        include = include & alive
    m = motion[:, None]
    means3d = torch.where(m, params.xyz + d_xyz, params.xyz)
    rotations = torch.where(
        m, get_rotation(params._replace(rotation=params.rotation + d_rot)),
        get_rotation(params),
    )
    shs = torch.where(motion[:, None, None], params.sh_color + d_sh,
                      params.sh_color)
    shs_p0 = get_features_phasor(params)
    shs_p = torch.where(motion[:, None, None], shs_p0 + d_sh_p, shs_p0)
    opacity = torch.where(include, get_opacity(params)[:, 0], 0.0)
    return means3d, get_scaling(params), rotations, opacity, shs, shs_p


def _offsets(params, optimize_phase_offset, optimize_dc_offset,
             cam_phase_offset, cam_dc_offset):
    phase_offset = (params.phase_offset[0] if optimize_phase_offset
                    else cam_phase_offset)
    dc_offset = params.dc_offset[0] if optimize_dc_offset else cam_dc_offset
    return phase_offset, dc_offset


@torch.no_grad()
def render(
    params: GaussianParams,
    d_xyz, d_rot, d_sh, d_sh_p,
    cam_color: CameraSpec, cam_tof: CameraSpec,
    config_color: RasterConfig, config_tof: RasterConfig,
    bg_map: torch.Tensor,
    active_sh_degree: int = 3,
    render_regions: Sequence[str] = ("static", "dynamic"),
    optimize_phase_offset: bool = False,
    optimize_dc_offset: bool = False,
    cam_phase_offset=0.0,
    cam_dc_offset=0.0,
    alive=None,
    device=None,
):
    """Render both cameras; returns the reference's render() dict
    (gaussian_renderer/__init__.py:130-139). The inputs must lie on
    ``device`` (None = the CUDA card)."""
    check_on(device, params.xyz, bg_map)
    n = params.xyz.shape[0]
    means3d, scales, rots, opac, shs, shs_p = _compose(
        params, d_xyz, d_rot, d_sh, d_sh_p, render_regions, alive)
    phase_offset, dc_offset = _offsets(
        params, optimize_phase_offset, optimize_dc_offset, cam_phase_offset,
        cam_dc_offset)
    means2d = torch.zeros((n, 2), device=params.xyz.device)
    out_color = rasterize(
        means3d, scales, rots, opac, shs, shs_p, phase_offset, dc_offset,
        means2d, bg_map, camera=cam_color, config=config_color,
        active_sh_degree=active_sh_degree,
    )
    out_tof = rasterize(
        means3d, scales, rots, opac, shs, shs_p, phase_offset, dc_offset,
        means2d, bg_map, camera=cam_tof, config=config_tof,
        active_sh_degree=active_sh_degree,
    )
    return {
        "render": out_color.color,
        "render_phasor": out_tof.phasor,
        "render_depth": out_tof.depth,
        "render_depth_color": out_color.depth,
        "render_acc": out_tof.acc,
        "render_acc_color": out_color.acc,
        "depth_distortion": out_tof.depth_distortion,
        "depth_distortion_color": out_color.depth_distortion,
        "visibility_filter": out_tof.radii > 0,
        "radii": out_tof.radii,
        "distribution_tof": out_tof.distribution,
        "pixels": out_tof.pixels,
    }


def render_flow(
    params: GaussianParams,
    d_xyz, d_rot, flow3d,
    cam_tof: CameraSpec, config_tof: RasterConfig,
    active_sh_degree: int = 3,
    render_regions: Sequence[str] = ("static", "dynamic"),
    alive=None,
    device=None,
):
    """Splat 3D scene flow (N, 3) through the color channels with detached
    geometry and a zero background (gaussian_renderer/__init__.py:141-204);
    returns ``{"render_flow": (3, H, W)}``. The inputs must lie on
    ``device`` (None = the CUDA card)."""
    check_on(device, params.xyz, flow3d)
    n = params.xyz.shape[0]
    dev = params.xyz.device
    means3d, scales, rots, opac, _, _ = _compose(
        params, d_xyz, d_rot, torch.zeros_like(params.sh_color),
        torch.zeros((n,) + params.sh_phase.shape[1:] + (2,), device=dev),
        render_regions, alive)
    flow_masked = torch.where(get_motion_mask(params)[:, None], flow3d, 0.0)
    out = rasterize(
        means3d.detach(), scales.detach(), rots.detach(), opac.detach(),
        None, None, 0.0, 0.0, torch.zeros((n, 2), device=dev),
        torch.zeros((7, config_tof.height, config_tof.width), device=dev),
        camera=cam_tof, config=config_tof, active_sh_degree=active_sh_degree,
        colors_precomp=flow_masked,
    )
    return {"render_flow": out.color}


@torch.no_grad()
def render_eval(
    params: GaussianParams,
    d_xyz, d_rot, d_sh, d_sh_p,
    camera: CameraSpec, config: RasterConfig,
    bg_map: torch.Tensor,
    active_sh_degree: int = 3,
    render_regions: Sequence[str] = ("static", "dynamic"),
    optimize_phase_offset: bool = False,
    optimize_dc_offset: bool = False,
    cam_phase_offset=0.0,
    cam_dc_offset=0.0,
    alive=None,
    device=None,
):
    """Single-camera evaluation render (gaussian_renderer/__init__.py:
    206-300). The inputs must lie on ``device`` (None = the CUDA card)."""
    check_on(device, params.xyz, bg_map)
    n = params.xyz.shape[0]
    means3d, scales, rots, opac, shs, shs_p = _compose(
        params, d_xyz, d_rot, d_sh, d_sh_p, render_regions, alive)
    phase_offset, dc_offset = _offsets(
        params, optimize_phase_offset, optimize_dc_offset, cam_phase_offset,
        cam_dc_offset)
    out = rasterize(
        means3d, scales, rots, opac, shs, shs_p, phase_offset, dc_offset,
        torch.zeros((n, 2), device=params.xyz.device), bg_map, camera=camera,
        config=config, active_sh_degree=active_sh_degree,
    )
    return {
        "render": out.color,
        "render_phasor": out.phasor,
        "render_depth": out.depth,
        "render_acc": out.acc,
        "render_dd": out.depth_distortion,
        "distribution": out.distribution,
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
    }
