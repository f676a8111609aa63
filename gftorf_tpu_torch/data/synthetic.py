"""Synthetic random scenes for tests and benchmarks.

Port of ``gftorf_tpu/data/synthetic.py``: the same distributions and the
same camera and RasterConfig, drawn from a ``torch.Generator`` in place of
a JAX key (so the numbers differ from the JAX package's for one seed; hand
one scene's arrays to both packages to compare them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gftorf_tpu_torch.ops.transforms import projection_matrix, world_to_view
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig
from gftorf_tpu_torch.utils.runtime import resolve_device


class SyntheticScene(NamedTuple):
    means3d: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    opacities: torch.Tensor
    shs: torch.Tensor
    shs_p: torch.Tensor
    phase_offset: torch.Tensor
    dc_offset: torch.Tensor
    camera: CameraSpec
    config: RasterConfig


def make_scene(
    generator: Optional[torch.Generator] = None,
    num_points: int = 256,
    width: int = 48,
    height: int = 32,
    sh_degree: int = 3,
    depth_range: float = 10.0,
    znear: float = 0.1,
    zfar: float = 50.0,
    scale_range=(0.02, 0.15),
    use_view_dependent_phase: bool = False,
    max_per_tile: int = 2048,
    isotropic: bool = False,
    dup_factor: int = 12,
    device=None,
) -> SyntheticScene:
    """Random Gaussians in the frustum of a camera at the origin looking
    down +z, drawn on the CPU from ``generator`` and moved to ``device``
    (None = the CUDA card)."""
    dev = resolve_device(device)
    g = generator
    m = (sh_degree + 1) ** 2

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    # Points spread inside the camera frustum, z in [1, 8].
    z = uniform((num_points,), 1.0, 8.0)
    x = uniform((num_points,), -0.45, 0.45) * z
    y = uniform((num_points,), -0.35, 0.35) * z
    means3d = torch.stack([x, y, z], -1)

    scales = uniform((num_points, 3), scale_range[0], scale_range[1])
    if isotropic:
        scales = scales[:, :1].repeat(1, 3)
    quat = torch.randn((num_points, 4), generator=g)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    opac = uniform((num_points,), 0.2, 0.95)

    shs = 0.3 * torch.randn((num_points, m, 3), generator=g)
    shs_p = 0.2 * torch.randn((num_points, m, 2), generator=g)
    # Keep amplitudes positive-ish via a DC bump.
    shs_p[:, 0, 1] += 1.0

    fov_x, fov_y = 0.9, 0.7
    view_t = world_to_view(np.eye(3), np.zeros(3))
    proj_t = projection_matrix(znear, zfar, fov_x, fov_y)
    camera = CameraSpec.create(view_t, proj_t, width, height, fov_x, fov_y,
                               znear, zfar, depth_range, device=dev)
    config = RasterConfig(
        height=height,
        width=width,
        sh_degree=sh_degree,
        max_per_tile=max_per_tile,
        use_view_dependent_phase=use_view_dependent_phase,
        dup_factor=dup_factor,
    )
    return SyntheticScene(
        means3d=means3d.to(dev),
        scales=scales.to(dev),
        rotations=quat.to(dev),
        opacities=opac.to(dev),
        shs=shs.to(dev),
        shs_p=shs_p.to(dev),
        phase_offset=torch.tensor(0.05, device=dev),
        dc_offset=torch.tensor(0.02, device=dev),
        camera=camera,
        config=config,
    )
