"""Rasterizer configuration and I/O containers.

Port of ``gftorf_tpu/render/settings.py``:
 - ``CameraSpec``: per-camera tensors (matrices, intrinsics, near/far,
   depth_range) on the device the render runs on.
 - ``RasterConfig``: static configuration (image size, tile shape, buffer
   capacities, channel gates, dense or flat-stream layout).
 - ``RenderOutputs``: the rasterizer's outputs, the reference's tensor
   contract (rasterize_points.cu:80-98) minus its always-zero buffers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gftorf_tpu_torch.ops.transforms import camera_center, full_projection
from gftorf_tpu_torch.utils.runtime import resolve_device


class CameraSpec(NamedTuple):
    """Camera parameters for one rasterization pass (float32 tensors)."""

    viewmatrix: torch.Tensor  # (4,4) transposed world-to-view
    projmatrix: torch.Tensor  # (4,4) transposed full (view @ proj)
    campos: torch.Tensor  # (3,) camera center in world space
    tan_fovx: torch.Tensor  # scalar
    tan_fovy: torch.Tensor  # scalar
    focal_x: torch.Tensor  # scalar, pixels
    focal_y: torch.Tensor  # scalar, pixels
    znear: torch.Tensor  # scalar
    zfar: torch.Tensor  # scalar
    depth_range: torch.Tensor  # scalar; c/f of the ToF sensor

    @staticmethod
    def create(view_t, proj_t, width, height, fov_x, fov_y,
               znear=0.01, zfar=100.0, depth_range=100.0,
               device=None) -> "CameraSpec":
        """Build from a (transposed) view matrix and projection matrix.
        ``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        view_t = np.asarray(view_t, np.float32)
        proj_t = np.asarray(proj_t, np.float32)
        full = full_projection(view_t, proj_t)
        tan_x = np.tan(fov_x * 0.5)
        tan_y = np.tan(fov_y * 0.5)

        def f32(x):
            return torch.tensor(np.float32(x), device=dev)

        return CameraSpec(
            viewmatrix=torch.from_numpy(view_t).to(dev),
            projmatrix=torch.from_numpy(full).to(dev),
            campos=torch.from_numpy(camera_center(view_t)).to(dev),
            tan_fovx=f32(tan_x),
            tan_fovy=f32(tan_y),
            focal_x=f32(width / (2.0 * tan_x)),
            focal_y=f32(height / (2.0 * tan_y)),
            znear=f32(znear),
            zfar=f32(zfar),
            depth_range=f32(depth_range),
        )


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration (hashable)."""

    height: int
    width: int
    tile_h: int = 16
    tile_w: int = 16
    # Max depth-sorted instances composited per tile; deeper tiles are
    # truncated (reported via RenderOutputs.tile_overflow).
    max_per_tile: int = 1024
    # Capacity of the (gaussian, tile) duplicate list; 0 -> dup_factor * P.
    dup_capacity: int = 0
    dup_factor: int = 12
    sh_degree: int = 3  # max degree carried in the coefficient arrays
    use_view_dependent_phase: bool = False
    scale_modifier: float = 1.0
    # Tiles per step of the plain (CPU) compositor: bounds its
    # (tiles, PIX, L) temporaries.
    tile_chunk: int = 32
    # Flat sorted-stream compositor (render/kernels/flat.py): composite
    # the depth-sorted duplicate stream, each tile's rows in one aligned
    # segment, instead of the dense (T, max_per_tile) layout. Tile depth
    # is unbounded (tile_overflow is 0; max_per_tile is not read). The
    # port takes this path on either device: the Hopper kernels on a CUDA
    # tensor, their plain versions on a CPU tensor. The JAX package takes
    # it only on a TPU and renders dense on the CPU whatever the flag
    # says; both layouts compute the same function.
    flat_stream: bool = False
    # Static channel gates: when off, the RenderOutputs channel is exact
    # zeros and the compositor skips the work.
    need_dd: bool = True  # depth_distortion
    need_distribution: bool = True  # first-sample stats (forward.cu:561-567)

    def __post_init__(self):
        # Lane-aligned like the JAX package (settings.py:103-108), so both
        # packages give the same (T, L) layout for one config.
        aligned = -(-self.max_per_tile // 128) * 128
        if aligned != self.max_per_tile:
            object.__setattr__(self, "max_per_tile", aligned)

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def grid_h(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.grid_w * self.grid_h

    @property
    def tile_pixels(self) -> int:
        return self.tile_h * self.tile_w

    def capacity_for(self, num_points: int) -> int:
        if self.dup_capacity:
            return self.dup_capacity
        return max(1024, self.dup_factor * num_points)


class RenderOutputs(NamedTuple):
    """Rasterizer outputs (channel-first images like the reference)."""

    color: torch.Tensor  # (3, H, W)
    phasor: torch.Tensor  # (7, H, W) real/imag/amp + 4 quads
    depth: torch.Tensor  # (1, H, W) composited dist-to-light
    acc: torch.Tensor  # (1, H, W) accumulated alpha
    depth_distortion: torch.Tensor  # (1, H, W)
    distribution: torch.Tensor  # (3, H, W) first-sample (alpha, dist, amp)
    pixels: torch.Tensor  # (P, 1) touched-pixel counts
    radii: torch.Tensor  # (P,) int32 screen radius, 0 = culled
    num_rendered: torch.Tensor  # () int32 total duplicated instances
    dup_overflow: torch.Tensor  # () bool: duplicate capacity exceeded
    tile_overflow: torch.Tensor  # () int32 max instances dropped in a tile
    tile_max: torch.Tensor  # () int32 deepest tile occupancy (pre-clip)
    # Fused scene-flow channels (6, H, W) when flow_precomp was given.
    flow: Optional[torch.Tensor] = None
    # Duplicate-capacity sizing basis (single device: == num_rendered).
    rendered_worst: Optional[torch.Tensor] = None
