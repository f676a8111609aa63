"""Camera/projection transforms (port of ``gftorf_tpu/ops/transforms.py``).

Conventions follow the reference exactly (utils/graphics_utils.py:35-115):
matrices are stored **transposed** so a point transforms as ``p_h @ M``;
the projection maps z to [0, 1]; ``ndc2pix(v, S) = ((v + 1) * S - 1) / 2``
(cuda_rasterizer/auxiliary.h:44-47). The matrix builders are host numpy;
the point transforms work on torch tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R, t, translate=(0.0, 0.0, 0.0), scale=1.0) -> np.ndarray:
    """World-to-view matrix, already transposed for right-multiplication
    (getWorld2View2, graphics_utils.py:42-53). R is the camera-to-world
    rotation (COLMAP convention), t the world-to-camera translation."""
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + np.asarray(translate)) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return Rt.T.astype(np.float32)


def projection_matrix(znear, zfar, fov_x, fov_y) -> np.ndarray:
    """Perspective projection (transposed), z mapped to [0,1]."""
    tan_x = math.tan(fov_x * 0.5)
    tan_y = math.tan(fov_y * 0.5)
    return _frustum(znear, zfar, -tan_x * znear, tan_x * znear,
                    -tan_y * znear, tan_y * znear)


def projection_matrix_shift(znear, zfar, focal_x, focal_y, cx, cy,
                            width, height, fov_x, fov_y) -> np.ndarray:
    """Principal-point-shifted perspective projection (transposed),
    getProjectionMatrixShift (graphics_utils.py:77-109)."""
    tan_x = math.tan(fov_x * 0.5)
    tan_y = math.tan(fov_y * 0.5)
    top = tan_y * znear
    right = tan_x * znear
    offset_x = (cx - width / 2) / focal_x * znear
    offset_y = (cy - height / 2) / focal_y * znear
    return _frustum(znear, zfar, -right + offset_x, right + offset_x,
                    -top + offset_y, top + offset_y)


def _frustum(znear, zfar, left, right, bottom, top) -> np.ndarray:
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.T.astype(np.float32)


def full_projection(view_t: np.ndarray, proj_t: np.ndarray) -> np.ndarray:
    """Combined transform: p_h @ view_t @ proj_t."""
    return (view_t @ proj_t).astype(np.float32)


def camera_center(view_t: np.ndarray) -> np.ndarray:
    """Camera position in world space from the transposed W2V matrix."""
    return np.linalg.inv(np.asarray(view_t, dtype=np.float64))[3, :3].astype(
        np.float32
    )


def fov2focal(fov, pixels):
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal, pixels):
    return 2.0 * math.atan(pixels / (2.0 * focal))


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] to pixel coordinate (auxiliary.h:44-47)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def transform_point_4x3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Affine transform of (..., 3) points by a transposed 4x4 matrix."""
    return p @ m[:3, :3] + m[3, :3]


def transform_point_4x4(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform of (..., 3) points; returns (..., 4)."""
    return p @ m[:3, :4] + m[3, :4]
