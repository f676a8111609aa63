"""Optical-flow geometry: backprojection and perspective flow projection.

Port of ``gftorf_tpu/ops/flow.py`` (the reference's scene/torf_utils.py:
80-124), used by the F-ToRF flow-supervision loss (train.py:243-261).
Matrices are in the transposed (row-vector) convention of the package:
the plain world-to-view matrix is ``view_t.T``.
"""

from __future__ import annotations

import torch


def distance_to_points3d(distance_map, view_t, fx, fy, cx, cy):
    """Backproject a (1, H, W) distance (not z-depth) map to (3, H, W)
    world points (torf_utils.py:80-93)."""
    h, w = distance_map.shape[1:]
    dev = distance_map.device
    u = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    ray = torch.sqrt(((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2 + 1.0)
    z = distance_map[0] / ray
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts_cam = torch.stack([x, y, z], dim=0).reshape(3, -1)  # (3, HW)
    c2w = torch.linalg.inv(view_t.T)  # world = inv(W2V) @ cam
    pts_w = c2w[:3, :3] @ pts_cam + c2w[:3, 3:4]
    return pts_w.reshape(3, h, w)


def project_points(points3d, view_t, intrinsics):
    """Project (3, H, W) world points to (2, H, W) pixel coordinates
    (torf_utils.py:100-107)."""
    h, w = points3d.shape[1:]
    flat = points3d.reshape(3, -1)
    cam = view_t.T[:3, :3] @ flat + view_t.T[:3, 3:4]
    hom = intrinsics @ cam
    return (hom[:2] / (hom[2:] + 1e-7)).reshape(2, h, w)


def project_flow(points2d_curr, points3d_curr, flow3d, view_t, intrinsics):
    """Perspectively project 3D scene flow to 2D optical flow
    (torf_utils.py:116-124)."""
    points2d_next = project_points(points3d_curr + flow3d, view_t, intrinsics)
    return points2d_next - points2d_curr


def intrinsics_matrix(fx, fy, cx, cy, device=None):
    """(3, 3) float32 pinhole intrinsics."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)
