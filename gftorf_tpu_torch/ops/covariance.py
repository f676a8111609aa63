"""3D covariance construction and EWA projection to screen space.

Port of ``gftorf_tpu/ops/covariance.py`` (the reference's
cuda_rasterizer/forward.cu:128-206), batched over Gaussians instead of
vmapped:

 - ``build_cov3d``: Sigma = (S R)^T (S R) from per-axis scales and an
   **unnormalized** quaternion (forward.cu:181; callers pass normalized
   rotations).
 - ``ewa_project_cov2d``: EWA Jacobian with the 1.3*tan(fov) clamp of the
   view-space point (``torch.clamp``, zero gradient outside the clamp like
   backward.cu:296-297) and the +0.3 px low-pass on the diagonal.
"""

from __future__ import annotations

import torch

# Low-pass filter added to the 2D covariance diagonal (forward.cu:164-165).
COV2D_LOWPASS = 0.3


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from quaternion (r, x, y, z); no normalization."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def build_cov3d(scale: torch.Tensor, scale_modifier, quat: torch.Tensor) -> torch.Tensor:
    """World-space covariance, upper-triangular packed (..., 6):
    [xx, xy, xz, yy, yz, zz] as in forward.cu:199-205."""
    R = quat_to_rotmat(quat)
    M = R * (scale_modifier * scale)[..., None, :]  # M = R diag(s)
    sigma = M @ M.transpose(-1, -2)
    return torch.stack(
        [
            sigma[..., 0, 0],
            sigma[..., 0, 1],
            sigma[..., 0, 2],
            sigma[..., 1, 1],
            sigma[..., 1, 2],
            sigma[..., 2, 2],
        ],
        dim=-1,
    )


def ewa_project_cov2d(t, cov3d, view_t, focal_x, focal_y, tan_fovx, tan_fovy):
    """Project (P, 6) 3D covariances to (P, 3) screen covariances
    [cov_xx, cov_xy, cov_yy] including the low-pass term
    (computeCov2D, forward.cu:128-167).

    Args:
        t: (P, 3) Gaussian means already in view space (callers sanitize
            culled points so tz != 0).
        view_t: (4, 4) transposed world-to-view matrix.
    """
    tz = t[..., 2]
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[..., 1] / tz, -lim_y, lim_y) * tz

    # J is the 2x3 Jacobian of the perspective projection at (tx, ty, tz).
    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    # view_t is stored transposed: U = J @ W^T has rows
    # u_a[k] = sum_i J[a, i] * W[k, i].
    W = view_t[:3, :3]
    u0 = j00[..., None] * W[:, 0] + j02[..., None] * W[:, 2]  # (P, 3)
    u1 = j11[..., None] * W[:, 1] + j12[..., None] * W[:, 2]

    c = cov3d
    sigma = torch.stack(
        [
            torch.stack([c[..., 0], c[..., 1], c[..., 2]], -1),
            torch.stack([c[..., 1], c[..., 3], c[..., 4]], -1),
            torch.stack([c[..., 2], c[..., 4], c[..., 5]], -1),
        ],
        dim=-2,
    )
    s_u0 = (sigma @ u0[..., None])[..., 0]
    s_u1 = (sigma @ u1[..., None])[..., 0]
    cov_xx = (u0 * s_u0).sum(-1) + COV2D_LOWPASS
    cov_xy = (u0 * s_u1).sum(-1)
    cov_yy = (u1 * s_u1).sum(-1) + COV2D_LOWPASS
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def conic_from_cov2d(cov2d: torch.Tensor):
    """Invert the 2x2 covariance; returns (conic (..., 3), det).

    conic = [a, b, c] such that power = -0.5(a dx^2 + c dy^2) - b dx dy.
    """
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    det_inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack(
        [cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv, cov2d[..., 0] * det_inv],
        dim=-1,
    )
    return conic, det


def screen_radius(cov2d: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """3-sigma screen radius from 2D covariance eigenvalues (forward.cu:334-337)."""
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return torch.ceil(3.0 * torch.sqrt(lambda1))
