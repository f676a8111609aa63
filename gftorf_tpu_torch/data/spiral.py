"""Spiral render-path synthesis for novel-view fly-throughs.

The port's own copy of ``gftorf_tpu/data/spiral.py`` (numpy only).

Produces the standard LLFF-family spiral around the average training
pose — the same camera-path family the reference uses
(scene/torf_utils.py:331-403, itself LLFF-derived public code). The
implementation here is vectorized over the whole path rather than a
per-pose loop: one (N, 4) offset matrix against the anchor pose gives
all camera centers, and a batched look-at assembles the poses.
"""

from __future__ import annotations

import numpy as np


def _unit(v, axis=-1, eps=1e-6):
    return v / (np.linalg.norm(v, axis=axis, keepdims=True) + eps)


def look_at(forward, up, pos):
    """Batched camera-to-world basis: rows of shape (..., 3) ->
    (..., 3, 4) poses with +z along `forward` (OpenCV convention)."""
    z = _unit(forward)
    x = _unit(np.cross(np.broadcast_to(up, z.shape), z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z, pos], axis=-1)


def average_pose(c2w_stack):
    """Anchor pose: mean center, summed view directions (3, 4)."""
    center = c2w_stack[:, :3, 3].mean(0)
    fwd = c2w_stack[:, :3, 2].sum(0)
    up = c2w_stack[:, :3, 1].sum(0)
    return look_at(fwd, up, center)


def get_render_poses_spiral(focal_length, bounds, poses, n_views=60,
                            n_rots=2, zrate=0.5):
    """Spiral of `n_views` camera-to-world poses around the average of
    `poses` ((N, 4, 4) or (N, 3, 4+) camera-to-world matrices).

    A negative `focal_length` picks the LLFF heuristic focus depth from
    the scene `bounds` (harmonic interpolation at dt=0.75). Matches the
    path family of torf_utils.py:352-403.
    """
    poses = np.asarray(poses, np.float64)
    if focal_length < 0:
        close, inf = bounds.min() * 0.9, bounds.max() * 5.0
        dt = 0.75
        focal_length = 1.0 / ((1.0 - dt) / close + dt / inf)

    anchor = average_pose(poses)
    up = _unit(poses[:, :3, 1].sum(0))

    # Path radii: 90th percentile of the camera spread per axis / 3
    # (falls back to unit spread for a single / coincident rig).
    tt = poses[:, :3, 3] - anchor[:3, 3]
    if np.sum(tt) < 1e-10:
        tt = np.ones((1, 3))
    radii = np.percentile(np.abs(tt), 90, axis=0) * np.ones(3) / 3.0

    theta = np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]
    offsets = np.stack(
        [np.sin(-theta), np.cos(-theta), np.sin(-theta * zrate),
         np.ones_like(theta)],
        axis=-1,
    ) * np.append(radii, 1.0)
    centers = offsets @ anchor[:3, :4].T  # (N, 3)
    focus = anchor[:3, :4] @ np.array([0.0, 0.0, focal_length, 1.0])
    forwards = focus[None] - centers

    out = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    out[:, :3, :4] = look_at(forwards, up, centers)
    return out


def recenter_poses(poses):
    """Re-express (N, 4, 4) c2w poses relative to their average pose.
    Returns (recentred poses, the inverse anchor transform)."""
    anchor = np.eye(4)
    anchor[:3, :4] = average_pose(poses[:, :3, :4])
    inv_anchor = np.linalg.inv(anchor)
    out = poses.copy()
    out[:, :3, :4] = (inv_anchor @ poses)[:, :3, :4]
    return out, inv_anchor
