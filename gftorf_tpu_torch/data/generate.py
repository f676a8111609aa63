"""Synthetic F-ToRF/ToRF dataset writer in the reference's on-disk layout.

Port of ``gftorf_tpu/data/generate.py``. It renders a procedurally built
Gaussian scene (optionally with a moving cluster) through the port's
``rasterize`` and writes the directory structure the readers expect
(dataset_readers.py:716-1003):

    color/0000.npy          (H, W, 3)
    tofType{0..3}/NNNN.npy  (H, W)      raw quads (one per frame slot)
    synthetic_tof/NNNN.npy  (H, W, 3)   real/imag/amp
    synthetic_depth/NNNN.npy(H, W)      distance to light
    forward_flow_2/flow_NNNN.npy (2, H, W)
    backward_flow_2/flow_NNNN.npy
    cams/{tof,color}_intrinsics.npy, {tof,color}_extrinsics.npy,
    cams/depth_range.npy, phase_offset.npy, dc_offset.npy

(``torf_layout``: color/, tof/, distance/ and cams/.)

The JAX package draws its ground-truth Gaussians with ``jax.random``,
which torch cannot reproduce, so the draw and the writer are split here:
``make_{gt,room,slide}_gaussians(generator)`` draw a scene as a dict of
tensors with the JAX package's keys, and ``write_dataset`` renders a given
dict ``g`` (for instance the one the JAX ``write_dataset`` returns), or
draws one from ``seed``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from gftorf_tpu_torch.ops.transforms import (
    focal2fov,
    projection_matrix_shift,
    world_to_view,
)
from gftorf_tpu_torch.render.rasterize import rasterize
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig
from gftorf_tpu_torch.utils.runtime import resolve_device


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _surface_grid(gen, z, x_half, y_half, spacing, color_freq=1.7):
    """A wall of overlapping opaque Gaussians at constant depth z with a
    smooth procedural texture. Returns (xyz, scales, opac, sh_dc, amp)."""
    nx = max(int(2 * x_half / spacing) + 1, 2)
    ny = max(int(2 * y_half / spacing) + 1, 2)
    gx, gy = torch.meshgrid(torch.linspace(-x_half, x_half, nx),
                            torch.linspace(-y_half, y_half, ny), indexing="xy")
    n = nx * ny
    jitter = 0.25 * spacing * torch.randn((n, 2), generator=gen)
    xyz = torch.stack([gx.reshape(-1) + jitter[:, 0], gy.reshape(-1) + jitter[:, 1],
                       torch.full((n,), float(z))], -1)
    scales = torch.full((n, 3), 0.85 * spacing)
    scales[:, 2] = 0.15 * spacing  # thin along depth
    opac = _uniform(gen, (n,), 0.88, 0.98)
    tex = 0.5 + 0.35 * torch.sin(color_freq * xyz[:, 0]) * torch.sin(
        color_freq * 1.3 * xyz[:, 1])
    sh_dc = tex[:, None] + 0.08 * torch.randn((n, 3), generator=gen)
    amp = 1.2 + 0.8 * tex + 0.05 * torch.randn((n,), generator=gen)
    return xyz, scales, opac, sh_dc, amp


def _assemble(parts, n_static, velocity, motion=None):
    """The scene dict of the JAX package's make_* functions from the
    (xyz, scales, opac, sh_dc, amp) parts; rows from ``n_static`` on move."""
    xyz, scales, opac, sh_dc, amp = (torch.cat(c) for c in zip(*parts))
    n = xyz.shape[0]
    quat = torch.zeros((n, 4))
    quat[:, 0] = 1.0
    shs = torch.zeros((n, 16, 3))
    shs[:, 0, :] = sh_dc
    shs_p = torch.zeros((n, 16, 2))
    shs_p[:, 0, 1] = amp
    dyn_mask = torch.arange(n) >= n_static
    vel = torch.where(dyn_mask[:, None], torch.tensor([velocity]), 0.0)
    g = dict(xyz=xyz, scales=scales, quat=quat, opac=opac, shs=shs,
             shs_p=shs_p, dyn_mask=dyn_mask, velocity=vel)
    if motion is not None:
        g["motion"] = motion
    return g


def make_room_gaussians(gen: torch.Generator, num_dynamic=2000):
    """A full-coverage scene: an opaque textured back wall filling the
    frustum, a half-width mid-depth wall (a depth edge), and a rigidly
    oscillating dynamic ball; GT surfels small enough that a faithful fit
    stays under the reference's 10 px screen-size prune at 320x240
    (make_room_gaussians of the JAX package)."""
    # frustum half-extents per unit depth for fx = fy = 0.9*W, H = 0.75*W
    xz, yz = 0.5 / 0.9, 0.375 / 0.9
    wall = _surface_grid(gen, 6.0, 1.08 * xz * 6.0, 1.08 * yz * 6.0, 0.065)
    half = _surface_grid(gen, 3.6, 1.05 * xz * 3.6, 1.05 * yz * 3.6, 0.04,
                         color_freq=2.6)
    keep = half[0][:, 0] < -0.25  # left-side wall only: depth edge
    half = tuple(a[keep] for a in half)
    nb = num_dynamic
    d = torch.randn((nb, 3), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    r = 0.45 * torch.rand((nb,), generator=gen) ** (1.0 / 3.0)
    ball = (torch.tensor([0.9, 0.1, 2.8]) + d * r[:, None],
            _uniform(gen, (nb, 3), 0.012, 0.024),
            _uniform(gen, (nb,), 0.85, 0.98),
            torch.tensor([1.1, 0.6, 0.4]) + 0.1 * torch.randn((nb, 3), generator=gen),
            1.8 + 0.2 * torch.randn((nb,), generator=gen))
    n_static = wall[0].shape[0] + half[0].shape[0]
    return _assemble([wall, half, ball], n_static, [0.3, 0.08, 0.15])


def make_slide_gaussians(gen: torch.Generator):
    """A sliding-occluder scene: an opaque textured back wall and a rigid
    dense cube translating linearly across the view (make_slide_gaussians
    of the JAX package)."""
    xz, yz = 0.5 / 0.9, 0.375 / 0.9
    wall = _surface_grid(gen, 6.0, 1.08 * xz * 6.0, 1.08 * yz * 6.0, 0.065)
    lin = torch.linspace(-0.35, 0.35, 13)
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="xy")
    cube = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    nb = cube.shape[0]
    cube = cube + 0.012 * torch.randn((nb, 3), generator=gen)
    parts = (torch.tensor([-0.9, 0.05, 3.2]) + cube,
             torch.full((nb, 3), 0.026),
             _uniform(gen, (nb,), 0.9, 0.98),
             torch.tensor([0.4, 0.9, 1.2]) + 0.1 * torch.randn((nb, 3), generator=gen),
             2.0 + 0.15 * torch.randn((nb,), generator=gen))
    return _assemble([wall, parts], wall[0].shape[0], [1.8, 0.0, 0.0],
                     motion="linear")


def make_gt_gaussians(gen: torch.Generator, num_static=384, num_dynamic=128):
    """Floating blobs in the frustum, the dynamic cluster oscillating
    (make_gt_gaussians of the JAX package)."""
    n = num_static + num_dynamic
    z = _uniform(gen, (n,), 2.0, 6.5)
    x = _uniform(gen, (n,), -0.5, 0.5) * z
    y = _uniform(gen, (n,), -0.4, 0.4) * z
    quat = torch.randn((n, 4), generator=gen)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    shs = 0.2 * torch.randn((n, 16, 3), generator=gen)
    shs[:, 0, :] += 1.0
    shs_p = torch.zeros((n, 16, 2))
    scales = _uniform(gen, (n, 3), 0.05, 0.25)
    opac = _uniform(gen, (n,), 0.6, 0.98)
    shs_p[:, 0, 1] = _uniform(gen, (n,), 1.0, 2.5)
    dyn_mask = torch.arange(n) >= num_static
    vel = torch.where(dyn_mask[:, None], torch.tensor([[0.3, 0.08, 0.15]]), 0.0)
    return dict(xyz=torch.stack([x, y, z], -1), scales=scales, quat=quat,
                opac=opac, shs=shs, shs_p=shs_p, dyn_mask=dyn_mask,
                velocity=vel)


def dynamic_disp(g, t: float):
    """Displacement field of the dynamic cluster at normalized t:
    sinusoidal oscillation (default) or linear translation ("slide")."""
    if g.get("motion") == "linear":
        return g["velocity"] * (t - 0.5)
    return g["velocity"] * torch.sin(torch.tensor(2.0 * math.pi * t,
                                                  dtype=torch.float32))


def write_dataset(
    out_dir: str,
    num_frames: int = 16,
    width: int = 64,
    height: int = 48,
    depth_range: float = 15.0,
    phase_offset: float = 0.0,
    dc_offset: float = 0.1,
    seed: int = 0,
    torf_layout: bool = False,
    layout: str = "blobs",
    static: bool = False,
    g: Optional[dict] = None,
    device=None,
):
    """Render and write a synthetic scene; returns the scene dict.
    num_frames should be a multiple of 4 for the quad cadence. ``g`` is a
    scene dict (arrays or tensors with the keys of ``make_gt_gaussians``);
    without it one is drawn from ``seed`` for ``layout``: "blobs"
    (floating Gaussians, cheap), "room" (full-coverage opaque surfaces) or
    "slide" (sliding rigid occluder, linear motion). static=True zeroes
    all motion. The renders run on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    if g is None:
        gen = torch.Generator().manual_seed(seed)
        g = {"room": make_room_gaussians, "slide": make_slide_gaussians}.get(
            layout, make_gt_gaussians)(gen)
    g = {k: (v if isinstance(v, str) else
             torch.as_tensor(np.array(v)).to(dev)) for k, v in g.items()}
    if static:
        g["velocity"] = torch.zeros_like(g["velocity"])
    n = g["xyz"].shape[0]

    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0
    fov_x, fov_y = focal2fov(fx, width), focal2fov(fy, height)
    znear, zfar = 0.05 * depth_range * 0.9, 0.55 * depth_range * 1.1
    view_t = world_to_view(np.eye(3), np.zeros(3))
    proj_t = projection_matrix_shift(znear, zfar, fx, fy, cx, cy, width,
                                     height, fov_x, fov_y)
    camera = CameraSpec.create(view_t, proj_t, width, height, fov_x, fov_y,
                               znear, zfar, depth_range, device=dev)
    config = RasterConfig(height=height, width=width, max_per_tile=2048)

    subs = (["color", "tof", "distance", "cams"] if torf_layout else
            ["color", "tofType0", "tofType1", "tofType2", "tofType3",
             "synthetic_tof", "synthetic_depth", "forward_flow_2",
             "backward_flow_2", "cams"])
    for sub in subs:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    bg = torch.zeros((7, height, width), device=dev)
    zeros2d = torch.zeros((n, 2), device=dev)

    def save(sub, name, arr):
        np.save(os.path.join(out_dir, sub, name), np.asarray(arr, np.float32))

    denom = max(num_frames - 1, 1)
    depths = {}
    with torch.no_grad():
        for fid in range(num_frames):
            xyz_t = g["xyz"] + dynamic_disp(g, fid / denom)
            out = rasterize(xyz_t, g["scales"], g["quat"], g["opac"], g["shs"],
                            g["shs_p"], phase_offset, dc_offset, zeros2d, bg,
                            camera=camera, config=config)
            color = out.color.movedim(0, -1).clamp(min=0).cpu().numpy()
            phasor = out.phasor.movedim(0, -1).cpu().numpy()
            depth = out.depth[0].cpu().numpy()
            depths[fid] = depth
            save("color", f"{fid:04d}.npy", color)
            if torf_layout:
                save("tof", f"{fid:04d}.npy", phasor[..., :3])
                save("distance", f"{fid:04d}.npy", depth)
            else:
                save("synthetic_tof", f"{fid:04d}.npy", phasor[..., :3])
                save("synthetic_depth", f"{fid:04d}.npy", depth)
                # The quad captured at this frame slot (desynchronized
                # cadence): slot k of the current group uses quad channel k.
                k = fid % 4
                save(f"tofType{k}", f"{fid:04d}.npy", phasor[..., 3 + k])

        if not torf_layout:
            # 2D flow between integration frames (fid -> fid+4), forward
            # and backward, from GT geometry via depth backprojection.
            from gftorf_tpu_torch.ops.flow import (
                distance_to_points3d,
                intrinsics_matrix,
                project_flow,
                project_points,
            )

            k_mat = intrinsics_matrix(fx, fy, cx, cy, device=dev)
            view = camera.viewmatrix
            for fid in range(0, num_frames, 4):
                pts3d = distance_to_points3d(
                    torch.as_tensor(depths[fid], device=dev)[None], view,
                    fx, fy, cx, cy)
                pts2d = project_points(pts3d, view, k_mat)
                for name, other in (("forward_flow_2", fid + 4),
                                    ("backward_flow_2", fid - 4)):
                    if not 0 <= other < num_frames:
                        continue
                    # Approximate scene flow: dynamic points move rigidly
                    # (all dynamic points share the displacement field).
                    disp = (dynamic_disp(g, other / denom)
                            - dynamic_disp(g, fid / denom))[-1].cpu().numpy()
                    moving = np.abs(depths[fid] - depths[other]) > 1e-3
                    flow3d = torch.as_tensor(np.where(
                        moving[None, :, :], disp[:, None, None], 0.0
                    ).astype(np.float32), device=dev)
                    flow2d = project_flow(pts2d, pts3d, flow3d, view, k_mat)
                    save(name, f"flow_{fid:04d}.npy", flow2d.cpu().numpy())

    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    exts = np.repeat(np.eye(4, dtype=np.float32)[None], num_frames, 0)
    for name, arr in (("tof_intrinsics", K), ("color_intrinsics", K),
                      ("tof_extrinsics", exts), ("color_extrinsics", exts),
                      ("depth_range", depth_range),
                      ("phase_offset", phase_offset),
                      ("dc_offset", dc_offset)):
        save("cams", f"{name}.npy", arr)
    return g
