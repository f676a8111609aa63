# Copied from gftorf_tpu_torch/data/analytic.py at commit 518578d (itself a copy of
# gftorf_tpu/data/analytic.py), unchanged above the ToRF capture writer at the end.
"""Analytic (rasterizer-independent) F-ToRF/ToRF ground-truth generator.

The port's own copy of ``gftorf_tpu/data/analytic.py`` (numpy only, no
change): the GT is deterministic, so both packages write byte-identical
scenes.

Ray-traces opaque parametric surfaces in closed form and synthesizes the
continuous-wave ToF measurement directly from exact ray distances via the
phasor model (reference scene/torf_utils.py:66-69 `tof_from_depth`; quad
channel definitions forward.cu:361-407) — the rasterizer is never
imported, so a model trained against this data is graded against ground
truth it cannot represent exactly. This is the non-circular counterpart
of data/generate.py (which renders GT through the repo's own splatting
kernels and therefore measures self-consistency, not capture parity).

Written layout matches data/generate.py / the reference's dataset readers
(dataset_readers.py:716-1003):

    color/NNNN.npy            (H, W, 3)
    tofType{0..3}/NNNN.npy    (H, W)      raw quad captured at slot fid%4
    synthetic_tof/NNNN.npy    (H, W, 3)   real/imag/amp phasor
    synthetic_depth/NNNN.npy  (H, W)      distance to (co-located) light
    forward_flow_2/flow_NNNN.npy (2, H, W), backward_flow_2/...
    cams/*.npy
    meta.json                  {"generator": "analytic", ...}

Scene vocabulary (mirrors the reference's capture taxonomy):
  "room"  — corrugated textured back wall + left half-wall (depth edge)
            + rigidly oscillating textured sphere    (ftorf, periodic)
  "slide" — back wall + sliding textured box         (ftorf, linear)
  static=True freezes all motion                     (torf-style capture)

Surfaces are opaque with sharp (checkerboard/stripe) albedo — content a
Gaussian mixture fits approximately, not exactly, which is what puts the
resulting PSNR in the regime real captures occupy.
"""

from __future__ import annotations

import json
import os

import numpy as np

_BALL_C0 = np.array([0.9, 0.1, 2.8])
_BALL_V = np.array([0.3, 0.08, 0.15])
_BALL_R = 0.45
_BOX_C0 = np.array([-0.9, 0.05, 3.2])
_BOX_V = np.array([1.8, 0.0, 0.0])
_BOX_HALF = 0.35
_WALL_Z = 6.0
_HALF_Z = 3.6
_HALF_XMAX = -0.25


def _dyn_center(layout: str, t: float, static: bool) -> np.ndarray:
    """Closed-form dynamic-object center at normalized time t (the same
    motion families as generate.py:204-209: sinusoidal / linear)."""
    if static:
        t = 0.0
    if layout == "slide":
        return _BOX_C0 + _BOX_V * (t - 0.5)
    return _BALL_C0 + _BALL_V * np.sin(2.0 * np.pi * t)


def _checker(x, y, scale):
    return ((np.floor(x * scale) + np.floor(y * scale)) % 2.0)


def _wall_albedo(x, y):
    """Sharp multi-scale texture on a wall: checkerboard + fine stripes +
    smooth tint. Hard edges are deliberately not band-limited in scene
    space — a splat mixture can only approximate them."""
    ck = _checker(x, y, 0.9)
    stripes = (np.sin(9.0 * x) > 0.55).astype(np.float64)
    base = 0.25 + 0.5 * ck + 0.15 * stripes
    r = base * (0.8 + 0.2 * np.sin(0.7 * x))
    g = base * (0.75 + 0.25 * np.cos(0.6 * y))
    b = 0.9 - 0.55 * base
    alb = np.stack([r, g, b], axis=-1)
    ir = 1.0 + 1.4 * ck + 0.3 * stripes  # IR albedo (ToF amplitude)
    return alb, ir


def _obj_albedo(p_local):
    """Texture on the dynamic object, in its rest frame (so the pattern
    rides with the rigid motion)."""
    x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
    ck = _checker(4.0 * x + 2.0 * z, 4.0 * y - z, 1.0)
    alb = np.stack(
        [0.9 - 0.35 * ck, 0.35 + 0.4 * ck, 0.25 + 0.2 * np.sin(8.0 * z)],
        axis=-1,
    )
    ir = 1.6 + 0.9 * ck
    return alb, ir


def _wall_height(x, y):
    """Depth displacement of the corrugated back wall (gentle curvature =>
    the GT depth field is not a constant plane)."""
    return 0.12 * np.sin(1.9 * x) * np.sin(1.4 * y) + 0.05 * np.sin(5.3 * x)


def _wall_height_grad(x, y):
    dhx = 0.228 * np.cos(1.9 * x) * np.sin(1.4 * y) + 0.265 * np.cos(5.3 * x)
    dhy = 0.168 * np.sin(1.9 * x) * np.cos(1.4 * y)
    return dhx, dhy


def _intersect_wall(u, v, z0, corrugate=False, newton_iters=8):
    """Ray o=0, d=(u,v,1) vs surface z = z0 + h(x,y). Solve for the ray
    parameter s (= hit z-coordinate) with Newton iterations; |dh| < 0.5
    and |u|,|v| < 0.65 keep g'(s) = 1 - dh·(u,v) comfortably positive, so
    this converges quadratically from s = z0."""
    s = np.full_like(u, z0)
    if corrugate:
        for _ in range(newton_iters):
            x, y = u * s, v * s
            g = s - z0 - _wall_height(x, y)
            dhx, dhy = _wall_height_grad(x, y)
            gp = 1.0 - dhx * u - dhy * v
            s = s - g / np.maximum(gp, 0.5)
    valid = np.ones_like(u, dtype=bool)
    return s, valid


def _intersect_sphere(u, v, c, r):
    """Smallest positive s with |s*d - c|^2 = r^2, d=(u,v,1)."""
    dd = u * u + v * v + 1.0
    dc = u * c[0] + v * c[1] + c[2]
    disc = dc * dc - dd * (np.dot(c, c) - r * r)
    ok = disc > 0.0
    root = np.sqrt(np.maximum(disc, 0.0))
    s = (dc - root) / dd  # nearer intersection
    ok = ok & (s > 0.0)
    return np.where(ok, s * 1.0, np.inf), ok


def _intersect_box(u, v, c, half):
    """Slab test for an AABB centered at c, half-extents `half` (scalar),
    rays o=0, d=(u,v,1). Returns entry parameter s."""
    lo = np.full_like(u, -np.inf)
    hi = np.full_like(u, np.inf)
    for axis, d in ((0, u), (1, v), (2, np.ones_like(u))):
        near, far = c[axis] - half, c[axis] + half
        parallel = np.abs(d) < 1e-12
        dd = np.where(parallel, 1.0, d)
        t1 = np.minimum(near / dd, far / dd)
        t2 = np.maximum(near / dd, far / dd)
        # parallel rays: unconstrained if the origin sits inside the
        # slab, a guaranteed miss otherwise
        miss = parallel & ~((near <= 0.0) & (0.0 <= far))
        lo = np.maximum(lo, np.where(parallel, np.where(miss, np.inf, -np.inf), t1))
        hi = np.minimum(hi, np.where(parallel, np.inf, t2))
    ok = (lo <= hi) & (lo > 0.0) & np.isfinite(lo)
    return np.where(ok, lo, np.inf), ok


def _sphere_normal(p, c):
    n = p - c
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)


def _box_normal(p, c, half):
    """Dominant-axis normal of the hit face."""
    q = (p - c) / half
    ax = np.argmax(np.abs(q), axis=-1)
    n = np.zeros_like(p)
    idx = np.indices(ax.shape)
    n[(*idx, ax)] = np.sign(np.take_along_axis(q, ax[..., None], -1))[..., 0]
    return n


def trace_frame(layout: str, t: float, u, v, static: bool = False):
    """Trace rays d=(u,v,1) from the origin through the scene at
    normalized time t. Returns dict of per-ray arrays: s (hit z), point
    (..., 3), normal, albedo (..., 3), ir (amplitude albedo), dynamic
    (bool mask of the moving object)."""
    c_dyn = _dyn_center(layout, t, static)

    hits = []  # (s, point_fn, surface_tag)
    s_wall, _ = _intersect_wall(u, v, _WALL_Z, corrugate=True)
    hits.append((s_wall, "wall"))

    if layout == "room":
        s_half, ok_half = _intersect_wall(u, v, _HALF_Z, corrugate=False)
        x_half = u * s_half
        ok_half = ok_half & (x_half < _HALF_XMAX)
        hits.append((np.where(ok_half, s_half, np.inf), "half"))
        s_dyn, _ = _intersect_sphere(u, v, c_dyn, _BALL_R)
        hits.append((s_dyn, "sphere"))
    elif layout == "slide":
        s_dyn, _ = _intersect_box(u, v, c_dyn, _BOX_HALF)
        hits.append((s_dyn, "box"))
    else:
        raise ValueError(f"unknown analytic layout: {layout}")

    s_all = np.stack([h[0] for h in hits])
    which = np.argmin(s_all, axis=0)
    s = np.min(s_all, axis=0)
    point = np.stack([u * s, v * s, s], axis=-1)

    albedo = np.zeros(point.shape[:-1] + (3,))
    ir = np.zeros(point.shape[:-1])
    normal = np.zeros_like(point)
    dynamic = np.zeros(point.shape[:-1], dtype=bool)
    for i, (_, tag) in enumerate(hits):
        m = which == i
        if tag in ("wall", "half"):
            a, irr = _wall_albedo(point[..., 0], point[..., 1])
            if tag == "half":  # distinct tint so the mid wall reads
                a = a[..., ::-1] * 0.9
                irr = irr * 0.8
            n = np.zeros_like(point)
            n[..., 2] = -1.0
        else:
            a, irr = _obj_albedo(point - c_dyn)
            if tag == "sphere":
                n = _sphere_normal(point, c_dyn)
            else:
                n = _box_normal(point, c_dyn, _BOX_HALF)
            dynamic |= m
        albedo[m] = a[m]
        ir[m] = irr[m]
        normal[m] = n[m]
    return dict(s=s, point=point, normal=normal, albedo=albedo, ir=ir,
                dynamic=dynamic, c_dyn=c_dyn)


def _shade(tr, u, v):
    """Headlight Lambertian shading + exact ToF quantities.

    distance-to-light = |point| (sensor and illuminator co-located at the
    origin, matching the rasterizer's dist_to_light and the reference's
    forward.cu:361-371). Amplitude follows the same inverse-square model
    the phasor channels use (ops/tof.py:62)."""
    d = np.stack([u, v, np.ones_like(u)], axis=-1)
    dhat = d / np.linalg.norm(d, axis=-1, keepdims=True)
    lam = np.maximum(-np.sum(tr["normal"] * dhat, axis=-1), 0.0)
    shade = 0.25 + 0.75 * lam
    color = tr["albedo"] * shade[..., None]
    dist = np.linalg.norm(tr["point"], axis=-1)
    amp = tr["ir"] * shade / np.maximum(dist * dist, 1e-9)
    return color, dist, amp


def render_frame_analytic(layout, t, width, height, fx, fy, cx, cy,
                          depth_range, phase_offset, dc_offset,
                          static=False, ss=3):
    """One frame of exact GT, supersampled ss x ss per pixel (the sensor
    integrates over the pixel footprint; phasors average linearly the way
    real correlation samples do). Returns dict: color (H,W,3),
    phasor (H,W,3), quads (H,W,4), dist (H,W), dynamic (H,W) bool,
    c_dyn (3,)."""
    js = (np.arange(width)[None, :, None, None]
          + (np.arange(ss)[None, None, :, None] + 0.5) / ss)
    is_ = (np.arange(height)[:, None, None, None]
           + (np.arange(ss)[None, None, None, :] + 0.5) / ss)
    u = (js - cx) / fx + 0.0 * is_
    v = (is_ - cy) / fy + 0.0 * js
    tr = trace_frame(layout, t, u, v, static=static)
    color, dist, amp = _shade(tr, u, v)

    phase = dist * (4.0 * np.pi / depth_range) + phase_offset
    cp, sp = np.cos(phase), np.sin(phase)
    phasor = np.stack([amp * cp, amp * sp, amp], axis=-1)
    quads = np.stack(
        [amp * (cp + dc_offset), amp * (-cp + dc_offset),
         amp * (sp + dc_offset), amp * (-sp + dc_offset)], axis=-1)

    return dict(
        color=color.mean(axis=(2, 3)),
        phasor=phasor.mean(axis=(2, 3)),
        quads=quads.mean(axis=(2, 3)),
        dist=dist.mean(axis=(2, 3)),
        dynamic=tr["dynamic"].any(axis=(2, 3)),
        c_dyn=tr["c_dyn"],
    )


def write_dataset(
    out_dir: str,
    layout: str = "room",
    num_frames: int = 60,
    width: int = 320,
    height: int = 240,
    depth_range: float = 15.0,
    phase_offset: float = 0.0,
    dc_offset: float = 0.1,
    seed: int = 0,  # kept for CLI symmetry; the GT is deterministic
    torf_layout: bool = False,
    static: bool = False,
    supersample: int = 3,
):
    """Write an analytic-GT scene in the reference's on-disk layout.
    Signature mirrors data/generate.py:write_dataset so campaign scripts
    can switch generators."""
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0

    subs = (["color", "tofType0", "tofType1", "tofType2", "tofType3",
             "synthetic_tof", "synthetic_depth", "forward_flow_2",
             "backward_flow_2", "cams"] if not torf_layout
            else ["color", "tof", "distance", "cams"])
    for sub in subs:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    denom = max(num_frames - 1, 1)
    frames = {}
    for fid in range(num_frames):
        t = fid / denom
        fr = render_frame_analytic(
            layout, t, width, height, fx, fy, cx, cy, depth_range,
            phase_offset, dc_offset, static=static, ss=supersample)
        frames[fid] = fr
        np.save(os.path.join(out_dir, "color", f"{fid:04d}.npy"),
                fr["color"].astype(np.float32))
        if torf_layout:
            np.save(os.path.join(out_dir, "tof", f"{fid:04d}.npy"),
                    fr["phasor"].astype(np.float32))
            np.save(os.path.join(out_dir, "distance", f"{fid:04d}.npy"),
                    fr["dist"].astype(np.float32))
        else:
            np.save(os.path.join(out_dir, "synthetic_tof",
                                 f"{fid:04d}.npy"),
                    fr["phasor"].astype(np.float32))
            np.save(os.path.join(out_dir, "synthetic_depth",
                                 f"{fid:04d}.npy"),
                    fr["dist"].astype(np.float32))
            k = fid % 4  # desynchronized quad cadence, as generate.py:298
            np.save(os.path.join(out_dir, f"tofType{k}", f"{fid:04d}.npy"),
                    fr["quads"][..., k].astype(np.float32))

    if not torf_layout:
        _write_flow(out_dir, layout, frames, num_frames, denom, static,
                    fx, fy, cx, cy)

    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    exts = np.repeat(np.eye(4, dtype=np.float32)[None], num_frames, 0)
    cams = os.path.join(out_dir, "cams")
    np.save(os.path.join(cams, "tof_intrinsics.npy"), K)
    np.save(os.path.join(cams, "color_intrinsics.npy"), K)
    np.save(os.path.join(cams, "tof_extrinsics.npy"), exts)
    np.save(os.path.join(cams, "color_extrinsics.npy"), exts)
    np.save(os.path.join(cams, "depth_range.npy"),
            np.array(depth_range, np.float32))
    np.save(os.path.join(cams, "phase_offset.npy"),
            np.array(phase_offset, np.float32))
    np.save(os.path.join(cams, "dc_offset.npy"),
            np.array(dc_offset, np.float32))

    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({
            "generator": "analytic",
            "layout": layout,
            "static": static,
            "num_frames": num_frames,
            "width": width, "height": height,
            "depth_range": depth_range,
            "phase_offset": phase_offset, "dc_offset": dc_offset,
            "supersample": supersample,
        }, f, indent=1)


def _write_flow(out_dir, layout, frames, num_frames, denom, static,
                fx, fy, cx, cy):
    """Exact 2D optical flow between integration frames (fid -> fid±4):
    dynamic-object pixels translate rigidly by the known center motion;
    everything else is zero (the camera is static)."""
    for fid in range(0, num_frames, 4):
        fr = frames[fid]
        h, w = fr["dist"].shape
        ys, xs = np.meshgrid(np.arange(float(h)), np.arange(float(w)),
                             indexing="ij")
        u = (xs + 0.5 - cx) / fx
        v = (ys + 0.5 - cy) / fy
        # backproject the pixel's GT distance to the 3D point
        norm = np.sqrt(u * u + v * v + 1.0)
        z = fr["dist"] / norm
        p = np.stack([u * z, v * z, z], axis=-1)
        for name, other in (("forward_flow_2", fid + 4),
                            ("backward_flow_2", fid - 4)):
            if not (0 <= other < num_frames):
                continue
            dc = (_dyn_center(layout, other / denom, static)
                  - _dyn_center(layout, fid / denom, static))
            p2 = p + np.where(fr["dynamic"][..., None], dc[None, None], 0.0)
            x2 = p2[..., 0] / p2[..., 2] * fx + cx - 0.5
            y2 = p2[..., 1] / p2[..., 2] * fy + cy - 0.5
            flow = np.stack([x2 - xs, y2 - ys], axis=0)
            np.save(os.path.join(out_dir, name, f"flow_{fid:04d}.npy"),
                    flow.astype(np.float32))


def write_torf_capture(out_dir: str, layout: str = "room", num_frames: int = 30,
                       width: int = 320, height: int = 240,
                       depth_range: float = 10.0, color_scale: int = 2,
                       static: bool = True, supersample: int = 3):
    """An analytic scene in a real ToRF capture's layout, as
    ``chip_smoke.py::write_trainer_datasets`` writes one at commit 518578d:
    ToF at ``width`` x ``height``, colour rendered at ``color_scale`` times
    that (a config reads it back at ``1 / color_scale``), the intrinsics as
    ``.mat`` files, and a colour camera offset from the ToF camera by
    ``relative_pose.npy`` (two cameras a step)."""
    import scipy.io

    write_dataset(out_dir, layout=layout, num_frames=num_frames, width=width,
                  height=height, depth_range=depth_range, torf_layout=True,
                  static=static, supersample=supersample)
    cw, ch = color_scale * width, color_scale * height
    fx = fy = 0.9 * cw
    denom = max(num_frames - 1, 1)
    for fid in range(num_frames):
        fr = render_frame_analytic(layout, fid / denom, cw, ch, fx, fy,
                                   cw / 2.0, ch / 2.0, depth_range, 0.0, 0.1,
                                   static=static, ss=supersample)
        np.save(os.path.join(out_dir, "color", f"{fid:04d}.npy"),
                fr["color"].astype(np.float32))
    cams = os.path.join(out_dir, "cams")
    k_color = np.array([[fx, 0, cw / 2.0], [0, fy, ch / 2.0], [0, 0, 1]],
                       np.float32)
    for name, k in (("tof_intrinsics",
                     np.load(os.path.join(cams, "tof_intrinsics.npy"))),
                    ("color_intrinsics", k_color)):
        scipy.io.savemat(os.path.join(cams, f"{name}.mat"), {"K": k})
        os.remove(os.path.join(cams, f"{name}.npy"))
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.05, 0.0, 0.0]
    np.save(os.path.join(cams, "relative_pose.npy"), rel)
