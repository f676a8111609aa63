#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gftorf_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure:

1. build    nvcc builds every kernel of the serving path from
            gftorf_tpu_torch/csrc/ (into build/kernels/); prints the build
            seconds, ptxas' register/shared-memory report and the card.
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, on seeded synthetic tile blocks: full width (150 tiles of
            16x32 pixels, L = 1024 and 2048) and a ragged 250x180 image
            with 16x16 tiles; dd/distribution gates on and off; flow
            present and absent; per-tile counts of 0, partial and full.
            Tolerance atol 2e-5, rtol 1e-4 on every output column;
            contributing-pixel counts equal up to 1e-4 of the lanes (the
            lanes whose transmittance lies within ulps of T_STOP).
3. serve    the main path: eval_frame on a 100,000-Gaussian model (half of
            it dynamic) with the full-width deform MLP (D=8, W=256), drawn
            from a seed. ftorf: 8 frames at 320x240, single camera, lerp
            frames included. torf: 4 frames, two 320x240 cameras. Cameras
            are spiral poses. Launch counts are zeroed just before and read
            just after; every output must be finite, no tile may overflow.
            A 4,000-Gaussian frame of each scene must also agree with the
            CPU path (plain compositor) at atol 1e-4, rtol 1e-3.
4. determinism  the same frame rendered twice is bitwise equal.
5. timing   each kernel at the serving shapes (CUDA events), its plain
            version, and the least time the card could take for the same
            work (bytes over 3.35 TB/s, fp32 operations over 67 TFLOP/s,
            counted from this run's data).

``python3 chip_smoke.py --profile`` adds a breakdown of a served frame by
stage and a torch.profiler trace (under build/profile/) with the device's
busy share; without arguments the script runs the five phases only.

The second-to-last line is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Published peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations the kernel does per (pixel, instance) pair it evaluates
# (offset, conic power, exp, clamps, tests) and per contributing pair
# (transmittance, 17 weighted channels, acc), plus the dd moments.
OPS_EVAL, OPS_CONTRIB, OPS_DD = 16, 41, 12
ATOL, RTOL, CONTRIB_FRAC = 2e-5, 1e-4, 1e-4
E2E_ATOL, E2E_RTOL = 1e-4, 1e-3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1


def phase_build():
    from gftorf_tpu_torch.render.kernels import build

    t0 = time.perf_counter()
    built = build.build(["dense_forward"])
    secs = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    print(card_line(), flush=True)
    log("build", f"ok: {sorted(built) or 'cached'} in {secs:.2f} s")


# ---------------------------------------------------------------- phase 2


def synthetic_tiles(rng, config, L, flow, device):
    """Seeded (feat_tl, bg_tiles, counts, origins) at one config: depth-
    sorted Gaussians around each tile, opacity ceilings that let some
    tiles saturate (early exit) and others stay translucent, counts of
    0, partial and L. Lanes at or past a tile's count are NaN, so any
    read of them shows in the output."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels.dense import _bg_to_tiles, _default_origins

    T = config.num_tiles
    th, tw = config.tile_h, config.tile_w
    origins = _default_origins(T, config, "cpu").numpy()
    counts = rng.integers(1, L + 1, T)
    counts[::7] = 0
    counts[1::7] = L
    shape = (T, L)
    mx = origins[:, :1] + rng.uniform(-8, tw + 8, shape)
    my = origins[:, 1:] + rng.uniform(-8, th + 8, shape)
    sx = np.exp(rng.uniform(np.log(0.7), np.log(8.0), shape))
    sy = np.exp(rng.uniform(np.log(0.7), np.log(8.0), shape))
    rho = rng.uniform(-0.8, 0.8, shape)
    a, b, c = sx * sx + 0.3, rho * sx * sy, sy * sy + 0.3
    det = a * c - b * b
    omax = rng.choice([0.05, 0.3, 0.99], (T, 1))
    dist = np.sort(rng.uniform(1.0, 10.0, shape), axis=1)
    cols = [mx, my, c / det, -b / det, a / det,
            rng.uniform(0.01, 1.0, shape) * omax, dist / 10.0]
    cols += [rng.uniform(0, 1, shape) for _ in range(3)] + [dist]
    cols += [rng.normal(size=shape) for _ in range(7)]
    cols += [rng.normal(size=shape) if flow else np.zeros(shape)
             for _ in range(6)]
    feat = np.stack(cols, -1).astype(np.float32)
    feat[np.arange(L)[None, :] >= counts[:, None]] = np.nan
    bg = rng.uniform(0, 1, (7, config.height, config.width)).astype(np.float32)
    return (torch.tensor(feat, device=device),
            _bg_to_tiles(torch.tensor(bg), T, config).to(device),
            torch.tensor(counts, dtype=torch.int32, device=device),
            torch.tensor(origins, device=device))


def compare(out, contrib, ref_out, ref_contrib, what):
    """Kernel against plain: max |err|; raises past the tolerance."""
    import torch

    if not (torch.isfinite(out).all() and torch.isfinite(contrib).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (out - ref_out).abs()
    bad = int((err > ATOL + RTOL * ref_out.abs()).sum())
    lanes = int((contrib != ref_contrib).sum())
    if bad or lanes > CONTRIB_FRAC * contrib.numel():
        raise AssertionError(
            f"{what}: {bad} outputs past atol {ATOL} rtol {RTOL} (max "
            f"{float(err.max()):.3g}); {lanes} contrib lanes differ")
    return float(err.max()), lanes


def phase_kernels(device):
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense
    from gftorf_tpu_torch.render.settings import RasterConfig

    rng = np.random.default_rng(SEED)
    worst = 0.0
    cases = []
    for gates in (True, False):
        for flow in (True, False):
            full = dict(height=240, width=320, tile_h=16, tile_w=32,
                        need_dd=gates, need_distribution=gates)
            cases.append((RasterConfig(max_per_tile=1024, **full), flow))
            cases.append((RasterConfig(max_per_tile=2048, **full), flow))
            cases.append((RasterConfig(height=180, width=250, tile_h=16,
                                       tile_w=16, max_per_tile=512,
                                       need_dd=gates, need_distribution=gates),
                          flow))
    for cfg, flow in cases:
        args = synthetic_tiles(rng, cfg, cfg.max_per_tile, flow, device)
        out, contrib = dense.composite_forward_cuda(*args, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(*args, cfg)
        torch.cuda.synchronize()
        what = (f"{cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w} "
                f"L={cfg.max_per_tile} gates={cfg.need_dd} flow={flow}")
        err, lanes = compare(out, contrib, ref_out, ref_contrib, what)
        worst = max(worst, err)
        log("kernels", f"{what}: max_abs_err {err:.3g}, contrib lanes "
            f"differing {lanes} of {contrib.numel()}")
    log("kernels", f"ok: {len(cases)} cases, max_abs_err {worst:.3g}")
    return worst


# ---------------------------------------------------------------- phase 3


def spiral_cameras(n_views, size_color, size_tof, depth_range, seed,
                   baseline, device):
    """(color, tof) CameraSpec pairs along a spiral around a small rig at
    the origin looking down +z; the ToF camera sits ``baseline`` to the
    side of the color camera (0 = one shared camera). Sizes are (W, H)."""
    import numpy as np

    from gftorf_tpu_torch.data.spiral import get_render_poses_spiral
    from gftorf_tpu_torch.ops.transforms import projection_matrix, world_to_view
    from gftorf_tpu_torch.render.settings import CameraSpec

    rng = np.random.default_rng(seed)
    rig = np.tile(np.eye(4), (4, 1, 1))
    rig[:, :3, 3] = 0.1 * rng.normal(size=(4, 3))
    poses = get_render_poses_spiral(5.0, None, rig, n_views=n_views, n_rots=1)

    def spec(c2w, size):
        width, height = size
        fov_x = 0.9
        fov_y = 2.0 * np.arctan(np.tan(fov_x / 2) * height / width)
        R = c2w[:3, :3]
        t = -R.T @ c2w[:3, 3]
        return CameraSpec.create(
            world_to_view(R, t), projection_matrix(0.1, 50.0, fov_x, fov_y),
            width, height, fov_x, fov_y, 0.1, 50.0, depth_range, device=device)

    out = []
    for c2w in poses.astype(np.float64):
        tof = c2w.copy()
        tof[:3, 3] += baseline * c2w[:3, 0]
        out.append((spec(c2w, size_color), spec(tof, size_tof)))
    return out


def serve_model(n, seed, device):
    """A seeded scene of n Gaussians in front of the rig: the first half
    dynamic (seg_color red), so the rows are in the compact layout."""
    import numpy as np

    from gftorf_tpu_torch.weights import gaussian_params_from_numpy

    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 9.0, n)
    quat = rng.normal(size=(n, 4))
    opac = rng.uniform(0.05, 0.95, n)
    sh_p = 0.2 * rng.normal(size=(n, 16, 2))
    sh_p[:, 0, 1] += 1.0
    seg = np.zeros((n, 3))
    seg[: n // 2, 0] = 1.0
    return gaussian_params_from_numpy(dict(
        xyz=np.stack([rng.uniform(-0.5, 0.5, n) * z,
                      rng.uniform(-0.4, 0.4, n) * z, z], -1),
        sh_color=0.3 * rng.normal(size=(n, 16, 3)),
        sh_phase=sh_p[..., 0], sh_amp=sh_p[..., 1],
        scaling=np.log(rng.uniform(0.005, 0.04, (n, 3))),
        rotation=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        opacity=np.log(opac / (1.0 - opac))[:, None],
        seg_color=seg, phase_offset=np.zeros(1), dc_offset=np.zeros(1),
    ), device=device)


class Scene:
    """One served scene: config file, model, deform MLP, statics, frames."""

    def __init__(self, name, n_frames, n_points, device, max_per_tile=None):
        import torch

        from gftorf_tpu_torch.config import Config
        from gftorf_tpu_torch.models.deform import DeformConfig, init_deform
        from gftorf_tpu_torch.render.settings import RasterConfig
        from gftorf_tpu_torch.train.step import FrameData, StepStatic

        cfg = Config.from_json(os.path.join(ROOT, "configs", f"{name}.json"))
        m, opt, tpu = cfg.model, cfg.opt, cfg.tpu
        self.name = name
        self.device = device
        self.n_points = n_points or m.num_points
        single = name == "ftorf"
        size_c = (int(m.color_image_width * m.color_scale_factor),
                  int(m.color_image_height * m.color_scale_factor))
        size_t = (int(m.tof_image_width * m.tof_scale_factor),
                  int(m.tof_image_height * m.tof_scale_factor))
        # The Trainer's eval gates (ftorf) and the renderer's defaults (torf),
        # so the serving path runs both gate sets of the kernel.
        gates = not single

        def raster(size):
            return RasterConfig(
                height=size[1], width=size[0], tile_h=tpu.tile_h,
                tile_w=tpu.tile_w, max_per_tile=max_per_tile or tpu.max_per_tile,
                dup_factor=tpu.dup_factor, sh_degree=m.sh_degree,
                need_dd=gates, need_distribution=gates)

        dcfg = DeformConfig(depth=m.D, width=m.W, xyz_multires=m.xyz_multires,
                            t_multires=m.t_multires, sh_degree=m.sh_degree)
        n_dyn = self.n_points // 2
        self.static = StepStatic(
            scene_type=name, config_color=raster(size_c),
            config_tof=raster(size_t), deform=dcfg,
            active_sh_degree=m.sh_degree, total_num_views=m.total_num_views,
            render_regions=("static", "dynamic"), dynamic_on=True,
            use_quad=opt.use_quad, num_phasor_channels=opt.num_phasor_channels,
            optimize_phase_offset=opt.optimize_phase_offset,
            optimize_dc_offset=opt.optimize_dc_offset, scene_extent=5.0,
            single_camera=single, compact_layout=True,
            deform_bucket=1 << (n_dyn - 1).bit_length(),
            deform_clip=tpu.deform_clip,
        )
        seed = SEED + (0 if single else 1)
        self.params = serve_model(self.n_points, seed, device)
        self.alive = torch.ones(self.n_points, dtype=torch.bool, device=device)
        self.deform = init_deform(
            dcfg, torch.Generator().manual_seed(seed), device=device).eval()
        cams = spiral_cameras(n_frames, size_c, size_t, m.depth_range, seed,
                              0.0 if single else 0.05, device)
        gen = torch.Generator().manual_seed(seed)

        def rand(*shape):
            return torch.rand(shape, generator=gen).to(device)

        (wc, hc), (wt, ht) = size_c, size_t
        self.frames = []
        for fid, (cam_c, cam_t) in enumerate(cams):
            self.frames.append(FrameData(
                frame_id=torch.tensor(fid, dtype=torch.int32),
                cam_color=cam_c, cam_tof=cam_t, gt_image=rand(3, hc, wc),
                gt_phasor=rand(3, ht, wt), gt_quad=rand(4, ht, wt),
                gt_distance=1.0 + 8.0 * rand(1, ht, wt),
                forward_flow=rand(2, ht, wt), backward_flow=rand(2, ht, wt),
                has_forward_flow=torch.tensor(False),
                has_backward_flow=torch.tensor(False),
                phase_offset=torch.tensor(0.1, device=device),
                dc_offset=torch.tensor(0.02, device=device),
                intrinsics_tof=torch.eye(3, device=device),
                intrinsics_color=torch.eye(3, device=device)))
        self.rasterize_calls = 0

    def grow(self, tile_max):
        """Grow max_per_tile past the deepest tile, as the Trainer does on
        overflow (the frame is then rendered again)."""
        cap = -(-int(tile_max * 1.25) // 128) * 128
        st = self.static
        self.static = dataclasses.replace(
            st, config_color=dataclasses.replace(st.config_color, max_per_tile=cap),
            config_tof=dataclasses.replace(st.config_tof, max_per_tile=cap))

    def render(self, fid, device=None):
        from gftorf_tpu_torch.train.evaluate import eval_frame

        self.rasterize_calls += 1 if self.static.single_camera else 2
        return eval_frame(self.static, self.params, self.deform, self.alive,
                          self.frames[fid], device=device)

    def to_cpu(self):
        """The same scene on the CPU (the plain compositor's path)."""
        import copy

        import torch

        cpu = copy.copy(self)
        cpu.device = torch.device("cpu")
        cpu.params = type(self.params)(*(t.cpu() for t in self.params))
        cpu.alive = self.alive.cpu()
        cpu.deform = copy.deepcopy(self.deform).cpu()

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.cpu()
            if isinstance(x, tuple):
                return type(x)(*(move(v) for v in x))
            return x

        cpu.frames = [move(f) for f in self.frames]
        return cpu


def outputs_of(metrics, out_color, out_tof):
    """Every tensor a served frame produces, by name."""
    tensors = {f"metric/{k}": v for k, v in metrics.items()}
    for tag, out in (("color", out_color), ("tof", out_tof)):
        for k, v in out._asdict().items():
            if v is not None:
                tensors[f"{tag}/{k}"] = v
    return tensors


def check_frame(scene, fid, result):
    import torch

    _, out_c, out_t = result
    for out in (out_c, out_t):
        if int(out.tile_overflow) != 0 or bool(out.dup_overflow):
            raise AssertionError(f"{scene.name} frame {fid}: buffers overflow")
    for k, v in outputs_of(*result).items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{scene.name} frame {fid}: {k} not finite")
    h, w = scene.static.config_tof.height, scene.static.config_tof.width
    if tuple(out_t.color.shape) != (3, h, w) or tuple(out_t.phasor.shape) != (7, h, w):
        raise AssertionError(f"{scene.name}: output shapes {out_t.color.shape}")
    if float(out_t.acc.max()) <= 0.5:
        raise AssertionError(f"{scene.name} frame {fid}: nothing in view")


def serve(scene):
    """Warm-up pass (growing max_per_tile on overflow), then a timed pass;
    returns the per-frame milliseconds and the last frame's outputs."""
    import torch

    for fid in range(len(scene.frames)):
        out = scene.render(fid)
        worst = max(int(o.tile_max) for o in out[1:])
        if any(int(o.tile_overflow) for o in out[1:]):
            scene.grow(worst)
            out = scene.render(fid)
        check_frame(scene, fid, out)
    times = []
    for fid in range(len(scene.frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scene.render(fid)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check_frame(scene, fid, out)
    return times, out


def phase_serve(device):
    import torch

    from gftorf_tpu_torch.render.kernels import dense

    scenes = [Scene("ftorf", 8, 0, device), Scene("torf", 4, 0, device)]
    dense.composite_forward_cuda.launches = 0
    results = [serve(s) for s in scenes]
    launches = dense.composite_forward_cuda.launches
    calls = sum(s.rasterize_calls for s in scenes)
    if launches != calls or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {calls} rasterize calls")
    for s, (times, out) in zip(scenes, results):
        _, _, out_t = out
        log("serve", f"{s.name}: {len(times)} frames of "
            f"{s.static.config_tof.width}x{s.static.config_tof.height} "
            f"({'1 camera' if s.static.single_camera else '2 cameras'}), "
            f"{s.n_points} Gaussians, median {statistics.median(times):.3f} "
            f"ms/frame (all {[round(t, 3) for t in times]}), num_rendered "
            f"{int(out_t.num_rendered)}, tile_max {int(out_t.tile_max)}, "
            f"max_per_tile {s.static.config_tof.max_per_tile}")

    # Small input: the card against the CPU path (plain compositor).
    for name in ("ftorf", "torf"):
        small = Scene(name, 2, 4000, device)
        gpu = outputs_of(*small.render(1))
        cpu = outputs_of(*small.to_cpu().render(1, device="cpu"))
        worst = 0.0
        for k, ref in cpu.items():
            got = gpu[k].cpu()
            if not got.is_floating_point() or k.endswith("/pixels"):
                diff = int((got != ref).sum())
                if diff > max(1, ref.numel() // 1000):
                    raise AssertionError(f"{name} small: {k} differs in {diff}")
                continue
            err = (got - ref).abs()
            if bool((err > E2E_ATOL + E2E_RTOL * ref.abs()).any()):
                raise AssertionError(f"{name} small: {k} max err {float(err.max())}")
            worst = max(worst, float(err.max()))
        log("serve", f"{name}: 4000-Gaussian frame on the card matches the "
            f"CPU path (max abs err {worst:.3g})")
    log("serve", f"ok: {launches} kernel launches for {calls} rasterize calls")
    return scenes, launches


# ---------------------------------------------------------------- phase 4


def phase_determinism(scenes):
    import torch

    for s in scenes:
        a = outputs_of(*s.render(5 if s.name == "ftorf" else 1))
        b = outputs_of(*s.render(5 if s.name == "ftorf" else 1))
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            raise AssertionError(f"{s.name}: not bitwise repeatable: {diff}")
    log("determinism", f"ok: {len(a)} outputs bitwise equal on re-render")


# ---------------------------------------------------------------- phase 5


def composite_inputs_of(scene, fid):
    """The (feat_tl, bg_tiles, counts, origins) block eval_frame hands the
    compositor for one ToF render of ``scene``."""
    import torch

    from gftorf_tpu_torch.render.rasterize import composite_inputs
    from gftorf_tpu_torch.train.step import _compose, _query_deform

    st, frame = scene.static, scene.frames[fid]
    with torch.no_grad():
        d_xyz, d_rot, d_sh, *_ = _query_deform(st, scene.deform, scene.params,
                                               fid, alive=scene.alive)
        means3d, scales, rots, opac, shs, shs_p, include = _compose(
            st, scene.params, d_xyz, d_rot, d_sh, scene.alive)
        n = means3d.shape[0]
        cfg = st.config_tof
        ci = composite_inputs(
            means3d, scales, rots, torch.where(include, opac, 0.0), shs, shs_p,
            frame.phase_offset, frame.dc_offset,
            torch.zeros((n, 2), device=scene.device),
            torch.zeros((7, cfg.height, cfg.width), device=scene.device),
            frame.cam_tof, cfg, st.active_sh_degree)
    return (ci.feat_tl, ci.bg_tiles, ci.counts, ci.origins), cfg


def work_of(feat_tl, counts, origins, cfg, contrib):
    """Bytes the function must move and fp32 operations it must do on
    these inputs: rows up to each tile's last evaluated instance, pairs
    evaluated up to each pixel's early exit, contributing pairs."""
    import torch

    from gftorf_tpu_torch.render.composite import ALPHA_EPS, ALPHA_MAX, T_STOP

    T, L, C = feat_tl.shape
    pix, tw = cfg.tile_pixels, cfg.tile_w
    pid = torch.arange(pix, device=feat_tl.device)
    lane = torch.arange(L, device=feat_tl.device)
    rows = evaluated = 0
    for t0 in range(0, T, 16):
        sl = slice(t0, min(T, t0 + 16))
        n = counts[sl, None].long()
        f = torch.where((lane < n)[..., None], feat_tl[sl], 0.0)
        px = origins[sl, 0, None] + pid % tw
        py = origins[sl, 1, None] + pid // tw
        inside = (px < cfg.width) & (py < cfg.height)
        dx = f[:, None, :, 0] - px[..., None].float()
        dy = f[:, None, :, 1] - py[..., None].float()
        power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
                 - f[:, None, :, 3] * dx * dy)
        alpha = torch.clamp(f[:, None, :, 5] * torch.exp(power.clamp(max=0)),
                            max=ALPHA_MAX)
        valid = (power <= 0) & (alpha >= ALPHA_EPS) & (lane < n)[:, None, :]
        t_incl = torch.cumprod(1.0 - torch.where(valid, alpha, 0.0), -1)
        stop = valid & (t_incl < T_STOP)
        n_eval = torch.where(stop.any(-1), stop.byte().argmax(-1) + 1,
                             n.expand(-1, pix))
        n_eval = torch.where(inside, n_eval, 0)
        evaluated += int(n_eval.sum())
        rows += int(n_eval.amax(-1).sum())
    contributing = int(contrib.sum())
    nbytes = 4 * (rows * C + T * 3 + T * pix * (12 + 32) + T * L)
    ops = (OPS_EVAL * evaluated + OPS_CONTRIB * contributing
           + (OPS_DD * contributing if cfg.need_dd else 0))
    return nbytes, ops


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(scenes, worst_err, launches):
    from gftorf_tpu_torch.render.kernels import dense

    records = {}
    for s in scenes:
        args, cfg = composite_inputs_of(s, 1)
        out, contrib = dense.composite_forward_cuda(*args, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(*args, cfg)
        err, _ = compare(out, contrib, ref_out, ref_contrib, f"{s.name} serving")
        worst_err = max(worst_err, err)
        ms = time_ms(lambda: dense.composite_forward_cuda(*args, cfg), 50)
        plain_ms = time_ms(lambda: dense.composite_forward_plain(*args, cfg), 3)
        nbytes, ops = work_of(args[0], args[2], args[3], cfg, contrib)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ops / PEAK_FP32_PER_S
        records[s.name] = dict(ms=ms, plain_ms=plain_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations")
        T, L, _ = args[0].shape
        log("timing", f"dense_forward at {s.name} serving shapes (T={T}, "
            f"PIX={cfg.tile_pixels}, L={L}, instances {int(args[2].sum())}, "
            f"gates={cfg.need_dd}): {ms:.4f} ms; plain {plain_ms:.3f} ms; "
            f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes} B -> {t_bytes:.4f} "
            f"ms, {ops} fp32 ops -> {t_ops:.4f} ms); max_abs_err {err:.3g}")
    head = records["ftorf"]
    kernels = [dict(
        name="dense_forward", route="cuda",
        source="gftorf_tpu_torch/csrc/dense_forward.cu",
        replaces="gftorf_tpu/render/pallas_composite.py:308",
        launches=launches, max_abs_err=worst_err, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None)]
    log("timing", "ok")
    return kernels


# ------------------------------------------------------- --profile only


def phase_profile(scenes, reps=5):
    """Where a served frame's time goes. Per stage of one ToF render:
    host clock around each synchronised stage, median of ``reps``. Per
    scene: the device's busy share of whole frames under torch.profiler
    (the union of kernel, memcpy and memset intervals over the host wall
    time of the window), and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gftorf_tpu_torch.render.binning import bin_gaussians
    from gftorf_tpu_torch.render.composite import tiles_to_image
    from gftorf_tpu_torch.render.kernels import dense
    from gftorf_tpu_torch.render.preprocess import preprocess
    from gftorf_tpu_torch.train.step import _compose, _query_deform

    for s in scenes:
        st, frame, cfg = s.static, s.frames[1], s.static.config_tof
        n = s.n_points
        times = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return r

        with torch.no_grad():
            for _ in range(reps + 1):
                d = stage("deform MLP", lambda: _query_deform(
                    st, s.deform, s.params, 1, alive=s.alive))
                m3, sc, rot, op, shs, shs_p, inc = stage("compose", lambda: _compose(
                    st, s.params, d[0], d[1], d[2], s.alive))
                op = torch.where(inc, op, 0.0)
                pre = stage("preprocess", lambda: preprocess(
                    m3, sc, rot, op, shs, shs_p, frame.phase_offset,
                    frame.dc_offset, torch.zeros((n, 2), device=s.device),
                    frame.cam_tof, cfg, st.active_sh_degree))
                b = stage("binning", lambda: bin_gaussians(
                    pre.rect, pre.depth_view, pre.valid, cfg, cfg.capacity_for(n)))
                idc = b.gauss_id.clamp(min=0).to(torch.int64).reshape(-1)
                T, L = b.gauss_id.shape
                feat = stage("pack + gather", lambda: dense.pack_gaussian_features(
                    pre)[idc].reshape(T, L, 24))
                bg = dense._bg_to_tiles(torch.zeros((7, cfg.height, cfg.width),
                                                    device=s.device), T, cfg)
                org = dense._default_origins(T, cfg, s.device)
                blk, contrib = stage("composite kernel", lambda: dense.composite_forward(
                    feat, bg, b.tile_count, org, cfg))

                def finish():
                    px = torch.zeros(n, device=s.device).index_add_(
                        0, idc, contrib.reshape(-1))
                    out = dense.unpack_outputs(blk, contrib)
                    return px, [tiles_to_image(getattr(out, k), cfg) for k in (
                        "color", "phasor", "depth", "acc", "dd", "distribution")]

                stage("pixel sum + images", finish)
        med = {k: statistics.median(v[1:]) for k, v in times.items()}
        total = sum(med.values())
        log("profile", f"{s.name} one ToF render, stage medians of {reps}: "
            + "; ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in med.items()) + f"; sum {total:.3f} ms")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fid in range(len(s.frames)):
                s.render(fid)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        path = os.path.join(ROOT, "build", "profile", f"trace_{s.name}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        if not spans:
            log("profile", f"{s.name}: the profiler saw no device activity "
                "(device busy share not measured)")
            continue
        busy, end, by_name = 0.0, -1.0, {}
        for a, z, name in spans:
            busy += max(0.0, z - max(a, end))
            end = max(end, z)
            by_name[name] = by_name.get(name, 0.0) + (z - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        nf = len(s.frames)
        log("profile", f"{s.name} {nf} frames under the profiler: wall "
            f"{wall_us / 1e3 / nf:.3f} ms/frame, device busy "
            f"{busy / 1e3 / nf:.3f} ms/frame, idle share "
            f"{1 - busy / wall_us:.3f}, {len(spans) / nf:.0f} device ops/frame")
        for name, us in top:
            log("profile", f"  {us / 1e3 / nf:.4f} ms/frame "
                f"({100 * us / busy:.1f}% of busy): {name[:110]}")


# ---------------------------------------------------------------- main


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "gftorf_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (the "
              "gftorf_tpu_torch package is missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    phase_build()
    worst = phase_kernels(device)
    scenes, launches = phase_serve(device)
    phase_determinism(scenes)
    kernels = phase_timing(scenes, worst, launches)
    if "--profile" in sys.argv[1:]:
        phase_profile(scenes)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
