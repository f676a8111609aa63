#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gftorf_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name and raising on failure:

1. build    nvcc builds every kernel of the serving and training paths,
            dense and flat-stream, from gftorf_tpu_torch/csrc/ (into
            build/kernels/), one nvcc per source, all at once; prints the
            build seconds, ptxas' register, spill and shared-memory report
            and the card.
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, on seeded synthetic tile blocks: full width (150 tiles of
            16x32 pixels, L = 1024 and 2048) and a ragged 250x180 image
            with 16x16 tiles; dd/distribution gates on and off; flow
            present and absent; per-tile counts of 0, partial and full,
            NaN in every lane past a tile's count. Forward at atol 2e-5,
            rtol 1e-4; backward (against a cotangent drawn in [-1, 1]) at
            atol 2e-4, rtol 1e-3. Contributing-pixel counts equal up to
            1e-4 of the lanes (the lanes whose transmittance lies within
            ulps of T_STOP), and backward rows past the tolerance only in
            such lanes. Then one backward launch at L = 8192 (tile depth
            has no shared-memory ceiling), checked the same way, and the
            forward alone at 32x32 tiles (its 1024-thread instance) and at
            8x12 tiles (where its warps cannot hold 8x4 pixel blocks).
            The kernels' per-warp cull predicate (csrc/warp_cull.cuh,
            through its C entry gftorf_warp_cull_mask) against its plain
            version (equal) and brute force (no culled row may have a
            valid pixel in the warp's rectangle, in float32 or float64), on
            boundary cases at tile_w 8, 16, 32, a ragged image and the
            forward's 8x4 rectangles; then "grazing" blocks whose every
            row's 1/255 contour passes within 1e-3 px of a warp's rectangle
            (the backward's 16x2 or 32x1 ones, or the forward's 8x4), all
            four kernels against the plain versions there, flat = dense
            bitwise.
            The flat-stream kernels the same way, on seeded Gaussians binned
            by the port's bin_gaussians_flat (full width and the ragged
            image; gates and flow on and off): empty tiles, tiles spanning
            several 256-row blocks and one tile deeper than 16,384
            instances, NaN in every stream slot outside the tiles' rows (the
            plain version gets the zero-padded stream); and each flat
            kernel against its dense twin on the same Gaussians binned
            densely at an L that holds the deepest tile (rows mapped slot
            <-> (tile, lane)).
3. serve    eval_frame on a 100,000-Gaussian model (half of it dynamic)
            with the full-width deform MLP (D=8, W=256), drawn from a seed.
            ftorf: 8 frames at 320x240, single camera, lerp frames
            included. torf: 4 frames, two 320x240 cameras. Launch counts
            are zeroed just before and read just after; every output must
            be finite, no tile may overflow. A 4,000-Gaussian frame of each
            scene must agree with the CPU path (plain compositor).
   serve-flat  the same scenes and frames with flat_stream=True on both
            RasterConfigs: every frame agrees with the dense frame (atol
            1e-4, rtol 1e-3; integer outputs and pixel counts equal in all
            but 0.1 % of entries), the flat forward kernel launches once
            per rasterize call and the dense kernels not at all.
4. train    train_step at full width: 100,000 live Gaussians (half dynamic)
            in a capacity of 200,000, sorted layout, render bucket 131,072,
            deform bucket 65,536, the StepStatic the Trainer builds from
            configs/{ftorf,torf}.json. Targets are the port's own renders of
            the model; then xyz is jittered. ftorf: 20 steps (iterations
            2101-2120) over 4 frames, half of them integration frames (flow
            on). torf: 10 steps, two cameras. Every metric and state leaf
            finite, no overflow, the loss falls, and both kernels' launch
            counts equal the differentiated rasterize calls.
   train-flat  both runs again from their starting state with flat_stream=
            True on both StepStatic configs: the first step's metrics, Adam
            moments, densify stats and parameters match the dense step's on
            the card (phase 5's kernels-vs-plain tolerances), the loss falls,
            every state leaf is finite, both flat kernels launch once per
            differentiated rasterize call and the dense kernels not at all.
5. train-vs-cpu  one step of each config at 4,000 Gaussians on the card and
            on the CPU path (plain kernels), compared with the CPU parity
            tests' tolerances (tests/torch_port_util.py).
   deep-tile  a crowded full-width scene (100,000 Gaussians and 20,000
            more in front of one tile) whose deepest tile holds more than
            16,384 instances: dense at max_per_tile 16,384 reports
            tile_overflow > 0, flat reports 0; the flat frame equals the
            dense frame at an L that holds the deepest tile, and both flat
            kernels equal their dense twins there; logs the depth and the
            four kernels' times.
6. determinism  a served frame rendered twice, and a training step run
            twice from one state with one generator seed, are bitwise equal,
            on the dense and on the flat path.
7. timing   each kernel at the ftorf training shapes (CUDA events), its
            plain version, and the least time the card could take for the
            same work (bytes over 3.35 TB/s, fp32 operations over 67
            TFLOP/s, counted from this run's data), and each kernel's
            blocks per SM, registers, spills and shared memory; the flat
            kernels on the flat step's stream, and the work around the
            compositor that grows with the layout's rows (gather, its
            segment-sum backward, the flat gradient's zero-fill), dense
            against flat.
8. trainer  the Trainer through its CLI (gftorf_tpu_torch.train.__main__.main
            in this process) on datasets the port's writer puts under
            build/trainer/: an ftorf "room" scene (16 frames) at 320x240, a
            ToRF one (8 frames, .mat intrinsics, a colour camera offset from
            the ToF camera, ToF at 320x240 and colour at 640x480 from a
            second write of the same seed, whose poses and Gaussians must
            equal the first's), and the verify recipe's 64x48 scene.
            configs/ftorf.json at full width for 260 iterations (warm-up to
            100, densify every 50 from 100, the opacity reset at 250, the
            deform MLP stepping at 201-249, evaluations at 100 and 260, a
            save and a checkpoint at 260): every record and evaluation
            finite, num_points changed by the densify events, the artifact
            tree complete, the saved PLY and deform_model.npz rendering the
            Trainer's frame (atol 1e-4, rtol 1e-3), the checkpoint resuming
            to an equal state, the start-up fit check run once, both dense
            kernels launched in the run. Then
            configs/torf.json as shipped (colour 640x480 at
            color_scale_factor 0.5, no colour flag overridden) for 30
            iterations (two cameras, regions ("dynamic",), densify at 20
            and 30, an evaluation and a save at 30): the readers resized
            every colour frame to 320x240 (utils/resize.py, no cv2), the
            colour cameras are 320x240, both dense kernels launched and the
            start-up check ran once, the artifact tree is complete with
            scene_bounds.png (drawn without matplotlib, as in the ftorf
            run); prints the start-up read and resize seconds and
            ms/iteration past warm-up, and adds its launches (counted from
            0 around the run) to the ``kernels`` line; a run whose
            max_per_tile_limit (256) is below the
            scene's deepest tile, where the flat fallback must engage and
            both flat kernels launch; the verify recipe, where mae_d_tof
            must fall; two identical 8-iteration runs with bitwise-equal
            losses. Prints ms per iteration, per densify event and per
            evaluation frame beside the card. ``--drift`` adds the verify
            recipe without random backgrounds on the card and on the CPU,
            mae_d_tof and psnr_p side by side at each evaluation.

9. render  the render CLI (gftorf_tpu_torch.render.__main__.main in this
            process) on the [trainer] phase's saved models, copied under
            build/render/. The ftorf model at full width: the whole test
            split (16 frames) with video and --proxy_pcd (16 more frames);
            dense_forward (or flat_forward, where a frame outgrows
            max_per_tile_limit) launches once per render, re-renders of a
            frame that overflowed the loaded max_per_tile included, and
            dense_backward never (the Trainer's start-up fit check runs
            once and launches nothing); every file
            of the tree is there; two frames' depth .npy are bitwise equal to
            eval_frame in this process, and dense_forward is held against
            its plain version at the render's shapes; tile_overflow is
            logged per frame. The same CLI with --device cpu --max_frames 2:
            .npy within atol 1e-4, rtol 1e-3, PNGs at most 1 level apart on
            at most 1 % of pixels, both on all but 1e-4 of the pixels
            (where one instance's alpha within rounding of the 1/255 cutoff
            counts on one device and not the other). A copy with flat_stream set in its
            config: flat_forward launches once per render and every PNG and
            .npy equals the dense render bitwise. The torf model: the
            spiral and freeze-frame spiral paths, their frames differing.
            render_traj on the ftorf model: finite tracks, traj/,
            depth_q*/, quad_q*/ and both panels. The train CLI with --debug
            true at the verify recipe's size: every tmp_debug_* directory.
            Prints ms/frame of the render CLI (render and writing, host
            medians) beside the card.

10. sharded  the multi-device training step (``parallel/``), its ranks
            spawned on this one card over gloo (NCCL takes one rank per
            card; gloo stages the collectives through the host), the kernels
            built once before the spawn: from the [train] phase's full-width
            states (configs/ftorf.json and torf.json, 100,000 Gaussians in a
            capacity of 200,000) with constant backgrounds, three steps under
            the meshes (1,2), (1,4) and (2,2) dense and (1,2) flat for ftorf
            and (1,2) dense for torf, one camera per data slice. After every
            step each rank's state is bitwise equal (SHA-1 of every leaf);
            the first step of a shard-only mesh matches the single-device
            step on the card (compare_steps); the flat mesh equals the dense
            one bitwise; reruns of (1,2) and (2,2) are bitwise equal; the
            last band's rank holds kernels 1-4 against their plain versions
            on its own band's inputs (origins from its first tile row; the
            backward with a cotangent in [-1, 1]), and the check must refuse
            a zeroed gradient and the pair one tile row up; each rank's
            launches equal its renders; (2,2) at the [train-vs-cpu] size
            (4,000 Gaussians in 6,001 rows, which divide by neither shard
            count, so the rendered rows are padded) against (2,2) on the CPU
            (gloo, plain kernels) at that phase's tolerances. Prints ms/step per mesh and rank (ranks
            sharing one card over gloo) and each rank's peak memory. Then
            ``python -m torch.distributed.run --nproc_per_node 2 -m
            gftorf_tpu_torch.train --distributed`` on configs/ftorf.json with
            mesh_shards 2 on the [trainer] phase's scene, 30 iterations
            (densify at 20 and 30, max_per_tile 128 and dup_factor 2 so both
            grow and replay at iteration 1): rank 0's artifact tree complete,
            the ranks' final digests equal (the CLI's "ranks agree" line),
            mae_d_tof falling between the evaluations at 1 and 30. Outputs
            under build/sharded/. The sharded launches are added to the
            ``kernels`` line.

11. bench  the port's benchmark (gftorf_tpu_torch.bench.main in this
            process; scene and model under build/bench/). ``--rasterizer``:
            100,000 Gaussians at 640x480 in 16x16 tiles (1,200 tiles of
            256 pixels, L = 1,024), a warm-up step and 20 timed forward +
            backward steps; then the Trainer at bench_train's workload
            (320x240, 50,000 points, quads + deform + flow, 550 iterations,
            250 of warm-up). Each last line must have the root bench.py's
            keys, metric name, unit and vs_baseline formula and a finite
            value; every capacity grow-and-replay and shrink must fall in the
            warm-up. Kernels 1 and 2 are held against their plain versions
            on one dense compositor call of the 640x480 run (forward atol
            2e-5 rtol 1e-4; backward atol 2e-4 rtol 1e-3 with a cotangent in
            [-1, 1] from a seed, on every instance row but at most 1e-4 of
            them, which must lie within twice it: small entries that sums
            of large cancelling terms leave, where the plain version on
            the CPU and on the card differ as much; the check must refuse
            a zeroed gradient and a rolled cotangent's) and
            timed there beside their bound. Both runs' launches are added
            to the ``kernels`` line.
12. debug_nans  the train CLI with --debug_nans on the [trainer] phase's
            ftorf scene at full width for 6 iterations (the deform MLP and
            the flow loss from iteration 3): the run finishes, with the
            state digest and losses of the same run without the switch, and
            the NaN mode sees backward ops; the run resumed from its
            checkpoint with a NaN in one live opacity finishes without the
            switch and raises FloatingPointError with it; each of the four
            kernel wrappers, fed a NaN background or cotangent, raises
            FloatingPointError naming its kernel inside the mode and not
            outside it.
13. fit-check  kernel 5, the Trainer's start-up fit check
            (render/kernels/dense.py::check_backward_fits, in place of the
            TPU's compile-only VMEM check): the card's occupancy query of
            every instance of dense_backward at 16x32 and 16x16 tiles
            against its plain model (blocks_per_sm_plain, from the device
            properties it prints), equal; a Trainer start on each
            [trainer] model (load_trained) checks both has_flow instances
            at its dd_possible and launches no kernel; the check's host
            time per call (mean of 200) beside the model's; the same
            profiler window with and without 20 checks holds the same
            device operations; the check raises for 32x32 tiles, for a
            query stubbed to report 0 blocks and for one stubbed to return
            a CUDA error, each stub undone after. Its entry in the
            ``kernels`` line counts the checks of the main-path phases
            ([trainer]'s torf run, [render], [bench]), with bound 0.

``python3 chip_smoke.py --profile`` adds a breakdown of a served frame by
stage and the device's share of a training step under torch.profiler,
dense and flat, and traces under build/profile/; without arguments the
script runs the phases above only.

The second-to-last line is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
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
# The backward (csrc/dense_backward.cu, counted from its code): the same
# evaluation, then per contributing pair d_alpha and the 24 gradient
# shares (79) and the adds of the per-instance sums (17); +12 with flow,
# +20 with dd.
OPS_CONTRIB_BWD, OPS_FLOW_BWD, OPS_DD_BWD = 96, 12, 20
ATOL, RTOL, CONTRIB_FRAC = 2e-5, 1e-4, 1e-4
ATOL_BWD, RTOL_BWD = 2e-4, 1e-3
E2E_ATOL, E2E_RTOL = 1e-4, 1e-3
# Step tolerances of tests/torch_port_util.py (card against CPU).
METRIC_RTOL = 1e-5
MU_ATOL_FRAC, MU_RTOL = 1e-4, 1e-3
NU_ATOL_FRAC, NU_RTOL = 2e-4, 2e-3
KERNELS = ("dense_forward", "dense_backward", "flat_forward", "flat_backward")
# Kernel 5: the Trainer's start-up fit check of dense_backward's instances
# (render/kernels/dense.py::check_backward_fits), a query of the card.
FIT_CHECK = "dense_backward_fit_check"
REPLACES = {
    "dense_forward": "gftorf_tpu/render/pallas_composite.py:308",
    "dense_backward": "gftorf_tpu/render/pallas_composite.py:441",
    "flat_forward": "gftorf_tpu/render/flat_stream.py:102",
    "flat_backward": "gftorf_tpu/render/flat_stream.py:235",
    FIT_CHECK: "gftorf_tpu/render/vmem_check.py:38",
}
# The device properties dense.blocks_per_sm_plain reads, and the checks
# timed for the fit check's host time.
FIT_PROPS = ("warp_size", "max_threads_per_block",
             "max_threads_per_multi_processor",
             "regs_per_multiprocessor", "shared_memory_per_block_optin",
             "shared_memory_per_multiprocessor")
FIT_REPS = 200
# The Trainer's ceiling on max_per_tile (configs' max_per_tile_limit): past
# it only the flat stream renders a scene exactly.
MAX_PER_TILE_LIMIT = 16384


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
    built = build.build(KERNELS)
    secs = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
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


def random_conics(rng, n, sig_lo, sig_hi):
    """(a, b, c) float64 conics of n Gaussians with axis sigmas drawn
    log-uniform in [sig_lo, sig_hi] px, rotated uniformly."""
    import numpy as np

    s1 = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), n))
    s2 = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), n))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    # Inverse of R diag(s1^2, s2^2) R^T.
    i1, i2 = 1.0 / (s1 * s1), 1.0 / (s2 * s2)
    return cs * cs * i1 + sn * sn * i2, cs * sn * (i1 - i2), sn * sn * i1 + cs * cs * i2


def contour_extent(a, b, c, o):
    """Half-widths (hx, hy) of each row's exact 1/255 contour, and the
    offsets of its extreme points: (dy at the x-extreme per unit of the
    x direction, dx at the y-extreme), in float64."""
    import numpy as np

    eps = float(np.float32(1.0 / 255.0))
    lam = np.log(np.asarray(o, np.float64) / eps)
    det = a * c - b * b
    t = np.sqrt(2.0 * lam / (c * det))
    s = np.sqrt(2.0 * lam / (a * det))
    return c * t, a * s, -b * t, -b * s


def cull_cases(rng, width, height, tile_w, n_random=600, n_graze=600, tile_h=16,
               blocks=False):
    """Boundary cases of the kernels' per-warp cull: packed rows (n, 24)
    float32 and every warp rectangle (m, 4) float32 {x0, x1, y0, y1} of a
    width x height image cut into tile_h x tile_w tiles (512 or fewer
    pixels a tile), under the backward's map of threads to pixels or, with
    ``blocks``, the forward's (dense.warp_pixels). Sigmas 0.3-300 px, rotated; opacity from the
    float just above 1/255 to 0.99. ``n_random`` rows lie anywhere near
    the image; each of ``n_graze`` rows is placed so that its exact 1/255
    contour passes within 1e-3 px (inside or outside) of an edge pixel of
    one rectangle, at a pixel of that edge. Returns (rows, rects, graze)
    with graze (n_graze, 2) int64 (row, rectangle) pairs."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels.dense import warp_rects
    from gftorf_tpu_torch.render.settings import RasterConfig

    cfg = RasterConfig(height=height, width=width, tile_h=tile_h, tile_w=tile_w)
    T = cfg.num_tiles
    gw = cfg.grid_w
    tid = np.arange(T)
    origins = torch.tensor(np.stack([(tid % gw) * tile_w, (tid // gw) * tile_h],
                                    -1).astype(np.int32))
    rects = warp_rects(origins, tile_w, cfg.tile_pixels, blocks).reshape(-1, 4).numpy()
    n = n_random + n_graze
    a, b, c = random_conics(rng, n, 0.3, 300.0)
    eps = np.float32(1.0 / 255.0)
    o = np.exp(rng.uniform(np.log(float(eps) * 1.0001), np.log(0.99), n))
    o[::5] = np.nextafter(eps, np.float32(1))  # just above 1/255
    o = o.astype(np.float32)
    mx = rng.uniform(-60, width + 60, n)
    my = rng.uniform(-60, height + 60, n)
    hx, hy, dy_x, dx_y = contour_extent(a, b, c, o)
    q = rng.integers(0, rects.shape[0], n_graze)
    side = rng.integers(0, 4, n_graze)
    delta = rng.uniform(-1e-3, 1e-3, n_graze)
    g = slice(n_random, n)
    x0, x1, y0, y1 = (rects[q, k].astype(np.float64) for k in range(4))
    px = np.floor(rng.uniform(x0, x1 + 1))  # an edge pixel of the rectangle
    py = np.floor(rng.uniform(y0, y1 + 1))
    # Left of the rectangle: the contour's right extreme, (mx + hx, my +
    # dy_x), at (x0 - delta, py); right of it: the left extreme, (mx - hx,
    # my - dy_x), at (x1 + delta, py); above and below alike with the
    # bottom extreme (mx + dx_y, my + hy) and the top one.
    gx = np.select([side == 0, side == 1, side == 2, side == 3],
                   [x0 - delta - hx[g], x1 + delta + hx[g], px - dx_y[g],
                    px + dx_y[g]])
    gy = np.select([side == 0, side == 1, side == 2, side == 3],
                   [py - dy_x[g], py + dy_x[g], y0 - delta - hy[g],
                    y1 + delta + hy[g]])
    mx[g], my[g] = gx, gy
    rows = np.zeros((n, 24), np.float32)
    rows[:, :6] = np.stack([mx, my, a, b, c, o], -1)
    rows[:, 6:] = rng.uniform(-1, 1, (n, 18))
    return rows, rects, np.stack([np.arange(n_random, n), q], -1)


def any_valid(rows, rects, exact=False, chunk=256):
    """(n, m) bool: some pixel of rectangle q is valid for row r under the
    compositor's alpha (gftorf_tpu/render/composite.py:94-98, the kernels'
    eval_sample): power <= 0 and min(0.99, o * exp(power)) >= 1/255, in
    float32 with the kernels' order of operations, or in float64 with
    ``exact``. Brute force over every pixel of every rectangle."""
    import torch

    from gftorf_tpu_torch.render.composite import ALPHA_EPS, ALPHA_MAX

    dt = torch.float64 if exact else torch.float32
    x0, x1, y0, y1 = rects.unbind(-1)
    wmax, hmax = int((x1 - x0).max()) + 1, int((y1 - y0).max()) + 1
    ox = torch.arange(wmax, device=rows.device, dtype=dt)
    oy = torch.arange(hmax, device=rows.device, dtype=dt)
    pxs = (x0.to(dt)[:, None, None] + ox[None, None, :]).expand(-1, hmax, -1)
    pys = (y0.to(dt)[:, None, None] + oy[None, :, None]).expand(-1, -1, wmax)
    inside = (pxs <= x1.to(dt)[:, None, None]) & (pys <= y1.to(dt)[:, None, None])
    out = []
    eps = torch.tensor(ALPHA_EPS, dtype=dt)
    for r0 in range(0, rows.shape[0], chunk):
        f = rows[r0:r0 + chunk, :6].to(dt)[:, None, None, None, :]
        ddx = f[..., 0] - pxs
        ddy = f[..., 1] - pys
        power = (-0.5 * (f[..., 2] * ddx * ddx + f[..., 4] * ddy * ddy)
                 - f[..., 3] * ddx * ddy)
        alpha = torch.clamp(f[..., 5] * torch.exp(torch.clamp(power, max=0.0)),
                            max=ALPHA_MAX)
        valid = (power <= 0.0) & (alpha >= eps) & inside
        out.append(valid.flatten(2).any(-1))
    return torch.cat(out)


def grazing_tiles(rng, config, L, flow, device, blocks=False):
    """Like ``synthetic_tiles``, but every row sits on a cull boundary:
    its exact 1/255 contour passes within 1e-3 px (inside or outside) of an
    edge pixel of one warp rectangle of its own tile (the rows of
    ``cull_cases``), under the backward's map of threads to pixels or,
    with ``blocks``, the forward's."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels.dense import _bg_to_tiles, _default_origins

    T = config.num_tiles
    rows, rects, graze = cull_cases(rng, config.width, config.height,
                                    config.tile_w, n_random=0, n_graze=T * L,
                                    tile_h=config.tile_h, blocks=blocks)
    # Rectangles run tile by tile: put each row in its rectangle's tile.
    warps = rects.shape[0] // T
    tile = graze[:, 1] // warps
    feat = np.full((T, L, 24), np.nan, np.float32)
    counts = rng.integers(1, L + 1, T)
    counts[::7] = 0
    counts[1::7] = L
    for t in range(T):
        mine = rows[tile == t][: counts[t]]
        counts[t] = mine.shape[0]
        if not flow:
            mine[:, 18:] = 0.0
        feat[t, : counts[t]] = mine
    bg = rng.uniform(0, 1, (7, config.height, config.width)).astype(np.float32)
    return (torch.tensor(feat, device=device),
            _bg_to_tiles(torch.tensor(bg), T, config).to(device),
            torch.tensor(counts, dtype=torch.int32, device=device),
            _default_origins(T, config, device))


def phase_cull(device):
    """The kernels' cull predicate on the card (gftorf_warp_cull_mask,
    csrc/warp_cull.cuh) against its plain version and brute force, on
    cull_cases at tile_w 8, 16 and 32 and a ragged image, and on the
    forward's 8x4 warp rectangles."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense

    rng = np.random.default_rng(SEED + 2)
    for tw, w, h, blocks in ((8, 320, 240, False), (16, 320, 240, False),
                             (32, 320, 240, False), (16, 250, 180, False),
                             (32, 320, 240, True)):
        rows, rects, graze = cull_cases(rng, w, h, tw, n_random=2000, n_graze=2000,
                                        blocks=blocks)
        rows = torch.tensor(rows, device=device)
        rects = torch.tensor(rects, device=device)
        got = dense.warp_cull_mask_cuda(rows, rects)
        plain = dense.warp_cull_plain(rows, rects)
        torch.cuda.synchronize()
        differ = int((got != plain).sum())
        bad = {exact: int((got & any_valid(rows, rects, exact=exact)).sum())
               for exact in (False, True)}
        gi = torch.tensor(graze, device=device)
        kept = int((~got[gi[:, 0], gi[:, 1]]).sum())
        what = (f"cull {w}x{h} tile_w {tw}{' (8x4 blocks)' if blocks else ''}: "
                f"{rows.shape[0]} rows x {rects.shape[0]} rectangles")
        if differ or bad[False] or bad[True] or kept != gi.shape[0]:
            raise AssertionError(
                f"{what}: {differ} pairs differ from warp_cull_plain, {bad[False]} "
                f"({bad[True]} in float64) culled pairs with a valid pixel, "
                f"{gi.shape[0] - kept} grazing pairs culled")
        log("kernels", f"{what}: CUDA predicate equals warp_cull_plain; culled "
            f"{int(got.sum())} of {got.numel()} pairs, none with a valid pixel "
            f"(float32 or float64 brute force); all {kept} grazing pairs kept")


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


def compare_bwd(dfeat, ref, lanes_flipped, what, rows=0):
    """Backward kernel against plain: max |err|; raises past the tolerance
    outside the lanes whose contribute latch flipped between the kernel
    and the plain version (a flip changes that lane's gradient row).

    With ``rows`` (the instance rows of the block), up to CONTRIB_FRAC of
    them may lie past the tolerance but within twice it: entries that
    sums of large cancelling terms leave small (the suffix sums taken as
    totals minus prefixes, divided by 1 - alpha) carry the rounding of
    those terms, by which two fp32 evaluations of the plain version itself
    (on the CPU and on the card) differ as much. Returns (max |err|, rows
    past the tolerance)."""
    import torch

    if not bool(torch.isfinite(dfeat).all()):
        raise AssertionError(f"{what}: backward kernel output is not finite")
    err = (dfeat - ref).abs()
    tol = ATOL_BWD + RTOL_BWD * ref.abs()
    bad_rows = int((err > tol).any(-1).sum())
    twice = int((err > 2 * tol).any(-1).sum())
    allowed = lanes_flipped + int(CONTRIB_FRAC * rows)
    if bad_rows > allowed or twice > lanes_flipped:
        raise AssertionError(
            f"{what}: {bad_rows} gradient rows past atol {ATOL_BWD} rtol "
            f"{RTOL_BWD} (max {float(err.max()):.3g}; {twice} past twice "
            f"it) with {lanes_flipped} contribute lanes flipped"
            f"{f' in {rows} rows' if rows else ''}")
    return float(err.max()), bad_rows


def cotangent(rng, config, device):
    """A (T, PIX, 32) cotangent in [-1, 1], every column set."""
    import numpy as np
    import torch

    g = rng.uniform(-1, 1, (config.num_tiles, config.tile_pixels, 32))
    return torch.tensor(g.astype(np.float32), device=device)


def phase_kernels(device):
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense
    from gftorf_tpu_torch.render.settings import RasterConfig

    rng = np.random.default_rng(SEED)
    worst = {name: 0.0 for name in KERNELS}
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
    # Deep tiles: the Hopper counterpart of the JAX package's VMEM compile
    # check (render/vmem_check.py) is that this launch is accepted.
    cases.append((RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                               max_per_tile=8192, need_dd=False,
                               need_distribution=False, tile_chunk=4), True))
    for cfg, flow in cases:
        args = synthetic_tiles(rng, cfg, cfg.max_per_tile, flow, device)
        out, contrib = dense.composite_forward_cuda(*args, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(*args, cfg)
        g = cotangent(rng, cfg, device)
        feat, bg, counts, origins = args
        dfeat = dense.composite_backward_cuda(feat, bg, out, g, counts,
                                              origins, cfg, flow)
        ref_dfeat = dense.composite_backward_plain(feat, bg, out, g, counts,
                                                   origins, cfg, flow)
        torch.cuda.synchronize()
        what = (f"{cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w} "
                f"L={cfg.max_per_tile} gates={cfg.need_dd} flow={flow}")
        err, lanes = compare(out, contrib, ref_out, ref_contrib, what)
        err_b, rows_b = compare_bwd(dfeat, ref_dfeat, lanes, what)
        worst["dense_forward"] = max(worst["dense_forward"], err)
        worst["dense_backward"] = max(worst["dense_backward"], err_b)
        log("kernels", f"{what}: forward max_abs_err {err:.3g}, contrib "
            f"lanes differing {lanes} of {contrib.numel()}; backward "
            f"max_abs_err {err_b:.3g} (max |grad| "
            f"{float(ref_dfeat.abs().max()):.3g}), rows past tolerance "
            f"{rows_b}")
    log("kernels", f"ok: {len(cases)} dense cases, max_abs_err forward "
        f"{worst['dense_forward']:.3g}, backward {worst['dense_backward']:.3g}")

    # Forward only: 32x32 tiles (the forward's instance for blocks of 1024
    # threads; the backward takes at most 512 pixels) and 8x12 tiles (12 is
    # no multiple of 8: the forward's warps hold consecutive pixels).
    for cfg in (RasterConfig(height=240, width=320, tile_h=32, tile_w=32,
                             max_per_tile=1024),
                RasterConfig(height=100, width=90, tile_h=8, tile_w=12,
                             max_per_tile=384)):
        args = synthetic_tiles(rng, cfg, cfg.max_per_tile, True, device)
        out, contrib = dense.composite_forward_cuda(*args, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(*args, cfg)
        torch.cuda.synchronize()
        what = (f"{cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w} "
                f"L={cfg.max_per_tile} gates={cfg.need_dd} flow=True")
        err, lanes = compare(out, contrib, ref_out, ref_contrib, what)
        worst["dense_forward"] = max(worst["dense_forward"], err)
        log("kernels", f"{what}: forward max_abs_err {err:.3g}, contrib lanes "
            f"differing {lanes} of {contrib.numel()}")

    phase_cull(device)
    # Blocks whose every row sits on the cull boundary of a warp of its
    # tile, under the backward's map of threads to pixels and under the
    # forward's: all four kernels against the plain versions, flat = dense.
    from gftorf_tpu_torch.render.kernels import flat

    for (cfg, flow), blocks in itertools.product(
            ((RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                           max_per_tile=256), True),
             (RasterConfig(height=180, width=250, tile_h=16, tile_w=16,
                           max_per_tile=256, need_dd=False,
                           need_distribution=False), False)),
            (False, True)):
        L = cfg.max_per_tile
        feat, bg, counts, origins = grazing_tiles(rng, cfg, L, flow, device, blocks)
        out, contrib = dense.composite_forward_cuda(feat, bg, counts, origins, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(feat, bg, counts,
                                                             origins, cfg)
        g = cotangent(rng, cfg, device)
        dfeat = dense.composite_backward_cuda(feat, bg, out, g, counts, origins,
                                              cfg, flow)
        ref_dfeat = dense.composite_backward_plain(feat, bg, out, g, counts,
                                                   origins, cfg, flow)
        T = cfg.num_tiles
        stream = feat.reshape(T * L, 24)
        start = torch.arange(T, dtype=torch.int32, device=device) * L
        fcfg = dataclasses.replace(cfg, flat_stream=True)
        f_out, f_contrib = flat.composite_forward_flat_cuda(stream, bg, start, counts,
                                                            origins, fcfg)
        f_dfeat = flat.composite_backward_flat_cuda(stream, bg, out, g, start,
                                                    counts, origins, fcfg, flow)
        torch.cuda.synchronize()
        what = (f"grazing the {'forward' if blocks else 'backward'}'s rectangles, "
                f"{cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w} "
                f"L={L} gates={cfg.need_dd} flow={flow}")
        err, lanes = compare(out, contrib, ref_out, ref_contrib, what)
        err_b, rows_b = compare_bwd(dfeat, ref_dfeat, lanes, what)
        slot, present = flat.stream_slots(start, counts)
        Ls = slot.shape[1]
        e_f, equal = compare_twins((f_out, f_contrib), (out, contrib[:, :Ls]), slot,
                                   present, what + " flat forward")
        e_b, equal_b = compare_twins((None, f_dfeat), (None, dfeat[:, :Ls]), slot,
                                     present, what + " flat backward")
        if not (equal and equal_b):
            raise AssertionError(f"{what}: flat and dense kernels differ (forward "
                                 f"{e_f:.3g}, backward {e_b:.3g})")
        for name in ("dense_forward", "flat_forward"):  # the same bits
            worst[name] = max(worst[name], err)
        for name in ("dense_backward", "flat_backward"):
            worst[name] = max(worst[name], err_b)
        log("kernels", f"{what}: instances {int(counts.sum())}; forward max_abs_err "
            f"{err:.3g}, contrib lanes differing {lanes}; backward max_abs_err "
            f"{err_b:.3g} (max |grad| {float(ref_dfeat.abs().max()):.3g}), rows past "
            f"tolerance {rows_b}; flat forward and backward on the same rows "
            "bitwise equal to dense")
    return worst


def synthetic_stream(rng, config, flow, device, per_tile=200, deep=16_500):
    """Seeded 2-D Gaussians binned into the aligned stream by the port's
    bin_gaussians_flat: ``per_tile`` per tile on average over the image
    (sigmas 0.7-8 px, opacity ceilings by tile column so that some tiles
    saturate early and others stay translucent), ``deep`` more crowded
    inside the middle tile alone, and nothing over the last tile column
    (empty tiles). Returns the packed (P, 24) rows, the binning inputs and
    the flat binning, all on ``device``."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.binning import bin_gaussians_flat

    W, H, tw, th = config.width, config.height, config.tile_w, config.tile_h
    gw, gh = config.grid_w, config.grid_h
    n = per_tile * config.num_tiles

    def gaussians(n, sig_lo, sig_hi, rho_max):
        sx = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), n))
        sy = np.exp(rng.uniform(np.log(sig_lo), np.log(sig_hi), n))
        rho = rng.uniform(-rho_max, rho_max, n)
        a, b, c = sx * sx + 0.3, rho * sx * sy, sy * sy + 0.3
        mid = 0.5 * (a + c)
        lam = mid + np.sqrt(np.maximum(0.1, mid * mid - (a * c - b * b)))
        return a, b, c, np.ceil(3.0 * np.sqrt(lam))

    a, b, c, r = gaussians(n, 0.7, 8.0, 0.8)
    mx, my = rng.uniform(-8, W + 8, n), rng.uniform(-8, H + 8, n)
    omax = np.array([0.05, 0.3, 0.99])[(np.floor(mx / tw).astype(int)) % 3]
    opac = rng.uniform(0.01, 1.0, n) * omax
    t_deep = (gh // 2) * gw + gw // 2
    x0, y0 = (t_deep % gw) * tw, (t_deep // gw) * th
    da, db, dc, dr = gaussians(deep, 0.6, 1.2, 0.5)
    a, b, c, r = (np.concatenate(v) for v in ((a, da), (b, db), (c, dc), (r, dr)))
    mx = np.concatenate([mx, x0 + dr + rng.uniform(0, 1, deep) * (tw - 2 * dr)])
    my = np.concatenate([my, y0 + dr + rng.uniform(0, 1, deep) * (th - 2 * dr)])
    opac = np.concatenate([opac, rng.uniform(0.01, 0.05, deep)])
    n += deep
    det = a * c - b * b
    dist = rng.uniform(1.0, 10.0, n)
    rect = np.stack([np.clip(np.floor((mx - r) / tw), 0, gw),
                     np.clip(np.floor((my - r) / th), 0, gh),
                     np.clip(np.floor((mx + r + tw - 1) / tw), 0, gw),
                     np.clip(np.floor((my + r + th - 1) / th), 0, gh)], -1)
    valid = ((rect[:, 2] > rect[:, 0]) & (rect[:, 3] > rect[:, 1])
             & (rect[:, 2] <= gw - 1))
    cols = [mx, my, c / det, -b / det, a / det, opac, dist / 10.0]
    cols += [rng.uniform(0, 1, n) for _ in range(3)] + [dist]
    cols += [rng.normal(size=n) for _ in range(7)]
    cols += [rng.normal(size=n) if flow else np.zeros(n) for _ in range(6)]
    packed = torch.tensor(np.stack(cols, -1).astype(np.float32), device=device)
    rect = torch.tensor(rect.astype(np.int32), device=device)
    depth = torch.tensor(dist.astype(np.float32), device=device)
    valid = torch.tensor(valid, device=device)
    capacity = config.capacity_for(n)
    return (packed, (rect, depth, valid, capacity),
            bin_gaussians_flat(rect, depth, valid, config, capacity))


def gathered(packed, ids, fill):
    """Rows of ``packed`` at ``ids``; rows of id -1 are ``fill``."""
    import torch

    rows = packed[ids.clamp(min=0).long()]
    return torch.where((ids >= 0)[..., None], rows, torch.full_like(rows, fill))


def compare_twins(flat_res, dense_res, slot, present, what):
    """A flat kernel's output against its dense twin's on the same
    Gaussians: the (T, PIX, 32) blocks, and the per-row outputs mapped
    stream slot <-> (tile, lane) (every other slot of the flat output must
    be 0, as every lane of the dense one past its tile's count). Returns
    the max |err| and whether all of it is bitwise equal."""
    import torch

    (f_blk, f_rows), (d_blk, d_rows) = flat_res, dense_res
    mask = present.reshape(present.shape + (1,) * (f_rows.dim() - 1))
    mapped = torch.where(mask, f_rows[slot], 0.0)
    outside = f_rows.clone()
    outside[slot[present]] = 0
    if bool(outside.any()):
        raise AssertionError(f"{what}: flat output non-zero outside the tiles' rows")
    worst, equal = 0.0, True
    for a, b, atol, rtol in ((f_blk, d_blk, ATOL, RTOL),
                             (mapped, d_rows, ATOL_BWD, RTOL_BWD)):
        if a is None:
            continue
        err = (a - b).abs()
        if bool((err > atol + rtol * b.abs()).any()):
            raise AssertionError(f"{what}: flat and dense kernels differ "
                                 f"(max {float(err.max()):.3g})")
        worst = max(worst, float(err.max()))
        equal = equal and bool(torch.equal(a, b))
    return worst, equal


def phase_kernels_flat(device, worst, per_tile=200, deep=16_500):
    """The flat-stream kernels against their plain versions and against
    their dense twins on the same Gaussians."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.binning import bin_gaussians
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.kernels.dense import _bg_to_tiles, _default_origins
    from gftorf_tpu_torch.render.settings import RasterConfig

    rng = np.random.default_rng(SEED + 1)
    cases = []
    for gates, flow in ((True, True), (True, False), (False, True), (False, False)):
        cases.append((RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                                   need_dd=gates, need_distribution=gates,
                                   flat_stream=True), flow))
    for gates, flow in ((True, True), (False, False)):
        cases.append((RasterConfig(height=180, width=250, tile_h=16, tile_w=16,
                                   need_dd=gates, need_distribution=gates,
                                   flat_stream=True), flow))
    twin_worst, twins_equal = 0.0, True
    for cfg, flow in cases:
        packed, (rect, depth, valid, capacity), fb = synthetic_stream(
            rng, cfg, flow, device, per_tile, deep)
        T = cfg.num_tiles
        start, count = fb.tile_start, fb.tile_count
        origins = _default_origins(T, cfg, device)
        bg = rng.uniform(0, 1, (7, cfg.height, cfg.width)).astype(np.float32)
        bg = _bg_to_tiles(torch.tensor(bg, device=device), T, cfg)
        stream_nan = gathered(packed, fb.gauss_flat, float("nan"))
        stream = gathered(packed, fb.gauss_flat, 0.0)
        plain_cfg = dataclasses.replace(cfg, tile_chunk=4)  # (4, PIX, L) temporaries
        out, contrib = flat.composite_forward_flat_cuda(stream_nan, bg, start,
                                                        count, origins, cfg)
        ref_out, ref_contrib = flat.composite_forward_flat_plain(
            stream, bg, start, count, origins, plain_cfg)
        g = cotangent(rng, cfg, device)
        dfeat = flat.composite_backward_flat_cuda(stream_nan, bg, out, g, start,
                                                  count, origins, cfg, flow)
        ref_dfeat = flat.composite_backward_flat_plain(
            stream, bg, out, g, start, count, origins, plain_cfg, flow)
        torch.cuda.synchronize()
        depth_max = int(count.max())
        what = (f"flat {cfg.width}x{cfg.height} tiles {cfg.tile_h}x{cfg.tile_w} "
                f"K_pad={stream.shape[0]} gates={cfg.need_dd} flow={flow}")
        err, lanes = compare(out, contrib, ref_out, ref_contrib, what)
        err_b, rows_b = compare_bwd(dfeat, ref_dfeat, lanes, what)
        if depth_max <= MAX_PER_TILE_LIMIT or int((count == 0).sum()) < cfg.grid_h:
            raise AssertionError(f"{what}: the stream lacks its deep or empty tiles")

        # The dense twin: the same Gaussians binned densely at an L that
        # holds the deepest tile.
        dcfg = dataclasses.replace(cfg, flat_stream=False,
                                   max_per_tile=depth_max)
        db = bin_gaussians(rect, depth, valid, dcfg, capacity)
        slot, present = flat.stream_slots(start, count)
        if not torch.equal(torch.where(present, fb.gauss_flat[slot], -1),
                           db.gauss_id[:, :slot.shape[1]]):
            raise AssertionError(f"{what}: flat and dense binnings disagree")
        feat_tl = gathered(packed, db.gauss_id, float("nan"))
        d_out, d_contrib = dense.composite_forward_cuda(feat_tl, bg, db.tile_count,
                                                        origins, dcfg)
        d_dfeat = dense.composite_backward_cuda(feat_tl, bg, d_out, g,
                                                db.tile_count, origins, dcfg, flow)
        L = slot.shape[1]
        e1, q1 = compare_twins((out, contrib), (d_out, d_contrib[:, :L]), slot,
                               present, what + " forward twin")
        e2, q2 = compare_twins((None, dfeat), (None, d_dfeat[:, :L]), slot,
                               present, what + " backward twin")
        twin_worst, twins_equal = max(twin_worst, e1, e2), twins_equal and q1 and q2
        worst["flat_forward"] = max(worst["flat_forward"], err)
        worst["flat_backward"] = max(worst["flat_backward"], err_b)
        log("kernels", f"{what}: tiles {T} ({int((count == 0).sum())} empty, "
            f"{int((count > flat.FLAT_ALIGN).sum())} spanning several blocks, "
            f"deepest {depth_max}), instances {int(count.sum())}; forward "
            f"max_abs_err {err:.3g}, contrib slots differing {lanes}; backward "
            f"max_abs_err {err_b:.3g}, rows past tolerance {rows_b}; against "
            f"the dense kernels at L={dcfg.max_per_tile}: max_abs_err "
            f"{max(e1, e2):.3g}, bitwise equal {q1 and q2}")
    log("kernels", f"ok: {len(cases)} flat cases, max_abs_err forward "
        f"{worst['flat_forward']:.3g}, backward {worst['flat_backward']:.3g}; "
        f"flat against dense kernels {twin_worst:.3g} (bitwise equal in every "
        f"case: {twins_equal})")


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

    def flat(self):
        """The same scene served on the flat-stream path."""
        import copy

        f = copy.copy(self)
        st = self.static
        f.static = dataclasses.replace(
            st, config_color=dataclasses.replace(st.config_color, flat_stream=True),
            config_tof=dataclasses.replace(st.config_tof, flat_stream=True))
        f.rasterize_calls = 0
        return f

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


def compare_outputs(got, ref, what):
    """Two renders' outputs by name (tensors on any device): integer
    outputs and the touched-pixel counts equal but in at most 0.1 % of
    their entries (lanes whose transmittance lies within ulps of T_STOP),
    the rest at atol 1e-4, rtol 1e-3. Returns the max |err|."""
    worst = 0.0
    for k, r in ref.items():
        v = got[k].to(r.device)
        if not v.is_floating_point() or k.endswith("pixels"):
            diff = int((v != r).sum())
            if diff > max(1, r.numel() // 1000):
                raise AssertionError(f"{what}: {k} differs in {diff}")
            continue
        err = (v - r).abs()
        if bool((err > E2E_ATOL + E2E_RTOL * r.abs()).any()):
            raise AssertionError(f"{what}: {k} max err {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


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
        worst = compare_outputs(outputs_of(*small.render(1)),
                                outputs_of(*small.to_cpu().render(1, device="cpu")),
                                f"{name} small")
        log("serve", f"{name}: 4000-Gaussian frame on the card matches the "
            f"CPU path (max abs err {worst:.3g})")
    log("serve", f"ok: {launches} kernel launches for {calls} rasterize calls")
    return scenes


def phase_serve_flat(scenes):
    """The served scenes again on the flat-stream path: each frame against
    the dense frame, then a timed pass; returns the flat scenes."""
    from gftorf_tpu_torch.render.kernels import dense, flat

    dense_frames = [[outputs_of(*s.render(fid)) for fid in range(len(s.frames))]
                    for s in scenes]
    flats = [s.flat() for s in scenes]
    dense.composite_forward_cuda.launches = 0
    flat.composite_forward_flat_cuda.launches = 0
    worst = 0.0
    for s, ref_frames in zip(flats, dense_frames):
        for fid, ref in enumerate(ref_frames):
            out = s.render(fid)
            check_frame(s, fid, out)
            worst = max(worst, compare_outputs(
                outputs_of(*out), ref, f"{s.name} flat frame {fid} vs dense"))
    results = [serve(s) for s in flats]
    launches = flat.composite_forward_flat_cuda.launches
    calls = sum(s.rasterize_calls for s in flats)
    if launches != calls or calls == 0 or dense.composite_forward_cuda.launches:
        raise AssertionError(
            f"{launches} flat and {dense.composite_forward_cuda.launches} dense "
            f"kernel launches for {calls} flat rasterize calls")
    for s, (times, out) in zip(flats, results):
        _, _, out_t = out
        log("serve-flat", f"{s.name}: {len(times)} frames, median "
            f"{statistics.median(times):.3f} ms/frame (all "
            f"{[round(t, 3) for t in times]}), num_rendered "
            f"{int(out_t.num_rendered)}, tile_max {int(out_t.tile_max)}, "
            f"tile_overflow {int(out_t.tile_overflow)}")
    log("serve-flat", f"ok: every flat frame matches the dense frame (max abs "
        f"err {worst:.3g}); {launches} flat forward launches for {calls} "
        "rasterize calls, 0 dense")
    return flats


# ---------------------------------------------------------------- phase 4


def tree_map(fn, tree):
    """``fn`` over the tensors of nested tuples and dicts."""
    import torch

    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def tree_items(tree, prefix=""):
    """(name, tensor) pairs of nested tuples and dicts."""
    import torch

    if torch.is_tensor(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}.{k}")
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from tree_items(v, f"{prefix}.{k}")


class TrainRun:
    """One training configuration on the card: the state of a 100k-point
    scene (or ``n_points``) in the Trainer's sorted layout, frames whose
    targets are the port's own renders of the unjittered model, and the
    StepStatic that ``Trainer._static_for`` (train/loop.py:279-365)
    builds from configs/<name>.json. ``dxyz_scale`` scales the deform
    MLP's d_xyz head at init (near zero by default, as the reference
    initialises it)."""

    def __init__(self, name, n_points, capacity, device, random_bg=True,
                 n_frames=4, jitter=0.02, dxyz_scale=1.0):
        import functools

        import numpy as np
        import torch

        from gftorf_tpu_torch.config import Config
        from gftorf_tpu_torch.models.deform import (
            DeformConfig, apply_deform, deform_params, init_deform)
        from gftorf_tpu_torch.models.gaussians import (
            AdamState, GaussianAux, GaussianModelState, get_motion_mask)
        from gftorf_tpu_torch.train.evaluate import eval_frame
        from gftorf_tpu_torch.train.step import FrameData

        cfg = Config.from_json(os.path.join(ROOT, "configs", f"{name}.json"))
        self.cfg, self.name, self.device = cfg, name, device
        m, tpu = cfg.model, cfg.tpu
        self.random_bg = random_bg
        self.single = name == "ftorf"
        self.size_c = (int(m.color_image_width * m.color_scale_factor),
                       int(m.color_image_height * m.color_scale_factor))
        self.size_t = (int(m.tof_image_width * m.tof_scale_factor),
                       int(m.tof_image_height * m.tof_scale_factor))
        self.max_per_tile, self.dup_factor = tpu.max_per_tile, tpu.dup_factor
        self.dcfg = DeformConfig(
            depth=m.D, width=m.W, xyz_multires=m.xyz_multires,
            t_multires=m.t_multires, sh_degree=m.sh_degree,
            xavier_init_dxyz=m.xavier_init_dxyz,
            isotropic=m.isotropic_gaussians)
        seed = SEED + 10 + (0 if self.single else 1)
        self.seed, self.flat = seed, False
        self.n_points = n_points
        params = serve_model(n_points, seed, device)
        pad = capacity - n_points
        params = type(params)(*(
            x if x.shape[0] == 1 else
            torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in params))
        alive = torch.arange(capacity, device=device) < n_points
        deform = deform_params(init_deform(
            self.dcfg, torch.Generator().manual_seed(seed), device=device))
        deform["heads.xyz.weight"] = deform["heads.xyz.weight"] * dxyz_scale

        def bucket(count):  # Trainer._update_deform_bucket (loop.py:242-266)
            b = 1024
            while b < int(count * 1.05) + 1:
                b *= 2
            return 0 if b >= capacity else b

        self.render_bucket = bucket(n_points)
        self.deform_bucket = bucket(int((get_motion_mask(params) & alive).sum()))

        # Targets: the unjittered model rendered by the port at each frame.
        self.frame_ids = [0, 2, 4, 6] if self.single else list(range(n_frames))
        cams = spiral_cameras(n_frames, self.size_c, self.size_t, m.depth_range,
                              seed, 0.0 if self.single else 0.05, device)
        (wc, hc), (wt, ht) = self.size_c, self.size_t
        mlp = functools.partial(apply_deform, deform, self.dcfg)
        frames = []
        for fid, (cam_c, cam_t) in zip(self.frame_ids, cams):
            k_tof = torch.tensor(
                [[float(cam_t.focal_x), 0, wt / 2], [0, float(cam_t.focal_y), ht / 2],
                 [0, 0, 1]], dtype=torch.float32, device=device)
            frame = FrameData(
                frame_id=torch.tensor(fid, dtype=torch.int32, device=device),
                cam_color=cam_c, cam_tof=cam_t,
                gt_image=torch.zeros((3, hc, wc), device=device),
                gt_phasor=torch.zeros((3, ht, wt), device=device),
                gt_quad=torch.zeros((4, ht, wt), device=device),
                gt_distance=torch.zeros((1, ht, wt), device=device),
                forward_flow=torch.zeros((2, ht, wt), device=device),
                backward_flow=torch.zeros((2, ht, wt), device=device),
                has_forward_flow=torch.tensor(True, device=device),
                has_backward_flow=torch.tensor(True, device=device),
                phase_offset=torch.tensor(0.1, device=device),
                dc_offset=torch.tensor(0.02, device=device),
                intrinsics_tof=k_tof, intrinsics_color=k_tof)
            while True:
                _, out_c, out_t = eval_frame(self.static_for(2101, fid % 4 == 0),
                                             params, mlp, alive, frame,
                                             device=device)
                worst = max(int(out_c.tile_max), int(out_t.tile_max))
                if worst <= self.max_per_tile:
                    break
                self.grow(worst)
            frames.append(frame._replace(
                gt_image=out_c.color, gt_phasor=out_t.phasor[:3],
                gt_quad=out_t.phasor[3:7], gt_distance=out_t.depth))
        self.frames = stack_frames(frames)

        rng = np.random.default_rng(seed)
        noise = torch.tensor(rng.normal(0, jitter, (n_points, 3)),
                             dtype=torch.float32, device=device)
        params = params._replace(xyz=params.xyz + torch.cat(
            [noise, noise.new_zeros((pad, 3))]))
        zeros = type(params)(*(torch.zeros_like(x) for x in params))
        self.model = GaussianModelState(
            params=params,
            aux=GaussianAux(alive=alive,
                            **{k: torch.zeros(capacity, device=device)
                               for k in ("max_radii2d", "xyz_grad_accum", "denom")}),
            adam=AdamState(mu=zeros, nu=zeros, step=torch.tensor(
                0, dtype=torch.int32, device=device)))
        self.deform = deform
        dz = {k: torch.zeros_like(v) for k, v in deform.items()}
        self.deform_adam = AdamState(mu=dz, nu=dict(dz), step=torch.tensor(
            0, dtype=torch.int32, device=device))
        self.generator = torch.Generator(device).manual_seed(seed)
        self.rasterize_calls = 0
        # train_step is pure, so these tensors stay the starting state.
        self.initial = (self.model, self.deform, self.deform_adam)

    def restart(self, flat):
        """This run back at its starting state (with its grown buffers and a
        fresh generator), on the flat-stream path or the dense one."""
        import copy

        import torch

        r = copy.copy(self)
        r.flat = flat
        r.model, r.deform, r.deform_adam = self.initial
        r.generator = torch.Generator(self.device).manual_seed(self.seed)
        r.rasterize_calls = 0
        return r

    def grow(self, worst):
        """Grow max_per_tile past the deepest tile, as the Trainer does on
        overflow (the step is then replayed)."""
        self.max_per_tile = -(-int(worst * 1.35) // 128) * 128

    def static_for(self, it, flow_frame):
        """StepStatic as Trainer._static_for(it, flow_frame) builds it."""
        from gftorf_tpu_torch.render.settings import RasterConfig
        from gftorf_tpu_torch.train.step import SchedStatic, StepStatic

        m, opt, tpu = self.cfg.model, self.cfg.opt, self.cfg.tpu
        dynamic_on = m.dynamic and it > opt.warm_up
        regions = ("dynamic",) if self.name == "torf" else ("static", "dynamic")
        dd_on = (opt.lambda_dd != 0.0
                 and opt.dd_loss_iter_end > opt.dd_loss_iter_start + 1)
        flow_on = self.name == "ftorf" and opt.lambda_flow != 0.0 and dynamic_on

        def raster(size, need_dd):
            return RasterConfig(
                height=size[1], width=size[0], tile_h=tpu.tile_h,
                tile_w=tpu.tile_w, max_per_tile=self.max_per_tile,
                dup_factor=self.dup_factor, sh_degree=m.sh_degree,
                need_dd=need_dd, need_distribution=False,
                flat_stream=self.flat)

        return StepStatic(
            scene_type=self.name, config_color=raster(self.size_c, False),
            config_tof=raster(self.size_t, dd_on), deform=self.dcfg,
            active_sh_degree=min(it // 1000, m.sh_degree),
            total_num_views=m.total_num_views, render_regions=regions,
            dynamic_on=dynamic_on,
            sync_phase=opt.use_quad and opt.warm_up < it <= opt.optimize_sync_iters,
            use_quad=opt.use_quad, use_wl1c=opt.use_wl1c,
            use_wl1p=opt.use_wl1p, wl1p_e=opt.wl1p_e,
            num_phasor_channels=opt.num_phasor_channels,
            color_on=opt.lambda_color != 0.0 or 0 < opt.tof_iters < opt.iterations,
            depth_on=opt.lambda_depth != 0.0, dd_on=dd_on,
            oe_on=opt.use_opacity_entropy_loss, scale_on=opt.use_scale_loss,
            mlp_reg_on=opt.lambda_mlp_reg != 0.0, flow_on=flow_on,
            flow_frame=flow_frame if flow_on else None,
            optimize_phase_offset=opt.optimize_phase_offset,
            optimize_dc_offset=opt.optimize_dc_offset,
            random_bg=self.random_bg and m.random_bg_color,
            bg_color=(tuple(m.bg_color) if self.random_bg
                      else (0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2)),
            scene_extent=5.0, single_camera=self.single,
            deform_sync=it <= opt.optimize_sync_iters,
            frozen_gauss=it >= opt.densify_until_iter,
            sched=SchedStatic.from_opt(opt, opt.lambda_color,
                                       opt.opacity_reset_interval),
            deform_bucket=self.deform_bucket, render_bucket=self.render_bucket,
            compact_layout=True, deform_clip=tpu.deform_clip)

    def run_step(self, it, idx, generator=None):
        """One train_step from the current state; returns its outputs and
        metrics by name (no state change)."""
        from gftorf_tpu_torch.train.step import METRIC_NAMES, train_step

        fid = self.frame_ids[idx]
        static = self.static_for(it, fid % 4 == 0)
        self.rasterize_calls += 1 if static.single_camera else 2
        out = train_step(static, self.model, self.deform, self.deform_adam,
                         self.frames, idx, it, generator or self.generator)
        return out, dict(zip(METRIC_NAMES, out[3].tolist()))

    def step(self, it, idx):
        """One accepted step: replayed from the same state and random
        stream after growing the buffers while a render overflows (the
        Trainer's grow-and-replay, train/loop.py:532-600)."""
        while True:
            rng_state = self.generator.get_state()
            out, metrics = self.run_step(it, idx)
            if metrics["tile_overflow"] == 0 and metrics["dup_overflow"] == 0:
                break
            if metrics["dup_overflow"]:
                self.dup_factor *= 2
            if metrics["tile_overflow"]:
                self.grow(metrics["tile_max"])
            self.generator.set_state(rng_state)
        self.model, self.deform, self.deform_adam = out[:3]
        return metrics

    def to_cpu(self):
        """The same run on the CPU (the plain kernels' path)."""
        import copy

        import torch

        cpu = copy.copy(self)
        cpu.device = torch.device("cpu")
        move = lambda t: t.cpu()  # noqa: E731
        cpu.model = tree_map(move, self.model)
        cpu.deform = tree_map(move, self.deform)
        cpu.deform_adam = tree_map(move, self.deform_adam)
        cpu.frames = tree_map(move, self.frames)
        return cpu


def stack_frames(frames):
    """The stacked dataset (leading N axis) of a list of FrameData."""
    import torch

    def stack(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack(*col) for col in zip(*xs)))
        return torch.stack(xs)

    return stack(*frames)


def train_run(run, steps):
    """``steps`` accepted steps of ``run`` (iterations 2101...), timed on
    the host clock; checks that every state leaf and loss is finite and
    that the loss falls. Sets ``run.ms_per_step`` (median after one warm-up
    step) and ``run.steps``; returns the times, the losses and the last
    step's metrics."""
    import torch

    times, losses, last = [], [], None
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = run.step(2101 + k, k % len(run.frame_ids))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(last["loss"])
    what = f"{run.name}{' flat' if run.flat else ''}"
    for name, t in tree_items((run.model, run.deform, run.deform_adam)):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: state{name} not finite")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: loss not finite: {losses}")
    if not statistics.mean(losses[-5:]) < statistics.mean(losses[:5]):
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    run.ms_per_step, run.steps = statistics.median(times[1:]), steps
    return times, losses, last


def phase_train(device, n_points=100_000, capacity=200_000):
    from gftorf_tpu_torch.render.kernels import dense

    runs = [(TrainRun("ftorf", n_points, capacity, device), 20),
            (TrainRun("torf", n_points, capacity, device), 10)]
    dense.composite_forward_cuda.launches = 0
    dense.composite_backward_cuda.launches = 0
    calls0 = sum(r.rasterize_calls for r, _ in runs)
    for run, steps in runs:
        times, losses, last = train_run(run, steps)
        first, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log("train", f"{run.name}: {steps} steps (iterations 2101-{2100 + steps}) "
            f"of {run.n_points} Gaussians in a capacity of "
            f"{run.model.aux.alive.shape[0]}, "
            f"{'1 camera' if run.single else '2 cameras'}, median "
            f"{run.ms_per_step:.3f} ms/step after one warm-up step (all "
            f"{[round(t, 3) for t in times]}); loss first five {first:.6g}, "
            f"last five {tail:.6g} (all {[round(v, 6) for v in losses]}); "
            f"num_rendered {int(last['num_rendered'])}, tile_max "
            f"{int(last['tile_max'])}, max_per_tile {run.max_per_tile}, "
            f"visible {int(last['visible'])}")
    calls = sum(r.rasterize_calls for r, _ in runs) - calls0
    fwd = dense.composite_forward_cuda.launches
    bwd = dense.composite_backward_cuda.launches
    if not (fwd == bwd == calls) or calls == 0:
        raise AssertionError(f"{fwd} forward and {bwd} backward launches for "
                             f"{calls} differentiated rasterize calls")
    steps = sum(n for _, n in runs)
    log("train", f"ok: {fwd} forward and {bwd} backward kernel launches for "
        f"{calls} differentiated rasterize calls in {steps} steps (and their "
        "replays)")
    return [r for r, _ in runs], {"dense_forward": fwd, "dense_backward": bwd}


def phase_train_flat(runs):
    """Both training runs again from their starting state on the flat-
    stream path: the first step against the dense step, then the run."""
    import torch

    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.train.step import _deform_lr_at, _gaussian_lrs_at

    dense_first = []
    for run in runs:
        ref, m = run.restart(flat=False).run_step(
            2101, 0, torch.Generator(run.device).manual_seed(11))
        if m["tile_overflow"] or m["dup_overflow"]:
            raise AssertionError(f"{run.name}: the dense reference step overflows")
        dense_first.append((ref, m))
    flats = [run.restart(flat=True) for run in runs]
    for name in ("forward", "backward"):
        getattr(dense, f"composite_{name}_cuda").launches = 0
        getattr(flat, f"composite_{name}_flat_cuda").launches = 0
    for run, (ref, ref_m) in zip(flats, dense_first):
        got, m = run.run_step(2101, 0, torch.Generator(run.device).manual_seed(11))
        static = run.static_for(2101, True)
        w = compare_steps(got, ref, _gaussian_lrs_at(static, 2101),
                          _deform_lr_at(static, 2101), f"{run.name} flat vs dense")
        log("train-flat", f"{run.name}: first step flat against dense from one "
            f"state and generator seed: loss {m['loss']:.7g} vs "
            f"{ref_m['loss']:.7g}, worst mu error / max|leaf| "
            f"{w['gaussians']:.3g} (Gaussians), {w['mlp']:.3g} (deform MLP)")
        dense_ms = run.ms_per_step
        times, losses, last = train_run(run, run.steps)
        first, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log("train-flat", f"{run.name}: {run.steps} flat steps, median "
            f"{run.ms_per_step:.3f} ms/step (dense {dense_ms:.3f}; all "
            f"{[round(t, 3) for t in times]}); loss first five {first:.6g}, "
            f"last five {tail:.6g}; num_rendered {int(last['num_rendered'])}, "
            f"tile_max {int(last['tile_max'])}, tile_overflow "
            f"{int(last['tile_overflow'])}")
    calls = sum(r.rasterize_calls for r in flats)
    fwd = flat.composite_forward_flat_cuda.launches
    bwd = flat.composite_backward_flat_cuda.launches
    dense_n = (dense.composite_forward_cuda.launches
               + dense.composite_backward_cuda.launches)
    if not (fwd == bwd == calls) or calls == 0 or dense_n:
        raise AssertionError(f"{fwd} flat forward, {bwd} flat backward and "
                             f"{dense_n} dense launches for {calls} "
                             "differentiated flat rasterize calls")
    log("train-flat", f"ok: {fwd} flat forward and {bwd} flat backward launches "
        f"for {calls} differentiated rasterize calls, 0 dense")
    return flats, {"flat_forward": fwd, "flat_backward": bwd}


# ---------------------------------------------------------------- phase 5


def compare_steps(got, ref, lrs, deform_lr, what, hidden_frac=MU_ATOL_FRAC,
                  skip=()):
    """One step's outputs against a reference run's, at the CPU parity
    tests' tolerances (tests/torch_port_util.py): metrics at rtol 1e-5
    (the integer counts of binning up to 0.1 %, as phase 3 holds integer
    outputs; the names in ``skip`` not at all), Adam mu and nu of every
    leaf, the densify stats and the new parameters (atol 2 lr).
    ``hidden_frac`` replaces the mu atol fraction (and scales nu's) for the
    deform MLP's hidden layers. Returns the worst mu error over max|leaf|
    of the Gaussians and of the MLP."""
    import torch

    from gftorf_tpu_torch.train.step import METRIC_NAMES

    (gm, gd, gda, gp), (rm, rd, rda, rp) = got, ref
    for i, name in enumerate(METRIC_NAMES):
        if name in skip:
            continue
        a, b = float(gp[i]), float(rp[i])
        tol = (METRIC_RTOL if name in ("loss", "l1_color", "l1_p", "flow_l2")
               else 1e-3) * abs(b)
        if abs(a - b) > tol:
            raise AssertionError(f"{what}: metric {name} {a} vs {b}")

    worst = {"gaussians": 0.0, "mlp": 0.0}
    bad = []
    for which, frac, rtol in (("mu", MU_ATOL_FRAC, MU_RTOL),
                              ("nu", NU_ATOL_FRAC, NU_RTOL)):
        for (name, x), (_, y) in zip(
                tree_items((getattr(gm.adam, which), getattr(gda, which))),
                tree_items((getattr(rm.adam, which), getattr(rda, which)))):
            x, y = x.cpu(), y.cpu()
            top = float(y.abs().max())
            if top == 0.0:
                continue
            f = frac * (hidden_frac / MU_ATOL_FRAC if ".hidden." in name else 1.0)
            if bool(((x - y).abs() > f * top + rtol * y.abs()).any()):
                bad.append(f"{which}{name}")
            if which == "mu":
                group = "gaussians" if name.startswith(".0.") else "mlp"
                worst[group] = max(worst[group],
                                   float((x - y).abs().max()) / top)
    for name in ("denom", "max_radii2d"):
        x, y = getattr(gm.aux, name).cpu(), getattr(rm.aux, name).cpu()
        if int((x != y).sum()) > max(1, y.numel() // 1000):
            bad.append(f"aux.{name} ({int((x != y).sum())} rows)")
    x, y = gm.aux.xyz_grad_accum.cpu(), rm.aux.xyz_grad_accum.cpu()
    if bool(((x - y).abs() > MU_ATOL_FRAC * float(y.abs().max())
             + MU_RTOL * y.abs()).any()):
        bad.append("aux.xyz_grad_accum")
    for name in gm.params._fields:
        lr = getattr(lrs, name)
        lr = lr.cpu() if torch.is_tensor(lr) else lr
        x, y = getattr(gm.params, name).cpu(), getattr(rm.params, name).cpu()
        if bool(((x - y).abs() > 2 * lr + 1e-7 * y.abs()).any()):
            bad.append(f"params.{name}")
    for k in gd:
        x, y = gd[k].cpu(), rd[k].cpu()
        if bool(((x - y).abs() > 2 * deform_lr + 1e-7 * y.abs()).any()):
            bad.append(f"deform.{k}")
    if bad:
        raise AssertionError(f"{what}: past tolerance: {bad}; worst mu "
                             f"error / max|leaf| {worst}")
    return worst


class plain_compositor:
    """Within the block, the compositor runs its plain versions on the
    card too (the dispatchers that DenseComposite calls are swapped), so a
    step can be compared with and without the kernels on one device."""

    def __enter__(self):
        from gftorf_tpu_torch.render.kernels import dense

        self.saved = dense.composite_forward, dense.composite_backward
        dense.composite_forward = dense.composite_forward_plain
        dense.composite_backward = dense.composite_backward_plain

    def __exit__(self, *exc):
        from gftorf_tpu_torch.render.kernels import dense

        dense.composite_forward, dense.composite_backward = self.saved


# The deform MLP's hidden-layer gradients on the card and on the CPU differ
# by up to ~1.5e-3 of the leaf's max (measured by this phase on an H100,
# also with the plain compositor on the card, so not from the kernels):
# the products of eight ReLU layers round differently in cuBLAS and the
# CPU's BLAS, and a pre-activation within rounding of zero flips its ReLU.
# Those layers are held at atol 5e-3 * max|leaf| between card and CPU;
# everything else, and the kernels against the plain versions on the
# card, at the CPU tests' tolerances.
HIDDEN_CARD_CPU_FRAC = 5e-3


def phase_train_vs_cpu(device, n_points=4000, capacity=10_000):
    import torch

    from gftorf_tpu_torch.train.step import _deform_lr_at, _gaussian_lrs_at

    # A constant bg (the random streams of the card and the CPU differ),
    # and a d_xyz head large enough that the flow vectors, differences of
    # two deformations, stand well above the rounding of the MLP's
    # products (as the CPU parity tests draw their deform heads).
    for name in ("ftorf", "torf"):
        run = TrainRun(name, n_points, capacity, device, random_bg=False,
                       dxyz_scale=1000.0)
        while True:  # grow the buffers until the step does not overflow
            out, m = run.run_step(2101, 0)
            if m["tile_overflow"] == 0 and m["dup_overflow"] == 0:
                break
            run.grow(m["tile_max"])
        with plain_compositor():
            plain, _ = run.run_step(2101, 0)
        ref, _ = run.to_cpu().run_step(2101, 0, torch.Generator().manual_seed(0))
        static = run.static_for(2101, True)
        lrs, d_lr = _gaussian_lrs_at(static, 2101), _deform_lr_at(static, 2101)
        k = compare_steps(out, plain, lrs, d_lr, f"{name} kernels vs plain")
        c = compare_steps(out, ref, lrs, d_lr, f"{name} card vs cpu",
                          hidden_frac=HIDDEN_CARD_CPU_FRAC)
        log("train-vs-cpu", f"{name}: one step of {n_points} Gaussians "
            f"(loss {m['loss']:.6g}); kernels vs plain compositor on the "
            f"card: worst mu error / max|leaf| {k['gaussians']:.3g} "
            f"(Gaussians), {k['mlp']:.3g} (deform MLP); card vs CPU path: "
            f"{c['gaussians']:.3g}, {c['mlp']:.3g}")
    log("train-vs-cpu", "ok")


def crowded_scene(device, n_bg, n_crowd, seed=SEED + 20):
    """rasterize inputs of a full-width scene: ``n_bg`` Gaussians spread over
    the view of a camera at the origin looking down +z, and ``n_crowd``
    small, faint ones in front of one 16x32 tile (pixel offsets 8-24 px to
    one side of the image centre and under 3.5 px from it vertically, so
    that each lies in that tile whichever way the axes point)."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.ops.transforms import projection_matrix, world_to_view
    from gftorf_tpu_torch.render.settings import CameraSpec

    rng = np.random.default_rng(seed)
    W, H, fov_x = 320, 240, 0.9
    fov_y = 2.0 * np.arctan(np.tan(fov_x / 2) * H / W)
    focal = W / (2.0 * np.tan(fov_x / 2))
    z = np.concatenate([rng.uniform(2.0, 9.0, n_bg), rng.uniform(3.0, 6.0, n_crowd)])
    u = np.concatenate([rng.uniform(-0.5, 0.5, n_bg) * z[:n_bg],
                        rng.uniform(8.0, 24.0, n_crowd) / focal * z[n_bg:]])
    v = np.concatenate([rng.uniform(-0.4, 0.4, n_bg) * z[:n_bg],
                        rng.uniform(-3.5, 3.5, n_crowd) / focal * z[n_bg:]])
    n = n_bg + n_crowd
    quat = rng.normal(size=(n, 4))
    x = dict(
        means3d=np.stack([u, v, z], -1),
        scales=np.concatenate([rng.uniform(0.005, 0.04, (n_bg, 3)),
                               np.full((n_crowd, 3), 0.002)]),
        rotations=quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        opacities=np.concatenate([rng.uniform(0.05, 0.95, n_bg),
                                  rng.uniform(0.01, 0.05, n_crowd)]),
        shs=0.3 * rng.normal(size=(n, 16, 3)), shs_p=0.2 * rng.normal(size=(n, 16, 2)),
        means2d_ndc=np.zeros((n, 2)), bg_map=rng.uniform(0, 1, (7, H, W)),
    )
    x["shs_p"][:, 0, 1] += 1.0
    x = {k: torch.tensor(val.astype(np.float32), device=device) for k, val in x.items()}
    cam = CameraSpec.create(world_to_view(np.eye(3), np.zeros(3)),
                            projection_matrix(0.1, 50.0, fov_x, fov_y), W, H,
                            fov_x, fov_y, 0.1, 50.0, 15.0, device=device)
    return x, cam


def phase_deep_tile(device, n_bg=100_000, n_crowd=20_000):
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.rasterize import composite_inputs, rasterize
    from gftorf_tpu_torch.render.settings import RasterConfig

    x, cam = crowded_scene(device, n_bg, n_crowd)
    args = (x["means3d"], x["scales"], x["rotations"], x["opacities"], x["shs"],
            x["shs_p"], 0.1, 0.02, x["means2d_ndc"], x["bg_map"], cam)
    base = RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                        max_per_tile=MAX_PER_TILE_LIMIT)
    fcfg = dataclasses.replace(base, flat_stream=True)
    with torch.no_grad():
        out_flat = rasterize(*args, fcfg)
        deepest = int(out_flat.tile_max)
        capped = rasterize(*args, base)
        big = dataclasses.replace(base, max_per_tile=deepest)
        out_big = rasterize(*args, big)
    if not (deepest > MAX_PER_TILE_LIMIT and int(capped.tile_overflow) > 0
            and int(out_flat.tile_overflow) == 0 and int(out_big.tile_overflow) == 0):
        raise AssertionError(
            f"deepest tile {deepest}: dense at {MAX_PER_TILE_LIMIT} overflows by "
            f"{int(capped.tile_overflow)}, flat by {int(out_flat.tile_overflow)}")
    worst = compare_outputs(out_flat._asdict(),
                            {k: v for k, v in out_big._asdict().items()
                             if v is not None}, "deep tile flat vs dense")

    # The kernels on the step's own blocks, flat against dense at L=deepest.
    with torch.no_grad():
        fi = composite_inputs(*args, fcfg)
        di = composite_inputs(*args, big)
    fb, db = fi.binning, di.binning
    fwd = (fi.feat, fi.bg_tiles, fb.tile_start, fb.tile_count, fi.origins, fcfg)
    out, contrib = flat.composite_forward_flat_cuda(*fwd)
    d_out, d_contrib = dense.composite_forward_cuda(di.feat, di.bg_tiles,
                                                    db.tile_count, di.origins, big)
    g = cotangent(np.random.default_rng(SEED), fcfg, device)
    bwd = (fi.feat, fi.bg_tiles, out, g, fb.tile_start, fb.tile_count,
           fi.origins, fcfg, False)
    dfeat = flat.composite_backward_flat_cuda(*bwd)
    d_dfeat = dense.composite_backward_cuda(di.feat, di.bg_tiles, d_out, g,
                                            db.tile_count, di.origins, big, False)
    slot, present = flat.stream_slots(fb.tile_start, fb.tile_count)
    L = slot.shape[1]
    e1, q1 = compare_twins((out, contrib), (d_out, d_contrib[:, :L]), slot,
                           present, "deep tile forward")
    e2, q2 = compare_twins((None, dfeat), (None, d_dfeat[:, :L]), slot, present,
                           "deep tile backward")
    times = {
        "flat_forward": time_ms(lambda: flat.composite_forward_flat_cuda(*fwd), 5),
        "flat_backward": time_ms(lambda: flat.composite_backward_flat_cuda(*bwd), 3),
        "dense_forward": time_ms(lambda: dense.composite_forward_cuda(
            di.feat, di.bg_tiles, db.tile_count, di.origins, big), 5),
        "dense_backward": time_ms(lambda: dense.composite_backward_cuda(
            di.feat, di.bg_tiles, d_out, g, db.tile_count, di.origins, big,
            False), 3),
    }
    log("deep-tile", f"{n_bg} + {n_crowd} Gaussians at 320x240, 16x32 tiles: "
        f"deepest tile {deepest} instances, num_rendered "
        f"{int(out_flat.num_rendered)}, K_pad {fi.feat.shape[0]}; dense at "
        f"max_per_tile {MAX_PER_TILE_LIMIT}: tile_overflow "
        f"{int(capped.tile_overflow)}; flat: tile_overflow "
        f"{int(out_flat.tile_overflow)}; flat frame vs dense at L={big.max_per_tile}: "
        f"max abs err {worst:.3g}; flat kernels vs dense kernels: max abs err "
        f"{max(e1, e2):.3g}, bitwise equal {q1 and q2}")
    log("deep-tile", "kernel ms on this scene: " + "; ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    log("deep-tile", "ok")


# ---------------------------------------------------------------- phase 6


def phase_determinism(scenes, runs):
    """``scenes`` and ``runs`` hold the dense and the flat ones."""
    import torch

    for s in scenes:
        a = outputs_of(*s.render(5 if s.name == "ftorf" else 1))
        b = outputs_of(*s.render(5 if s.name == "ftorf" else 1))
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        if diff:
            raise AssertionError(f"{s.name}: not bitwise repeatable: {diff}")
        log("determinism", f"ok: {s.name} "
            f"{'flat' if s.static.config_tof.flat_stream else 'dense'}: "
            f"{len(a)} outputs of a served frame bitwise equal on re-render")
    for run in runs:
        outs = [dict(tree_items(run.run_step(
            2121, 0, torch.Generator(run.device).manual_seed(7))[0]))
            for _ in range(2)]
        diff = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
        if diff:
            raise AssertionError(f"{run.name}: training step not bitwise "
                                 f"repeatable: {diff}")
        log("determinism", f"ok: {run.name} {'flat' if run.flat else 'dense'} "
            f"training step (random bg, one generator seed) run twice: "
            f"{len(outs[0])} output tensors (parameters, Adam moments, "
            "densify stats, metrics) bitwise equal")


# ---------------------------------------------------------------- trainer


TRAINER_DIR = os.path.join(ROOT, "build", "trainer")
# The verify recipe: 64x48, 8 frames, 2,000 points, 120 iterations.
VERIFY_CFG = dict(total_num_views=8, tof_image_width=64, tof_image_height=48,
                  color_image_width=64, color_image_height=48, depth_range=15.0,
                  num_points=2000, iterations=120, warm_up=20, use_quad=True,
                  dynamic=True, dataset_type="quad", random_bg_color=True)


class recorded:
    """Wrap ``owner.name`` for a ``with`` block: each call is timed on the
    host clock between two device synchronisations and its ms appended to
    ``self.ms``, its return value to ``self.results`` (and, with
    ``keep_args``, its positional arguments to ``self.args``)."""

    def __init__(self, owner, name, device, keep_args=False):
        self.owner, self.name, self.device = owner, name, device
        self.keep_args = keep_args
        self.ms, self.results, self.args = [], [], []

    def __enter__(self):
        import torch

        fn = self.orig = getattr(self.owner, self.name)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))

        def wrapped(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            self.ms.append(1e3 * (time.perf_counter() - t0))
            self.results.append(out)
            if self.keep_args:
                self.args.append(a)
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def reset_launches():
    from gftorf_tpu_torch.render.kernels import dense, flat

    for fn in (dense.composite_forward_cuda, dense.composite_backward_cuda,
               flat.composite_forward_flat_cuda, flat.composite_backward_flat_cuda,
               dense.check_backward_fits):
        fn.launches = 0


def read_launches():
    from gftorf_tpu_torch.render.kernels import dense, flat

    return {"dense_forward": dense.composite_forward_cuda.launches,
            "dense_backward": dense.composite_backward_cuda.launches,
            "flat_forward": flat.composite_forward_flat_cuda.launches,
            "flat_backward": flat.composite_backward_flat_cuda.launches,
            FIT_CHECK: dense.check_backward_fits.launches}


def write_trainer_datasets(device, width=320, height=240, n_ftorf=16, n_torf=8):
    """The port's writer: an ftorf ``room`` scene at the configs' ToF size,
    a ToRF-layout one in a real capture's layout (ToF at width x height,
    colour at twice that, as configs/torf.json reads 640x480 at 0.5; .mat
    intrinsics; a colour camera offset from the ToF camera by
    relative_pose.npy: two cameras), and the verify recipe's 64x48 scene.
    The ToRF colour stream comes from a second write of the same seed and
    layout at twice the size, which must share the first's poses and
    Gaussians; its color/ and colour intrinsics replace the first's."""
    import shutil

    import numpy as np
    import scipy.io
    import torch

    from gftorf_tpu_torch.data.generate import write_dataset

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    paths = {k: os.path.join(TRAINER_DIR, k) for k in ("ftorf", "torf", "verify")}
    t0 = time.perf_counter()
    write_dataset(paths["ftorf"], num_frames=n_ftorf, width=width, height=height,
                  layout="room", seed=SEED + 30, device=device)
    big = paths["torf"] + "_2x"
    g_tof, g_col = (write_dataset(d, num_frames=n_torf, width=w, height=h,
                                  layout="room", torf_layout=True,
                                  seed=SEED + 31, device=device)
                    for d, w, h in ((paths["torf"], width, height),
                                    (big, 2 * width, 2 * height)))
    cams = os.path.join(paths["torf"], "cams")
    for name in ("tof_extrinsics", "color_extrinsics"):
        if not np.array_equal(np.load(os.path.join(cams, f"{name}.npy")),
                              np.load(os.path.join(big, "cams", f"{name}.npy"))):
            raise AssertionError(f"the two ToRF writes differ in {name}")
    if sorted(g_tof) != sorted(g_col) or not all(
            torch.equal(g_tof[k], g_col[k]) for k in g_tof
            if torch.is_tensor(g_tof[k])):
        raise AssertionError("the two ToRF writes drew different Gaussians")
    shutil.rmtree(os.path.join(paths["torf"], "color"))
    shutil.copytree(os.path.join(big, "color"), os.path.join(paths["torf"], "color"))
    shutil.copy(os.path.join(big, "cams", "color_intrinsics.npy"), cams)
    shutil.rmtree(big)
    for name in ("tof_intrinsics", "color_intrinsics"):
        k = np.load(os.path.join(cams, f"{name}.npy"))
        scipy.io.savemat(os.path.join(cams, f"{name}.mat"), {"K": k})
        os.remove(os.path.join(cams, f"{name}.npy"))
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.05, 0.0, 0.0]
    np.save(os.path.join(cams, "relative_pose.npy"), rel)
    write_dataset(paths["verify"], num_frames=VERIFY_CFG["total_num_views"],
                  width=VERIFY_CFG["tof_image_width"],
                  height=VERIFY_CFG["tof_image_height"], seed=SEED + 32,
                  device=device)
    secs = time.perf_counter() - t0
    log("trainer", f"datasets written by gftorf_tpu_torch.data.generate in "
        f"{secs:.2f} s: ftorf room {n_ftorf} frames at {width}x{height}, torf "
        f"room {n_torf} frames with ToF at {width}x{height} and colour at "
        f"{2 * width}x{2 * height} (a second write of the same seed: same "
        f"poses and Gaussians), verify {VERIFY_CFG['total_num_views']} "
        f"frames at 64x48")
    return paths


def train_cli(device, config, model_path, *flags, check=True):
    """``python -m gftorf_tpu_torch.train`` in this process; returns the
    Trainer, its records and the evaluations in its train_log.jsonl. With
    ``check`` (a run from iteration 1 that must stay finite) the records
    and evaluations must be finite and the records cover every
    iteration."""
    from gftorf_tpu_torch.train.__main__ import main

    tr = main(["--config", config, "--model_path", model_path,
               "--device", device.type, "--quiet", *map(str, flags)])
    with open(os.path.join(model_path, "train_log.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval" in r]
    recs = tr.history
    if not check:
        return tr, recs, evals
    bad = [r["iteration"] for r in recs
           if not all(math.isfinite(r[k]) for k in ("loss", "l1_p", "ema_loss"))]
    bad += [e["iteration"] for e in evals for split in e["eval"].values()
            for k, v in split.items() if v is not None and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{model_path}: records not finite at {bad}")
    if [r["iteration"] for r in recs] != list(range(1, tr.iteration + 1)):
        raise AssertionError(f"{model_path}: records of iterations "
                             f"{[r['iteration'] for r in recs]}")
    return tr, recs, evals


def check_artifacts(model_path, it):
    """The artifact tree of train.py, scene_bounds.png included (drawn
    without a plotting library)."""
    want = ["train_log.jsonl", "cfg_args_full.json", "cfg_args", "cameras.json",
            "cameras_full.json", "nerf_normalization.json", "input.ply",
            "scene_bounds.png"] + [
        f"point_cloud/iteration_{it}/{f}" for f in (
            "point_cloud.ply", "point_cloud_full.ply", "phase_offset.npy",
            "dc_offset.npy", "deform_model.npz")]
    missing = [f for f in want if not os.path.isfile(os.path.join(model_path, f))]
    if missing:
        raise AssertionError(f"{model_path}: artifacts missing: {missing}")
    return len(want)


def check_ply_render(tr, it):
    """The saved PLY and deform MLP, reloaded, render a frame equal to the
    Trainer's own state (the card-vs-CPU frame tolerance)."""
    import functools

    import torch

    from gftorf_tpu_torch.data.scene import take_frame
    from gftorf_tpu_torch.models.deform import apply_deform
    from gftorf_tpu_torch.train.evaluate import eval_frame
    from gftorf_tpu_torch.train.export import (
        load_deform_model,
        load_gaussians_from_ply,
    )

    out = os.path.join(tr.cfg.model.model_path, f"point_cloud/iteration_{it}")
    params = load_gaussians_from_ply(os.path.join(out, "point_cloud_full.ply"),
                                     tr.cfg.model.sh_degree, device=tr.device)
    net = load_deform_model(os.path.join(out, "deform_model.npz"),
                            tr.deform_cfg, device=tr.device)
    # The Trainer's static, with the depth ceiling for both renders (an
    # evaluation truncates silently at the training cap).
    static = tr._static_for(tr.iteration)
    static = dataclasses.replace(static, **{
        k: dataclasses.replace(getattr(static, k), max_per_tile=tr.tile_cap_limit)
        for k in ("config_color", "config_tof")})
    frame = take_frame(tr.scene.test_frames, 5)
    ref = eval_frame(static, tr.model.params,
                     functools.partial(apply_deform, tr.deform, tr.deform_cfg),
                     tr.model.aux.alive, frame, device=tr.device)
    got = eval_frame(dataclasses.replace(static, deform_bucket=0), params, net,
                     torch.ones(params.xyz.shape[0], dtype=torch.bool,
                                device=tr.device), frame, device=tr.device)
    for o in (ref[2], got[2]):
        if int(o.tile_overflow) or bool(o.dup_overflow):
            raise AssertionError("the PLY check's frame overflowed a buffer")
    errs = {}
    for k in ("phasor", "depth", "acc"):
        a, b = getattr(got[2], k), getattr(ref[2], k)
        errs[k] = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=E2E_ATOL, rtol=E2E_RTOL):
            raise AssertionError(f"PLY render {k} differs from the Trainer's "
                                 f"by {errs[k]:.3g}")
    return params.xyz.shape[0], errs


def check_resume(tr, path):
    """A new Trainer resumed from ``path`` holds the state that was saved."""
    import numpy as np

    from gftorf_tpu_torch.train.loop import Trainer
    from gftorf_tpu_torch.utils.checkpoint import tree_leaves

    tr2 = Trainer(tr.cfg, startup_artifacts=False, device=tr.device)
    tr2.load_checkpoint(path)
    a = list(tree_leaves(tr2._checkpoint_tree()))
    b = list(tree_leaves(tr._checkpoint_tree()))
    to_np = lambda x: x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)  # noqa: E731
    diff = [i for i, (x, y) in enumerate(zip(a, b))
            if not np.array_equal(to_np(x), to_np(y))]
    keys = ("iteration", "tile_cap", "dup_factor", "flat_stream",
            "active_sh_degree", "opacity_reset_interval", "render_bucket",
            "deform_bucket")
    meta = [k for k in keys if getattr(tr2, k) != getattr(tr, k)]
    if len(a) != len(b) or diff or meta:
        raise AssertionError(f"resumed state differs: leaves {diff}, meta {meta}")
    return len(a)


def trainer_overhead(tr, n=20):
    """What the Trainer adds to its steps, measured past the run's end
    (iterations after the last, no event among them): ``n`` bare
    ``train_step`` calls from the Trainer's state with a synchronise on
    both sides (as ``[train]`` times a step), ``n`` ``Trainer.step()``
    iterations back to back (wall over n, the metrics pipelined), and the
    device's busy share of 10 more iterations under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gftorf_tpu_torch.train.step import train_step

    if tr.device.type != "cuda":
        return "Trainer overhead not measured on the CPU"
    bare = []
    for k in range(n):
        it, idx = tr.iteration + 1 + k, k % tr.scene.num_train
        fid = tr.scene.data.train_cameras[idx].frame_id
        static = tr._static_for(it, flow_frame=fid % 4 == 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(static, tr.model, tr.deform, tr.deform_adam,
                   tr.scene.train_frames, idx, it, tr._rng(it), frame_id=fid)
        torch.cuda.synchronize()
        bare.append(1e3 * (time.perf_counter() - t0))
    tr.drain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tr.step()
    tr.drain()
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            tr.step()
        tr.drain()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy, _, spans = device_busy(trace_events(
        prof, os.path.join(ROOT, "build", "profile", "trace_trainer.json")))
    share = (f"device busy {busy / 1e4:.3f} ms/iteration, idle share "
             f"{1 - busy / wall_us:.3f} under the profiler" if spans else
             "the profiler saw no device activity (busy share not measured)")
    return (f"bare train_step on the Trainer's state {statistics.median(bare):.3f} "
            f"ms (median of {n}) against {loop_ms:.3f} ms/iteration of "
            f"Trainer.step() back to back ({n} iterations, wall over n); {share}")


def phase_trainer(device, width=320, height=240, n_ftorf=16, iters=260,
                  drift=False):
    """The Trainer through its CLI at full width (module docstring, 8);
    returns each kernel's launches in the torf run at configs/torf.json."""
    from gftorf_tpu_torch.data import readers
    from gftorf_tpu_torch.data import scene as scene_mod
    from gftorf_tpu_torch.train import evaluate, loop

    data = write_trainer_datasets(device, width, height, n_ftorf)
    cfg_ftorf = os.path.join(ROOT, "configs", "ftorf.json")
    cfg_torf = os.path.join(ROOT, "configs", "torf.json")
    out = os.path.join(TRAINER_DIR, "out")

    # Full-width ftorf: warm-up ends at 100; densify at 100, 150, 200, 250;
    # the opacity reset at 250; the deform MLP steps at 201-249 (it pauses
    # for 200 iterations after each reset, step.py:778).
    warm, reset, dens0, dens_every = 100, 250, 50, 50
    reset_launches()
    with recorded(loop.Trainer, "_densify", device) as dens, \
            recorded(loop.Trainer, "_reset_opacity", device) as resets, \
            recorded(loop.Trainer, "check_backward_fits", device) as check, \
            recorded(evaluate, "eval_frame", device) as evals_ms:
        t0 = time.perf_counter()
        tr, recs, evals = train_cli(
            device, cfg_ftorf, os.path.join(out, "ftorf"),
            "--source_path", data["ftorf"], "--total_num_views", n_ftorf,
            "--iterations", iters, "--warm_up", warm,
            "--densify_from_iter", dens0, "--densification_interval", dens_every,
            "--opacity_reset_interval", reset,
            "--test_iterations", warm, iters, "--save_iterations", iters,
            "--checkpoint_iterations", iters)
        wall = time.perf_counter() - t0
    launches = read_launches()
    if not (launches["dense_forward"] and launches["dense_backward"]):
        raise AssertionError(f"ftorf Trainer run: dense kernels not launched: "
                             f"{launches}")
    if device.type == "cuda" and len(check.ms) != 1:
        raise AssertionError(f"the start-up fit check ran {len(check.ms)} times")
    events = [it for it in range(1, iters + 1)
              if it > dens0 and it % dens_every == 0 and it < tr.opt.densify_until_iter]
    pts = {r["iteration"]: r["num_points"] for r in recs}
    changed = [e for e in events if e + 1 in pts and pts[e + 1] != pts[e]]
    deform_steps = sum(1 for it in range(1, iters + 1)
                       if it % reset > 200 or it >= tr.opt.densify_until_iter)
    if len(dens.ms) != len(events) or len(changed) < 2:
        raise AssertionError(f"densify events {len(dens.ms)} (want {len(events)}), "
                             f"num_points changed at {changed}")
    if len(resets.ms) != iters // reset or int(tr.deform_adam.step) != deform_steps:
        raise AssertionError(f"{len(resets.ms)} opacity resets, deform MLP "
                             f"stepped {int(tr.deform_adam.step)} times "
                             f"(want {deform_steps})")
    if len(evals) != 2:
        raise AssertionError(f"{len(evals)} evaluations logged, want 2")
    n_files = check_artifacts(tr.cfg.model.model_path, iters)
    n_ply, ply_errs = check_ply_render(tr, iters)
    n_leaves = check_resume(tr, os.path.join(tr.cfg.model.model_path,
                                             f"chkpnt{iters}.npz"))
    overhead = trainer_overhead(tr)
    cap = tr.model.aux.alive.shape[0]
    past = [r["iter_time"] * 1e3 for r in recs if r["iteration"] > warm]
    early = [r["iter_time"] * 1e3 for r in recs if 1 < r["iteration"] <= warm]
    ev_frames = len(evals_ms.ms)
    log("trainer", f"ftorf full width (configs/ftorf.json, {n_ftorf} frames at "
        f"{width}x{height}): {iters} iterations in {wall:.1f} s; start-up "
        f"fit check of dense_backward's instances {sorted(tr.backward_fits)}: "
        f"{'ok, ' + format(check.ms[0], '.3f') + ' ms' if check.ms else 'not on this device'}; "
        f"num_points {pts[1]} -> {recs[-1]['num_points']} (changed at densify "
        f"events {changed} of {events}); {len(resets.ms)} opacity reset; "
        f"deform MLP stepped {deform_steps} times; evals at {warm} and {iters}: "
        f"mae_d_tof {evals[0]['eval']['test']['mae_d_tof']:.5f} -> "
        f"{evals[1]['eval']['test']['mae_d_tof']:.5f}, psnr_p "
        f"{evals[0]['eval']['test']['psnr_p']:.3f} -> "
        f"{evals[1]['eval']['test']['psnr_p']:.3f}; {n_files} artifacts; the "
        f"saved PLY ({n_ply} Gaussians) renders the Trainer's frame (max abs "
        f"err {max(ply_errs.values()):.3g}); chkpnt{iters}.npz resumes to an "
        f"equal state ({n_leaves} leaves); kernel launches in the run {launches}")
    log("trainer", f"timing on {card_line() if device.type == 'cuda' else 'cpu'}: "
        f"ms/iteration (host median of iter_time) {statistics.median(past):.3f} "
        f"past warm-up (iterations {warm + 1}-{iters}), "
        f"{statistics.median(early):.3f} in warm-up (2-{warm}); densify event "
        f"{statistics.median(dens.ms):.3f} ms (median of {len(dens.ms)}, all "
        f"{[round(v, 3) for v in dens.ms]}) at capacity {cap}; opacity reset "
        f"{resets.ms[0]:.3f} ms; eval frame {statistics.median(evals_ms.ms):.3f} "
        f"ms (median of {ev_frames}); {overhead}")
    del tr

    # ToRF at configs/torf.json as shipped: colour 640x480 read at
    # color_scale_factor 0.5 to the ToF camera's 320x240 (two cameras,
    # render regions ("dynamic",)); densify at 20 and 30.
    t_iters, t_warm, t_every = 30, 10, 10
    n_torf = 8
    reset_launches()
    with recorded(readers, "scale_image", device, keep_args=True) as scaled, \
            recorded(scene_mod, "read_scene", device) as reads, \
            recorded(scene_mod, "stack_frames", device) as stacks, \
            recorded(loop.Trainer, "_densify", device) as tdens, \
            recorded(loop.Trainer, "check_backward_fits", device) as tcheck:
        tr, recs, evals = train_cli(
            device, cfg_torf, os.path.join(out, "torf"),
            "--source_path", data["torf"], "--total_num_views", n_torf,
            "--iterations", t_iters, "--warm_up", t_warm,
            "--densify_from_iter", t_warm, "--densification_interval", t_every,
            "--test_iterations", t_iters, "--save_iterations", t_iters)
    launches = torf_launches = read_launches()
    colour = [(a[0].shape, r.shape) for a, r in zip(scaled.args, scaled.results)
              if a[1] != 1.0]
    if colour != [((2 * height, 2 * width, 3), (height, width, 3))] * n_torf:
        raise AssertionError(f"torf run: the readers resized {colour}, want "
                             f"{n_torf} colour frames from "
                             f"{2 * width}x{2 * height} to {width}x{height}")
    cams = tr.scene.data.train_cameras
    if tr.scene.color_size != (height, width) or any(
            (c.width, c.height, c.image.shape[:2]) != (width, height, (height, width))
            for c in cams):
        raise AssertionError(f"torf run: colour cameras {tr.scene.color_size}, "
                             f"not {width}x{height}")
    if tr.render_regions != ("dynamic",) or tr.scene.cameras_identical:
        raise AssertionError(f"torf run: regions {tr.render_regions}, cameras "
                             f"identical {tr.scene.cameras_identical}")
    if not (launches["dense_forward"] and launches["dense_backward"]):
        raise AssertionError(f"torf Trainer run: dense kernels not launched: "
                             f"{launches}")
    if (len(tdens.ms) != 2 or len(evals) != 1
            or (device.type == "cuda" and len(tcheck.ms) != 1)):
        raise AssertionError(f"torf run: {len(tdens.ms)} densify events, "
                             f"{len(evals)} evaluations, {len(tcheck.ms)} "
                             f"start-up checks")
    n_files = check_artifacts(tr.cfg.model.model_path, t_iters)
    resize_s = sum(ms for (a, ms) in zip(scaled.args, scaled.ms)
                   if a[1] != 1.0) / 1e3
    past = [r["iter_time"] * 1e3 for r in recs if r["iteration"] > t_warm]
    log("trainer", f"torf (configs/torf.json as shipped: ToF {width}x{height}, "
        f"colour {2 * width}x{2 * height} at color_scale_factor 0.5; two cameras, "
        f"regions {tr.render_regions}): start-up read_scene "
        f"{reads.ms[0] / 1e3:.3f} s ({resize_s:.3f} s of it resizing "
        f"{len(colour)} colour frames {2 * width}x{2 * height} -> "
        f"{width}x{height}), frames stacked in {sum(stacks.ms) / 1e3:.3f} s; "
        f"{t_iters} iterations, loss {recs[0]['loss']:.5g} -> "
        f"{recs[-1]['loss']:.5g}, num_points {recs[0]['num_points']} -> "
        f"{recs[-1]['num_points']} (densify at {t_warm + t_every} and "
        f"{t_iters}), eval mae_d_tof {evals[0]['eval']['test']['mae_d_tof']:.5f}; "
        f"{n_files} artifacts, scene_bounds.png among them; kernel launches "
        f"{launches}, the start-up check {len(tcheck.ms)}")
    log("trainer", f"torf timing on "
        f"{card_line() if device.type == 'cuda' else 'cpu'}: ms/iteration "
        f"(host median of iter_time) {statistics.median(past):.3f} past "
        f"warm-up (iterations {t_warm + 1}-{t_iters}), "
        f"{statistics.median(r['iter_time'] * 1e3 for r in recs[1:]):.3f} "
        f"over iterations 2-{t_iters} (the basis of earlier readings)")
    del tr

    # The flat fallback: a ceiling below the scene's deepest tile.
    reset_launches()
    tr, recs, _ = train_cli(
        device, cfg_ftorf, os.path.join(out, "flat"),
        "--source_path", data["ftorf"], "--total_num_views", n_ftorf,
        "--iterations", 12, "--max_per_tile", 256, "--max_per_tile_limit", 256,
        "--test_iterations", 0)
    launches = read_launches()
    if device.type == "cuda" and not (tr.flat_stream and tr._flat_auto
                                      and launches["flat_forward"]
                                      and launches["flat_backward"]):
        raise AssertionError(f"flat fallback did not engage: flat_stream "
                             f"{tr.flat_stream}, launches {launches}")
    log("trainer", f"flat fallback: max_per_tile_limit 256, flat_stream "
        f"{tr.flat_stream} (auto {tr._flat_auto}) from iteration 1, 12 "
        f"iterations, loss {recs[0]['loss']:.5g} -> {recs[-1]['loss']:.5g}, "
        f"tile_overflow {max(r['tile_overflow'] for r in recs)}; kernel "
        f"launches in the run {launches}")
    del tr

    # Health: the verify recipe; mae_d_tof must fall.
    vcfg = os.path.join(TRAINER_DIR, "verify.json")
    with open(vcfg, "w") as f:
        json.dump(dict(VERIFY_CFG, source_path=data["verify"]), f)
    _, _, evals = train_cli(device, vcfg, os.path.join(out, "verify"),
                            "--test_iterations", 1, 60, 120)
    mae = [e["eval"]["test"]["mae_d_tof"] for e in evals]
    if not mae[-1] < mae[0]:
        raise AssertionError(f"verify recipe: mae_d_tof did not fall: {mae}")
    log("trainer", f"verify recipe (64x48, 120 iterations): mae_d_tof at "
        f"1/60/120 {[round(v, 5) for v in mae]}, psnr_p "
        f"{[round(e['eval']['test']['psnr_p'], 3) for e in evals]}")

    # Determinism: two identical short full-width runs.
    losses = []
    for k in range(2):
        _, recs, _ = train_cli(
            device, cfg_ftorf, os.path.join(out, f"repeat{k}"),
            "--source_path", data["ftorf"], "--total_num_views", n_ftorf,
            "--iterations", 8, "--warm_up", 4, "--test_iterations", 0)
        losses.append([r["loss"] for r in recs])
    if losses[0] != losses[1]:
        raise AssertionError(f"two identical runs differ: {losses}")
    log("trainer", f"determinism: two identical 8-iteration runs (warm-up "
        f"ends at 4, random bg) give bitwise-equal losses {losses[0]}")

    if drift:
        phase_trainer_drift(device, data["verify"])
    log("trainer", "ok")
    return torf_launches


def phase_trainer_drift(device, source):
    """The verify recipe without random backgrounds (the card's and the
    CPU's generators differ) on the card and on the CPU: mae_d_tof and
    psnr_p at each evaluation, side by side. Twice: as the recipe is, where
    the deform MLP never steps (it pauses for 200 iterations after each
    opacity reset, the first at iteration 0), and with densify_until_iter
    40, from where only the deform MLP trains (81 steps)."""
    import torch

    runs = (("recipe", {}), ("deform from 40", {"densify_until_iter": 40}))
    for k, (tag, extra) in enumerate(runs):
        vcfg = os.path.join(TRAINER_DIR, "drift.json")
        with open(vcfg, "w") as f:
            json.dump(dict(VERIFY_CFG, source_path=source, random_bg_color=False,
                           **extra), f)
        rows = {}
        for dev in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            tr, _, evals = train_cli(
                dev, vcfg, os.path.join(TRAINER_DIR, "out", f"drift{k}_{dev}"),
                "--test_iterations", 1, 30, 60, 90, 120)
            rows[dev.type] = [(e["iteration"], e["eval"]["test"]["mae_d_tof"],
                               e["eval"]["test"]["psnr_p"]) for e in evals]
            log("drift", f"{tag}, {dev.type}: {time.perf_counter() - t0:.1f} s, "
                f"deform MLP steps {int(tr.deform_adam.step)}")
        for (it, m_a, p_a), (_, m_b, p_b) in zip(rows[device.type], rows["cpu"]):
            log("drift", f"{tag}, iteration {it}: mae_d_tof card {m_a!r} cpu "
                f"{m_b!r} (rel diff {abs(m_a - m_b) / abs(m_b):.3g}); psnr_p card "
                f"{p_a!r} cpu {p_b!r} (diff {p_a - p_b:.4g})")


# ---------------------------------------------------------------- render


RENDER_DIR = os.path.join(ROOT, "build", "render")
RENDER_CHANNELS = ("color", "real", "imag", "amp", "depth", "depth_norm",
                   "depth_tof", "dd")
# Rendered maps, card against CPU: .npy maps within the frame tolerance,
# PNGs differing on at most 1 % of a channel's pixels, by at most 1 level,
# both on all but FLIP_FRAC of the pixels (the kernels' contrib-lane
# allowance): where one instance's alpha lies within rounding of the 1/255
# cutoff, it counts on one device and not on the other (preprocess rounds
# differently on the card and the CPU), and moves the pixel by its whole
# contribution (PERF.md § 6).
PNG_LEVELS, PNG_FRAC = 1, 0.01
FLIP_FRAC = CONTRIB_FRAC


def copy_model(src, dst, it, flat_stream=None):
    """The files the render path reads (cfg_args_full.json and
    point_cloud/iteration_<it>/) under ``dst``; optionally with
    ``flat_stream`` set in the copy's config."""
    import shutil

    art = os.path.join("point_cloud", f"iteration_{it}")
    shutil.copytree(os.path.join(src, art), os.path.join(dst, art))
    with open(os.path.join(src, "cfg_args_full.json")) as f:
        cfg = json.load(f)
    if flat_stream is not None:
        cfg["flat_stream"] = flat_stream
    with open(os.path.join(dst, "cfg_args_full.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    return dst


def render_cli(model_path, *flags):
    from gftorf_tpu_torch.render.__main__ import main

    return main(["--model_path", model_path, *map(str, flags)])


def missing_files(root, names):
    return [n for n in names if not os.path.isfile(os.path.join(root, n))]


def split_files(split_dir, n, quad, gifs=True):
    chans = RENDER_CHANNELS + (("quad",) if quad else ())
    names = [f"{ch}/{i:04d}.png" for ch in chans for i in range(n)]
    names += [f"{ch}/{i:04d}.npy" for ch in ("depth", "depth_tof")
              for i in range(n)]
    return names + ([f"{ch}.gif" for ch in chans] if gifs and n > 1 else [])


def png_diff(a, b):
    """(largest level difference, share of pixels that differ, share of
    pixels that differ by more than PNG_LEVELS)."""
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    if d.ndim == 3:
        d = d.max(-1)
    return int(d.max()), float((d > 0).mean()), float((d > PNG_LEVELS).mean())


def check_cutoff_flips(a, b, what):
    """Hold two renders of a map (card, CPU) at the frame tolerance on all
    but FLIP_FRAC of its pixels; returns the count of pixels past it."""
    import numpy as np

    past = ~np.isclose(a, b, atol=E2E_ATOL, rtol=E2E_RTOL)
    if past.mean() > FLIP_FRAC:
        raise AssertionError(
            f"{what}: card and CPU differ by up to {np.abs(a - b).max():.3g} "
            f"on {int(past.sum())} pixels past atol {E2E_ATOL} rtol {E2E_RTOL}")
    return int(past.sum())


def cutoff_evidence(model, it, record, device):
    """Where the card's and the CPU's depth of test frame 0 part: the
    deform MLP's outputs on both devices for every Gaussian (t = 0.3), and
    the accumulated alpha at the pixels past the frame tolerance (one
    instance at the 1/255 cutoff moves it by at most 1/255)."""
    import functools

    import torch

    from gftorf_tpu_torch import render_sets
    from gftorf_tpu_torch.data.scene import take_frame
    from gftorf_tpu_torch.models.deform import apply_deform
    from gftorf_tpu_torch.train.evaluate import eval_frame

    outs, d_xyz = [], []
    for dev in (device, torch.device("cpu")):
        tr, _, _ = render_sets.load_trained(model, it, dev)
        tr.tile_cap, tr.dup_factor = record["max_per_tile"], record["dup_factor"]
        tr.flat_stream = record["flat_stream"]
        deform = functools.partial(apply_deform, tr.deform, tr.deform_cfg)
        _, _, out = eval_frame(tr._static_for(it), tr.model.params, deform,
                               tr.model.aux.alive,
                               take_frame(tr.scene.test_frames, 0),
                               device=tr.device)
        outs.append(out)
        n = tr.model.params.xyz.shape[0]
        d_xyz.append(deform(tr.model.params.xyz / tr.scene.scene_extent,
                            torch.full((n, 1), 0.3, device=tr.device))[0].cpu())
    card, cpu = ([o.depth.cpu(), o.acc.cpu()] for o in outs)
    past = ~torch.isclose(card[0], cpu[0], atol=E2E_ATOL, rtol=E2E_RTOL)
    acc = (card[1] - cpu[1]).abs()[past]
    return (f"frame 0 in process: deform MLP outputs card against CPU "
            f"{float((d_xyz[0] - d_xyz[1]).abs().max()):.3g}, {int(past.sum())} "
            f"depth pixel(s) past the tolerance, where acc differs by "
            f"{[round(v, 6) for v in acc.tolist()]} (1/255 = 0.003922)")


def phase_render(device, iters=260, torf_iters=30):
    """The render CLI on the [trainer] phase's saved models (module
    docstring, 9); returns each kernel's launches in the counted renders."""
    import shutil

    import numpy as np
    import torch

    from gftorf_tpu_torch import render_sets, render_traj
    from gftorf_tpu_torch.data.scene import take_frame
    from gftorf_tpu_torch.models.deform import apply_deform
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.train import loop
    from gftorf_tpu_torch.train.evaluate import eval_frame
    from gftorf_tpu_torch.utils.image_io import read_png

    shutil.rmtree(RENDER_DIR, ignore_errors=True)
    trained = os.path.join(TRAINER_DIR, "out")
    main = copy_model(os.path.join(trained, "ftorf"),
                      os.path.join(RENDER_DIR, "ftorf"), iters)
    cuda_flags = () if device.type == "cuda" else ("--device", device.type)

    # The ftorf model at full width: the whole test split with video, and
    # the proxy clouds of every training frame.
    reset_launches()
    with recorded(render_sets, "render_frame", device) as frames_ms, \
            recorded(render_sets, "_write_frame", device) as write_ms, \
            recorded(render_sets, "_write_gif", device) as gif_ms, \
            recorded(loop.Trainer, "check_backward_fits", device) as check:
        t0 = time.perf_counter()
        base = render_cli(main, "--skip_train", "--proxy_pcd", *cuda_flags)
        wall = time.perf_counter() - t0
    launches = read_launches()
    records = [r[2] for r in frames_ms.results]
    with open(os.path.join(main, "cfg_args_full.json")) as f:
        cfg = json.load(f)
    n_test = n_proxy = cfg["total_num_views"]
    renders = sum(r["renders"] for r in records)
    if len(records) != n_test + n_proxy:
        raise AssertionError(f"{len(records)} frames rendered, want {n_test} "
                             f"test and {n_proxy} proxy frames")
    if device.type == "cuda" and not (
            launches["dense_forward"] + launches["flat_forward"] == renders
            and launches["dense_backward"] == 0
            and launches[FIT_CHECK] == len(check.ms) == 1
            and launches["flat_backward"] == 0):
        raise AssertionError(f"render launches {launches} for {renders} "
                             f"renders and {len(check.ms)} start-up checks")
    overflow = [r["tile_overflow"] for r in records]
    test_dir = os.path.join(base, "test")
    want = ([f"renders_{iters}/test/{n}" for n in split_files(test_dir, n_test, True)]
            + [f"input/{ch}/{i:04d}.png" for ch in ("color", "real", "imag", "amp",
                                                      "depth", "depth_tof")
               for i in range(n_test)]
            + [f"input/quad_q{i % 4}/{i:04d}.png" for i in range(n_test)]
            + [f"iteration_{iters}_video_panel.gif"]
            + [f"proxy_pcd/frame_{i}/{n}" for i in range(n_proxy) for n in (
                "input.ply", "cameras.json",
                f"point_cloud/iteration_{iters}/point_cloud.ply")])
    missing = missing_files(main, want)
    if missing:
        raise AssertionError(f"render tree: {len(missing)} files missing, "
                             f"{missing[:5]}")
    log("render", f"ftorf full width (the [trainer] model at iteration "
        f"{iters}): the CLI rendered {n_test} test frames and {n_proxy} proxy "
        f"frames ({renders} renders) in {wall:.1f} s, {len(want)} artifacts "
        f"checked; kernel launches {launches} ({FIT_CHECK}: the Trainer's "
        f"start-up check, which launches no kernel); tile_overflow per frame at the loaded "
        f"max_per_tile {cfg['max_per_tile']}: {overflow}; deepest tile per frame {[r['tile_max'] for r in records]}; "
        f"rendered at max_per_tile {sorted({r['max_per_tile'] for r in records})}, "
        f"flat_stream {sorted({r['flat_stream'] for r in records})}; dropped "
        f"after growth {max(r['tile_overflow_final'] for r in records)}")
    render_launches = dict(launches)

    # Two frames' depth maps, bitwise, against eval_frame in this process
    # on the same state at the capacities the CLI rendered them at; the
    # dense forward kernel against its plain version at those shapes.
    tr, _, _ = render_sets.load_trained(main, iters, device)
    deform = lambda xyz, t, x_emb=None: apply_deform(  # noqa: E731
        tr.deform, tr.deform_cfg, xyz, t, x_emb)
    for i in (0, 1):
        rec = records[i]
        tr.tile_cap, tr.dup_factor = rec["max_per_tile"], rec["dup_factor"]
        tr.flat_stream = rec["flat_stream"]
        with capturing({"forward": (dense, "composite_forward")}) as cap:
            _, _, out = eval_frame(tr._static_for(iters), tr.model.params,
                                   deform, tr.model.aux.alive,
                                   take_frame(tr.scene.test_frames, i),
                                   device=device)
        saved = np.load(os.path.join(test_dir, "depth", f"{i:04d}.npy"))
        if not np.array_equal(out.depth[0].cpu().numpy(), saved):
            raise AssertionError(f"frame {i}: the CLI's depth differs from "
                                 "eval_frame's")
    kernel_note = ("frame 1 rendered flat" if "forward" not in cap.calls
                   else "the kernel does not run on this device")
    if "forward" in cap.calls and device.type == "cuda":
        args = cap.calls["forward"]
        got, contrib = dense.composite_forward_cuda(*args)
        ref, ref_contrib = dense.composite_forward_plain(*args)
        err, _ = compare(got, contrib, ref, ref_contrib, "render frame")
        ms = time_ms(lambda: dense.composite_forward_cuda(*args), 20)
        plain_ms = time_ms(lambda: dense.composite_forward_plain(*args), 2)
        b_ms, b_by, _, _ = bound(*work_of(args[0], args[2], args[3], args[4],
                                          contrib))
        T, L, _ = args[0].shape
        kernel_note = (f"dense_forward at the render's shapes (T={T}, L={L}, "
                       f"instances {int(args[2].sum())}): {ms:.4f} ms, plain "
                       f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
                       f"max_abs_err {err:.3g}")
    log("render", f"frames 0 and 1: depth .npy bitwise equal to eval_frame in "
        f"process; {kernel_note}")
    del tr

    # The card against the CPU: two frames.
    if device.type == "cuda":
        cpu = copy_model(os.path.join(trained, "ftorf"),
                         os.path.join(RENDER_DIR, "cpu"), iters)
        t0 = time.perf_counter()
        cpu_base = render_cli(cpu, "--skip_train", "--max_frames", 2,
                              "--device", "cpu")
        cpu_s = time.perf_counter() - t0
        worst_npy, flips, worst_png = 0.0, 0, (0, 0.0, 0)
        for i in range(2):
            for ch in ("depth", "depth_tof"):
                a = np.load(os.path.join(test_dir, ch, f"{i:04d}.npy"))
                b = np.load(os.path.join(cpu_base, "test", ch, f"{i:04d}.npy"))
                worst_npy = max(worst_npy, float(np.abs(a - b).max()))
                flips += check_cutoff_flips(a, b, f"{ch} {i}")
            for ch in RENDER_CHANNELS + ("quad",):
                levels, frac, past = png_diff(
                    read_png(os.path.join(test_dir, ch, f"{i:04d}.png")),
                    read_png(os.path.join(cpu_base, "test", ch, f"{i:04d}.png")))
                if past > FLIP_FRAC or frac > PNG_FRAC:
                    raise AssertionError(
                        f"{ch} {i}: card and CPU PNGs differ on {frac:.4%} of "
                        f"pixels, by more than {PNG_LEVELS} level on {past:.4%}")
                worst_png = max(worst_png, (levels, frac, past))
        log("render", f"card against CPU (--device cpu --max_frames 2, "
            f"{cpu_s:.1f} s): .npy max abs diff {worst_npy:.3g}, {flips} "
            f"pixel(s) past atol {E2E_ATOL} rtol {E2E_RTOL} in "
            f"{2 * 2 * a.size} map pixels; PNGs differing on at most "
            f"{worst_png[1]:.4%} of pixels, by at most {worst_png[0]} level(s), "
            f"by more than {PNG_LEVELS} on {worst_png[2]:.4%}; "
            f"{cutoff_evidence(main, iters, records[0], device)}")

    # Flat: the same frames with flat_stream set in the model's config.
    fmodel = copy_model(os.path.join(trained, "ftorf"),
                        os.path.join(RENDER_DIR, "flat"), iters, flat_stream=True)
    reset_launches()
    with recorded(render_sets, "render_frame", device) as fframes, \
            capturing({"forward": (flat, "composite_forward_flat")}) as fcap:
        fbase = render_cli(fmodel, "--skip_train", "--skip_video", *cuda_flags)
    flaunches = read_launches()
    frenders = sum(r[2]["renders"] for r in fframes.results)
    if device.type == "cuda" and not (flaunches["flat_forward"] == frenders
                                      and flaunches["dense_forward"] == 0):
        raise AssertionError(f"flat render launches {flaunches}")
    for k, v in flaunches.items():
        render_launches[k] += v
    differ = [n for n in split_files(test_dir, n_test, True, gifs=False)
              if not (np.array_equal(np.load(os.path.join(test_dir, n)),
                                     np.load(os.path.join(fbase, "test", n)))
                      if n.endswith(".npy") else np.array_equal(
                          read_png(os.path.join(test_dir, n)),
                          read_png(os.path.join(fbase, "test", n))))]
    if differ:
        raise AssertionError(f"flat render differs from dense in {differ[:5]}")
    fnote = ""
    if device.type == "cuda":
        args = fcap.calls["forward"]
        got, contrib = flat.composite_forward_flat_cuda(*args)
        ref, ref_contrib = flat.composite_forward_flat_plain(*args)
        err, _ = compare(got, contrib, ref, ref_contrib, "flat render frame")
        fnote = (f"; flat_forward against its plain version at the render's "
                 f"first frame (K_pad={args[0].shape[0]}): max_abs_err {err:.3g}")
    log("render", f"flat copy (flat_stream true): {n_test} frames, every PNG "
        f"and .npy bitwise equal to the dense render; launches {flaunches}{fnote}")

    # torf: the spiral and freeze-frame spiral paths.
    torf = copy_model(os.path.join(trained, "torf"),
                      os.path.join(RENDER_DIR, "torf"), torf_iters)
    tbase = render_cli(torf, "--skip_train", "--max_frames", 8, *cuda_flags)
    for split in ("test", "renders_spiral", "freezeframe_spiral"):
        d = os.path.join(tbase, split)
        missing = missing_files(d, split_files(d, 8, False))
        if missing:
            raise AssertionError(f"torf {split}: missing {missing[:5]}")
        if split != "test" and np.array_equal(
                read_png(os.path.join(d, "depth", "0000.png")),
                read_png(os.path.join(d, "depth", "0001.png"))):
            raise AssertionError(f"torf {split}: frames 0 and 1 are equal")
    log("render", f"torf (the [trainer] torf model at iteration {torf_iters}, "
        f"two cameras): test, renders_spiral and freezeframe_spiral, 8 frames "
        f"each, the spiral frames differing")

    # Trajectories on the ftorf model.
    with recorded(render_traj, "track_points", device) as tracks:
        traj_dir = render_traj.main(["--model_path", main, *cuda_flags])
    pts = tracks.results[0]
    if not (np.isfinite(pts).all() and pts.shape[:2] == (n_test, 64)):
        raise AssertionError(f"tracks: shape {pts.shape}, finite "
                             f"{np.isfinite(pts).all()}")
    want = ([f"traj/{i:04d}.png" for i in range(n_test)]
            + [f"depth_quad/{i:04d}.png" for i in range(n_test)]
            + ["depth_quad.gif", "traj.gif"])
    missing = missing_files(traj_dir, want) + missing_files(main, [
        f"iteration_{iters}_website_panel.gif", f"iteration_{iters}_quad_panel.gif"])
    empty = [f"{k}_q{q}" for k in ("depth", "quad") for q in range(4)
             if not os.listdir(os.path.join(traj_dir, f"{k}_q{q}"))]
    if missing or empty:
        raise AssertionError(f"trajectories: missing {missing}, empty {empty}")
    log("render", f"trajectories: 64 tracks over {n_test} frames, finite; "
        f"traj/, depth_quad/, depth_q0-3/, quad_q0-3/ and both panels written")

    # Debug dumps through the train CLI at the verify recipe's size.
    dbg = os.path.join(RENDER_DIR, "debug")
    tr, _, _ = train_cli(device, os.path.join(TRAINER_DIR, "verify.json"), dbg,
                         "--iterations", 4, "--debug", "true",
                         "--debug_interval", 2, "--test_iterations", 0)
    dumps = sorted(d for d in os.listdir(dbg) if d.startswith("tmp_debug_"))
    counts = {len(os.listdir(os.path.join(dbg, d))) for d in dumps}
    if len(dumps) != 23 or counts != {3}:
        raise AssertionError(f"debug dumps: {len(dumps)} directories, files "
                             f"{counts}")
    log("render", f"debug dumps: train CLI --debug true, 4 iterations at "
        f"64x48: {len(dumps)} tmp_debug_* directories of 3 images each")
    del tr

    n = n_test
    log("render", f"timing on {card_line() if device.type == 'cuda' else 'cpu'}: "
        f"ms/frame over the ftorf test split ({n} frames at "
        f"{cfg['tof_image_width']}x{cfg['tof_image_height']}, host "
        f"medians): render {statistics.median(frames_ms.ms[:n]):.3f} "
        f"(render_frame: eval_frame to its one transfer, synchronised; all "
        f"{[round(v, 3) for v in frames_ms.ms[:n]]}), writing "
        f"{statistics.median(write_ms.ms[:n]):.3f} (colouring, 9 PNGs and 2 "
        f".npy; all {[round(v, 3) for v in write_ms.ms[:n]]}); {len(gif_ms.ms)} "
        f"channel GIFs {sum(gif_ms.ms):.1f} ms in all; proxy frames render "
        f"{statistics.median(frames_ms.ms[n:]):.3f}")
    log("render", "ok")
    return render_launches


# ---------------------------------------------------------------- sharded


SHARD_DIR = os.path.join(ROOT, "build", "sharded")
SHARD_STEPS, SHARD_IT0 = 3, 2121
SHARD_TIMEOUT_S = 600


def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_digest(tree):
    """SHA-1 of every tensor of a (nested) tree, in order: two ranks' or
    two runs' states are bitwise equal when their digests are."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for name, t in tree_items(tree):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _sharded_rank(rank, world, port, device, in_path, out_dir):
    """One rank of the ``[sharded]`` phase (a spawned process): joins the
    gloo group, runs every case of the payload and saves what the parent
    checks. Its tracebacks go to ``rank<r>.err``."""
    import traceback

    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import torch.distributed as dist

    from gftorf_tpu_torch.parallel.mesh import init_distributed

    try:
        dev = init_distributed("gloo", device, timeout_s=SHARD_TIMEOUT_S)
        payload = torch.load(in_path, weights_only=False)
        results = [_sharded_case(case, payload, dev) for case in payload["cases"]]
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sharded_case(case, payload, dev):
    """``SHARD_STEPS`` train_steps of one mesh from one state: per step the
    state digest, ms and metrics; the launch counts of the steps; rank 0
    against the single-device step (shard-only meshes) and the last shard
    rank's kernels against their plain versions on its band's inputs."""
    import torch

    from gftorf_tpu_torch.parallel.mesh import cached_mesh
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.train.step import (
        METRIC_NAMES, _deform_lr_at, _gaussian_lrs_at, train_step)

    mesh = cached_mesh(*case["mesh"])
    move = lambda t: t.to(dev)  # noqa: E731
    state = tree_map(move, payload["states"][case["key"]])
    frames = tree_map(move, payload["frames"][case["key"]])
    res = {"label": case["label"], "rank": mesh.rank}
    cuda = dev.type == "cuda"
    if case["single"] and mesh.rank == 0:
        static, idx, it = case["steps"][0]
        ref = train_step(dataclasses.replace(static, mesh_shape=None), *state,
                         frames, idx, it)
    static_flat = case["steps"][0][0].config_tof.flat_stream
    mod, names = ((flat, ("composite_forward_flat", "composite_backward_flat"))
                  if static_flat else (dense, ("composite_forward",
                                               "composite_backward")))
    last = mesh.shard_index == mesh.shard - 1 and case["capture"]
    targets = {n: (mod, n) for n in names} if last else {}
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    digests, ms, metrics = [], [], []
    with capturing(targets) as cap:
        for k, (static, idx, it) in enumerate(case["steps"]):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = train_step(static, *state, frames, idx, it)
            if cuda:
                torch.cuda.synchronize(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            state = out[:3]
            m = dict(zip(METRIC_NAMES, out[3].tolist()))
            if m["tile_overflow"] or m["dup_overflow"]:
                raise AssertionError(f"{case['label']}: step {k} overflowed: {m}")
            metrics.append(m)
            digests.append(state_digest(out))
            if k == 0 and case["single"] and mesh.rank == 0:
                lrs, d_lr = _gaussian_lrs_at(static, it), _deform_lr_at(static, it)
                # A mesh reports its deepest band's count times the shards.
                res["vs_single"] = compare_steps(
                    out, ref, lrs, d_lr, f"{case['label']} vs one device",
                    skip=("num_rendered", "rendered_max"))
                res["single_loss"] = float(ref[3][0])
            if k == 0 and case.get("save_first") and mesh.rank == 0:
                res["first"] = tree_map(lambda t: t.cpu(), out)
    res.update(digests=digests, ms=ms, metrics=metrics,
               launches=read_launches(),
               peak_mb=(torch.cuda.max_memory_allocated(dev) / 2**20
                        if cuda else None))
    if last and cuda:
        res["kernels"] = _band_kernel_checks(cap.calls, names, static_flat)
    return res


def _band_kernel_checks(calls, names, is_flat):
    """The kernel pair of a band's first render against its plain versions,
    on the band's own inputs (its tile origins start at its first row).
    The backward takes a cotangent in [-1, 1] in place of the step's, whose
    gradients lie below ``compare_bwd``'s atol; and the check must refuse a
    zeroed gradient and a pair run with the band placed one tile row up."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense, flat

    fwd, bwd = calls[names[0]], list(calls[names[1]])
    origins, config = fwd[-2], fwd[-1]
    row0 = int(origins[:, 1].min())
    g = bwd[3]
    rng = np.random.default_rng(row0)
    bwd[3] = torch.tensor(rng.uniform(-1, 1, tuple(g.shape)).astype(np.float32),
                          device=g.device)
    if is_flat:
        kernels = (flat.composite_forward_flat_cuda,
                   flat.composite_backward_flat_cuda)
        plain = (flat.composite_forward_flat_plain,
                 flat.composite_backward_flat_plain)
        pair = ("flat_forward", "flat_backward")
    else:
        kernels = (dense.composite_forward_cuda, dense.composite_backward_cuda)
        plain = (dense.composite_forward_plain, dense.composite_backward_plain)
        pair = ("dense_forward", "dense_backward")
    out, contrib = kernels[0](*fwd)
    ref_out, ref_contrib = plain[0](*fwd)
    dfeat = kernels[1](*bwd)
    ref_dfeat = plain[1](*bwd)
    what = f"{pair[0]} on a band from pixel row {row0}"
    err_f, lanes = compare(out, contrib, ref_out, ref_contrib, what)
    err_b, _ = compare_bwd(dfeat, ref_dfeat, lanes, what)

    # The check's power: a zeroed dfeat, and both kernels at origins one
    # tile row up (a wrong band offset), must fail it.
    up = origins.clone()
    up[:, 1] -= config.tile_h
    out_up, contrib_up = kernels[0](*fwd[:-2], up, config)
    dfeat_up = kernels[1](*bwd[:-3], up, *bwd[-2:])
    for label, check in (
            ("zeroed dfeat", lambda: compare_bwd(torch.zeros_like(dfeat),
                                                 ref_dfeat, lanes, what)),
            ("forward one tile row up", lambda: compare(
                out_up, contrib_up, ref_out, ref_contrib, what)),
            ("dfeat one tile row up", lambda: compare_bwd(
                dfeat_up, ref_dfeat, lanes, what))):
        try:
            check()
        except AssertionError:
            continue
        raise AssertionError(f"{what}: the check passed a {label}")
    return {"row0": row0, "tiles": int(fwd[1].shape[0]), pair[0]: err_f,
            pair[1]: err_b, "dfeat_max": float(ref_dfeat.abs().max())}


def run_mesh(world, device, payload, tag):
    """Run the payload's cases on ``world`` spawned ranks on ``device``;
    returns each rank's results. A failed rank, or a run past
    ``SHARD_TIMEOUT_S``, kills every rank and raises with the tracebacks."""
    import multiprocessing as mp
    import shutil

    import torch

    out_dir = os.path.join(SHARD_DIR, tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    in_path = os.path.join(out_dir, "payload.pt")
    torch.save(payload, in_path)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, world, port, device, in_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if failed or hung:
        errs = ""
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs += f"\nrank {r}:\n{f.read()}"
        raise AssertionError(f"[sharded] {tag}: ranks {failed} failed, ranks "
                             f"{hung} killed (still running then; timeout "
                             f"{SHARD_TIMEOUT_S} s){errs}")
    results = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    os.remove(in_path)
    return results


def mesh_case(run, key, mesh, label, flat=False, single=False, capture=False,
              save_first=False, n_steps=SHARD_STEPS):
    """A case of the ``[sharded]`` payload: ``n_steps`` steps of ``run``
    under ``mesh``, with constant backgrounds (every device draws none),
    one camera per data slice; the statics the Trainer builds (flow gated
    at run time when data > 1)."""
    import copy

    r = copy.copy(run)
    r.flat, r.random_bg = flat, False
    n = len(r.frame_ids)
    steps = []
    for k in range(n_steps):
        it = SHARD_IT0 + k
        if mesh[0] == 1:
            idx = k % n
            static = r.static_for(it, r.frame_ids[idx] % 4 == 0)
        else:
            idx = [(k + d) % n for d in range(mesh[0])]
            static = r.static_for(it, None)
        steps.append((dataclasses.replace(static, mesh_shape=mesh), idx, it))
    return dict(key=key, mesh=mesh, label=label, steps=steps, single=single,
                capture=capture, save_first=save_first)


def _ranks_equal(results, i, label):
    """Every rank's per-step digests of case ``i`` equal rank 0's."""
    first = results[0][i]["digests"]
    for r, res in enumerate(results[1:], 1):
        if res[i]["digests"] != first:
            raise AssertionError(f"{label}: rank {r}'s state differs from rank "
                                 f"0's after steps {res[i]['digests']} vs {first}")
    return first


def phase_sharded(device, runs):
    """The multi-device step on one card (module docstring, 10)."""
    import torch

    ftorf, torf = runs
    # 6,001 rows (no render bucket at that capacity): padded over the shards.
    small = TrainRun("ftorf", 4000, 6001, device, random_bg=False,
                     dxyz_scale=1000.0)
    while True:  # grow the buffers until the step does not overflow
        _, m = small.run_step(2101, 0)
        if m["tile_overflow"] == 0 and m["dup_overflow"] == 0:
            break
        small.grow(m["tile_max"])
    runs = {"ftorf": ftorf, "torf": torf, "small": small}

    def payload(cases):
        keys = {c["key"] for c in cases}
        return {"cases": cases,
                "states": {k: tree_map(lambda t: t.cpu(), (
                    runs[k].model, runs[k].deform, runs[k].deform_adam))
                    for k in keys},
                "frames": {k: tree_map(lambda t: t.cpu(), runs[k].frames)
                           for k in keys}}

    dense2 = [mesh_case(ftorf, "ftorf", (1, 2), "ftorf (1,2) dense", single=True,
                        capture=True),
              mesh_case(ftorf, "ftorf", (1, 2), "ftorf (1,2) flat", flat=True,
                        capture=True),
              mesh_case(torf, "torf", (1, 2), "torf (1,2) dense", single=True),
              mesh_case(ftorf, "ftorf", (1, 2), "ftorf (1,2) dense rerun")]
    four = [mesh_case(ftorf, "ftorf", (1, 4), "ftorf (1,4) dense", single=True,
                      capture=True),
            mesh_case(ftorf, "ftorf", (2, 2), "ftorf (2,2) dense", capture=True),
            mesh_case(ftorf, "ftorf", (2, 2), "ftorf (2,2) dense rerun")]
    # (2,2) at the [train-vs-cpu] size, one step on the card and on the CPU.
    four.append(mesh_case(small, "small", (2, 2), "ftorf 4,000 (2,2) card",
                          save_first=True, n_steps=1))
    card = card_line() if device.type == "cuda" else "cpu"
    rank_dev = f"{device.type}:0" if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    res2 = run_mesh(2, rank_dev, payload(dense2), "world2")
    res4 = run_mesh(4, rank_dev, payload(four), "world4")
    res_cpu = run_mesh(4, "cpu", payload(
        [dict(four[-1], label="ftorf 4,000 (2,2) cpu")]), "world4_cpu")
    wall = time.perf_counter() - t0

    digests = {}
    launches = dict.fromkeys(KERNELS, 0)
    for results in (res2, res4):
        for i, case in enumerate(results[0]):
            label = case["label"]
            digests[label] = _ranks_equal(results, i, label)
            per_rank = [r[i]["launches"] for r in results]
            renders = len(case["ms"]) * (1 if "ftorf" in label else 2)
            kind = "flat" if "flat" in label else "dense"
            other = "dense" if kind == "flat" else "flat"
            for r, n in enumerate(per_rank):
                if not (n[f"{kind}_forward"] == n[f"{kind}_backward"] == renders
                        and n[f"{other}_forward"] == n[f"{other}_backward"] == 0):
                    raise AssertionError(f"{label}: rank {r} launched {n}, want "
                                         f"{renders} {kind} pairs")
                for k in KERNELS:
                    launches[k] += n[k]
            ms = [statistics.median(r[i]["ms"][1:] or r[i]["ms"]) for r in results]
            losses = [m["loss"] for m in case["metrics"]]
            vs = case.get("vs_single")
            log("sharded", f"{label}: {len(case['ms'])} steps, each rank's state "
                f"bitwise equal after every step; losses {losses}"
                + (f" (one device {case['single_loss']:.7g}; worst mu error / "
                   f"max|leaf| {vs['gaussians']:.3g} Gaussians, {vs['mlp']:.3g} "
                   "MLP)" if vs else "")
                + f"; median ms/step by rank {[round(v, 3) for v in ms]} "
                f"(ranks sharing one card over gloo, {card}); peak MiB by rank "
                f"{[r[i]['peak_mb'] and round(r[i]['peak_mb'], 1) for r in results]}; launches by "
                f"rank {per_rank}")
            for r in results:
                if "kernels" in r[i]:
                    log("sharded", f"{label}: rank {r[i]['rank']}'s band "
                        f"(tile rows from pixel row {r[i]['kernels']['row0']}, "
                        f"{r[i]['kernels']['tiles']} tiles), kernels against "
                        f"their plain versions: max abs err " + ", ".join(
                            f"{k} {v:.3g}" for k, v in r[i]["kernels"].items()
                            if k in KERNELS)
                        + f" (backward with a cotangent in [-1, 1]: max |dfeat| "
                        f"{r[i]['kernels']['dfeat_max']:.3g}); a zeroed dfeat "
                        "and the pair one tile row up fail the check")
    if digests["ftorf (1,2) flat"] != digests["ftorf (1,2) dense"]:
        raise AssertionError("flat (1,2) differs from dense (1,2)")
    for label in ("ftorf (1,2) dense", "ftorf (2,2) dense"):
        if digests[f"{label} rerun"] != digests[label]:
            raise AssertionError(f"{label}: a rerun differs")
    _ranks_equal(res_cpu, 0, "ftorf 4,000 (2,2) cpu")
    got, ref = res4[0][-1]["first"], res_cpu[0][0]["first"]
    static = four[-1]["steps"][0][0]
    from gftorf_tpu_torch.train.step import _deform_lr_at, _gaussian_lrs_at

    c = compare_steps(tree_map(lambda t: t.to(device), got),
                      tree_map(lambda t: t.to(device), ref),
                      _gaussian_lrs_at(static, SHARD_IT0),
                      _deform_lr_at(static, SHARD_IT0), "(2,2) card vs cpu",
                      hidden_frac=HIDDEN_CARD_CPU_FRAC)
    log("sharded", f"ftorf 4,000 Gaussians (2,2) on the card against (2,2) on "
        f"the CPU (gloo, plain kernels), first step: worst mu error / "
        f"max|leaf| {c['gaussians']:.3g} (Gaussians), {c['mlp']:.3g} (MLP)")
    log("sharded", f"flat (1,2) equals dense (1,2) bitwise after every step; "
        f"reruns of (1,2) and (2,2) bitwise equal; {wall:.1f} s for the "
        f"meshes; launches summed over ranks {launches}")
    return launches


def phase_sharded_trainer(device, iters=30):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    gftorf_tpu_torch.train --distributed`` on configs/ftorf.json with
    ``mesh_shards`` 2, both ranks on this card over gloo, on the [trainer]
    phase's dataset: a densify event, a grow-and-replay of both
    capacities at iteration 1, rank 0's tree, the ranks' final digests
    equal, and ``mae_d_tof`` falling between the evaluations."""
    out = os.path.join(SHARD_DIR, "trainer")
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "gftorf_tpu_torch.train", "--distributed", "--device",
           "cuda:0" if device.type == "cuda" else "cpu", "--dist_backend", "gloo",
           "--config", os.path.join(ROOT, "configs", "ftorf.json"),
           "--source_path", os.path.join(TRAINER_DIR, "ftorf"),
           "--model_path", out, "--total_num_views", "16", "--mesh_shards", "2",
           "--iterations", str(iters), "--warm_up", "10",
           "--densify_from_iter", "10", "--densification_interval", "10",
           "--opacity_reset_interval", "1000",
           "--max_per_tile", "128", "--max_per_tile_floor", "128",
           "--dup_factor", "2", "--test_iterations", "1", str(iters),
           "--save_iterations", str(iters), "--checkpoint_iterations", str(iters)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=SHARD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[sharded] the distributed Trainer failed "
                             f"(exit {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    lines = proc.stdout.splitlines()
    grew = [ln for ln in lines if "capacity overflow" in ln]
    agree = [ln for ln in lines if ln.startswith("ranks agree")]
    if not grew or len(agree) != 1:
        raise AssertionError(f"[sharded] no grow-and-replay ({grew}) or no "
                             f"agreement line ({agree}):\n{proc.stdout[-3000:]}")
    n_files = check_artifacts(out, iters)
    with open(os.path.join(out, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    mae = [r["eval"]["test"]["mae_d_tof"] for r in recs if "eval" in r]
    start = [r["num_points"] for r in recs if "num_points" in r][0]
    if len(mae) != 2 or not mae[1] < mae[0]:
        raise AssertionError(f"[sharded] mae_d_tof did not fall: {mae}")
    from gftorf_tpu_torch.utils.checkpoint import load_pytree

    leaves, _ = load_pytree(os.path.join(out, f"chkpnt{iters}.npz"))
    # The densify events change the live count of iteration 1.
    alive = [x for x in leaves if getattr(x, "dtype", None) == bool]
    pts = int(alive[0].sum())
    if len(alive) != 1 or pts == start:
        raise AssertionError(f"[sharded] the densify events changed nothing: "
                             f"{pts} points alive")
    log("sharded", f"distributed Trainer (2 ranks sharing one card over gloo, "
        f"configs/ftorf.json, mesh_shards 2, {iters} iterations, densify at "
        f"20 and 30): {wall:.1f} s wall; {grew[0].strip()}; {agree[0]}; "
        f"{n_files} artifacts in rank 0's tree; mae_d_tof {mae[0]:.5f} -> "
        f"{mae[1]:.5f}; {pts} points alive at the end ({start} at iteration 1)")


# ----------------------------------------------------------- phases 11-12
# gftorf_tpu_torch.bench_train's defaults (bench_train.py's): 550
# iterations, the first 250 excluded from the timed window.
BENCH_ITERS, BENCH_WARM = 550, 250
BASELINE_MS, BASELINE_MPIX_S = 180.0, 0.9


class tee_stdout:
    """For a ``with`` block: what is printed goes to stdout and to
    ``self.lines``."""

    def __enter__(self):
        self.orig, self.text = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, s):
        self.text.append(s)
        return self.orig.write(s)

    def flush(self):
        self.orig.flush()

    def __exit__(self, *exc):
        sys.stdout = self.orig

    @property
    def lines(self):
        return "".join(self.text).splitlines()


def check_bench_line(lines, got, metric, unit, vs_baseline):
    """The bench's last line: the dict it returned, JAX's keys, metric name
    and unit, a finite positive value and the root script's vs_baseline
    formula (``vs_baseline(value)``)."""
    last = json.loads(lines[-1])
    if last != got or sorted(got) != ["metric", "unit", "value", "vs_baseline"]:
        raise AssertionError(f"bench: last line {lines[-1]!r}, returned {got}")
    if (got["metric"], got["unit"]) != (metric, unit):
        raise AssertionError(f"bench: metric {got['metric']} {got['unit']}, "
                             f"want {metric} {unit}")
    if not (math.isfinite(got["value"]) and got["value"] > 0
            and abs(got["vs_baseline"] - vs_baseline(got["value"])) < 1e-2):
        raise AssertionError(f"bench: value {got['value']}, vs_baseline "
                             f"{got['vs_baseline']}")


def phase_bench(device, worst, iters=BENCH_ITERS, warm=BENCH_WARM,
                raster_flags=(), train_flags=()):
    """``gftorf_tpu_torch.bench.main`` in this process (module docstring,
    11): returns each kernel's launches in its two runs."""
    import numpy as np
    import torch

    from gftorf_tpu_torch import bench
    from gftorf_tpu_torch.render.kernels import dense

    launches = dict.fromkeys(KERNELS + (FIT_CHECK,), 0)
    reset_launches()
    with capturing({"forward": (dense, "composite_forward"),
                    "backward": (dense, "composite_backward")}) as cap, \
            tee_stdout() as out:
        got = bench.main(["--rasterizer", "--device", device.type,
                          *map(str, raster_flags)])
    for k, v in read_launches().items():
        launches[k] += v
    args = bench.raster_parser().parse_args(["--rasterizer",
                                             *map(str, raster_flags)])
    check_bench_line(out.lines, got, bench.raster_metric(
        args.width, args.height, args.points), "Mpix/s/chip",
        lambda v: v / BASELINE_MPIX_S)
    if not (launches["dense_forward"] and launches["dense_backward"]):
        raise AssertionError(f"bench --rasterizer: dense kernels not launched "
                             f"{launches}")

    # Kernels 1 and 2 at the rasterizer's shapes (16x16 tiles, L=1024),
    # against their plain versions; the backward with a cotangent in [-1, 1].
    feat, bg, counts, origins, cfg = cap.calls["forward"]
    has_flow = cap.calls["backward"][-1]
    out_k, contrib = dense.composite_forward_cuda(feat, bg, counts, origins, cfg)
    ref_out, ref_contrib = dense.composite_forward_plain(feat, bg, counts,
                                                         origins, cfg)
    what = f"bench {cfg.width}x{cfg.height}"
    err_f, lanes = compare(out_k, contrib, ref_out, ref_contrib, what)
    g = cotangent(np.random.default_rng(SEED + 40), cfg, device)
    dfeat = dense.composite_backward_cuda(feat, bg, out_k, g, counts, origins,
                                          cfg, has_flow)
    ref_dfeat = dense.composite_backward_plain(feat, bg, out_k, g, counts,
                                               origins, cfg, has_flow)
    instances = int(counts.sum())
    err_b, rows = compare_bwd(dfeat, ref_dfeat, lanes, what, rows=instances)
    for label, check in (
            ("zeroed dfeat", lambda: compare_bwd(
                torch.zeros_like(dfeat), ref_dfeat, lanes, what, instances)),
            ("dfeat of a cotangent with its columns rolled", lambda: compare_bwd(
                dense.composite_backward_cuda(feat, bg, out_k, g.roll(1, -1),
                                              counts, origins, cfg, has_flow),
                ref_dfeat, lanes, what, instances))):
        try:
            check()
        except AssertionError:
            continue
        raise AssertionError(f"{what}: the check passed a {label}")
    # The plain version's own spread: on the tiles that hold rows past the
    # elementwise tolerance, the plain version on the CPU against the card.
    past = ((dfeat - ref_dfeat).abs() > ATOL_BWD + RTOL_BWD
            * ref_dfeat.abs()).any(-1).any(-1)
    spread = "no row past the elementwise tolerance"
    if bool(past.any()):
        tiles = torch.nonzero(past)[:, 0]
        cpu = dense.composite_backward_plain(
            *(x[tiles].cpu() for x in (feat, bg, out_k, g, counts, origins)),
            cfg, has_flow)
        sub = ref_dfeat[tiles].cpu()
        spread = (f"on its {len(tiles)} tile(s) the plain version on the CPU "
                  f"differs from the card's by max "
                  f"{float((cpu - sub).abs().max()):.3g}, "
                  f"{int(((cpu - sub).abs() > ATOL_BWD + RTOL_BWD * sub.abs()).any(-1).sum())} "
                  f"row(s) past the elementwise tolerance")
    worst["dense_forward"] = max(worst["dense_forward"], err_f)
    worst["dense_backward"] = max(worst["dense_backward"], err_b)
    T, L, _ = feat.shape
    shape = (f"T={T} tiles of {cfg.tile_h}x{cfg.tile_w}, L={L}, instances "
             f"{instances}, deepest tile {int(counts.max())}, flow={has_flow}")
    log("bench", f"rasterizer {got}; kernels at its shapes ({shape}): forward "
        f"max_abs_err {err_f:.3g} ({lanes} contrib lanes differ), backward "
        f"max_abs_err {err_b:.3g} (max |dfeat| "
        f"{float(ref_dfeat.abs().max()):.3g}; {rows} of {instances} rows past "
        f"the tolerance, within twice it; {spread}); the check refuses a "
        f"zeroed dfeat and a rolled cotangent's")
    if device.type == "cuda":
        for name, kernel, plain, work in (
                ("dense_forward",
                 lambda: dense.composite_forward_cuda(feat, bg, counts,
                                                      origins, cfg),
                 lambda: dense.composite_forward_plain(feat, bg, counts,
                                                       origins, cfg),
                 work_of(feat, counts, origins, cfg, contrib)),
                ("dense_backward",
                 lambda: dense.composite_backward_cuda(
                     feat, bg, out_k, g, counts, origins, cfg, has_flow),
                 lambda: dense.composite_backward_plain(
                     feat, bg, out_k, g, counts, origins, cfg, has_flow),
                 work_of(feat, counts, origins, cfg, contrib, backward=True,
                         has_flow=has_flow))):
            ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 2)
            b_ms, b_by, t_bytes, t_ops = bound(*work)
            log("bench", f"{name} at the rasterizer's shapes ({shape}): "
                f"{ms:.4f} ms; plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
                f"({b_by}: {work[0]} B -> {t_bytes:.4f} ms, {work[1]} fp32 ops "
                f"-> {t_ops:.4f} ms); {100 * b_ms / ms:.2f} % of the bound")

    # The training step at bench_train's workload; the grow-and-replay and
    # the shrink must fall inside the warm-up.
    reset_launches()
    with tee_stdout() as out:
        got = bench.main(["--device", device.type, "--iters", str(iters),
                          "--warm", str(warm), *map(str, train_flags)])
    run = read_launches()
    for k, v in run.items():
        launches[k] += v
    check_bench_line(out.lines, got, "train_step", "ms/iter",
                     lambda v: BASELINE_MS / v)
    events = [(int(m.group(1)), m.group(2)) for m in (
        re.match(r"\[iter (\d+)\] (capacity overflow|occupancy tracking)", ln)
        for ln in out.lines) if m]
    late = [e for e in events if e[0] > warm]
    if late or not (run["dense_forward"] and run["dense_backward"]):
        raise AssertionError(f"bench: capacity events past the warm-up "
                             f"({late}) or dense kernels not launched ({run})")
    log("bench", f"train_step {got} ({iters} iterations, {warm} of warm-up) "
        f"on {card_line() if device.type == 'cuda' else 'cpu'}; capacity "
        f"events at iterations {events}; launches in the two runs {launches}")
    return launches


def nan_checkpoint(trainer, src, dst):
    """``src`` (a checkpoint of ``trainer``'s run) with a NaN written into
    the opacity of the first live row; returns ``dst``."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.utils.checkpoint import load_pytree, tree_leaves

    leaves, meta = load_pytree(src)
    k = next(i for i, leaf in enumerate(tree_leaves(trainer._checkpoint_tree()))
             if leaf is trainer.model.params.opacity)
    row = int(torch.nonzero(trainer.model.aux.alive)[0])
    leaves[k] = leaves[k].copy()
    leaves[k][row, 0] = np.nan
    np.savez(dst, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
             __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    return dst


def expect_nan_error(fn, what):
    """``fn()`` must raise FloatingPointError naming ``what``; returns the
    message."""
    try:
        fn()
    except FloatingPointError as e:
        if what not in str(e):
            raise AssertionError(f"FloatingPointError {e!r} does not name "
                                 f"{what}") from e
        return str(e)
    raise AssertionError(f"no FloatingPointError from {what}")


def phase_debug_nans(device, n_ftorf=16, iters=6):
    """The train CLI with ``--debug_nans`` (module docstring, 12)."""
    import threading

    import numpy as np
    import torch

    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.kernels.dense import _bg_to_tiles, _default_origins
    from gftorf_tpu_torch.render.settings import RasterConfig
    from gftorf_tpu_torch.utils import debug_nans

    out = os.path.join(TRAINER_DIR, "out", "debug_nans")
    cfg = os.path.join(ROOT, "configs", "ftorf.json")
    flags = ["--source_path", os.path.join(TRAINER_DIR, "ftorf"),
             "--total_num_views", n_ftorf, "--iterations", iters,
             "--warm_up", 2, "--test_iterations", 0,
             "--checkpoint_iterations", iters // 2]
    seen = {"ops": 0, "backward": 0, "threads": set()}
    orig = debug_nans.NanCheckMode.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        seen["ops"] += 1
        if "backward" in func.__name__:
            seen["backward"] += 1
            seen["threads"].add(threading.get_ident())
        return orig(self, func, types, args, kwargs)

    debug_nans.NanCheckMode.__torch_dispatch__ = spy
    try:
        t0 = time.perf_counter()
        on, recs_on, _ = train_cli(device, cfg, os.path.join(out, "on"), *flags,
                                   "--debug_nans")
        t_on = time.perf_counter() - t0
    finally:
        debug_nans.NanCheckMode.__torch_dispatch__ = orig
    t0 = time.perf_counter()
    off, recs_off, _ = train_cli(device, cfg, os.path.join(out, "off"), *flags)
    t_off = time.perf_counter() - t0
    d_on, d_off = on.check_ranks_agree(), off.check_ranks_agree()
    losses = [r["loss"] for r in recs_on], [r["loss"] for r in recs_off]
    if d_on != d_off or losses[0] != losses[1]:
        raise AssertionError(f"--debug_nans changed the run: digests {d_on} "
                             f"{d_off}, losses {losses}")
    bad = nan_checkpoint(off, os.path.join(out, "off", f"chkpnt{iters // 2}.npz"),
                         os.path.join(out, "nan.npz"))
    resumed, _, _ = train_cli(device, cfg, os.path.join(out, "resumed"), *flags,
                              "--start_checkpoint", bad, check=False)
    if resumed.iteration != iters:
        raise AssertionError(f"the NaN checkpoint resumed to {resumed.iteration}")
    msg = expect_nan_error(lambda: train_cli(
        device, cfg, os.path.join(out, "raised"), *flags, "--start_checkpoint",
        bad, "--debug_nans", check=False), "NaN in the output of")
    del on, off, resumed

    # Each kernel wrapper's own check: the ctypes launch writes memory the
    # dispatcher never sees. A NaN background reaches every output pixel; a
    # NaN cotangent every gradient row.
    rng = np.random.default_rng(SEED + 41)
    rc = RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                      max_per_tile=256)
    feat, bg, counts, origins = synthetic_tiles(rng, rc, 256, True, device)
    out_k, _ = dense.composite_forward_cuda(feat, bg, counts, origins, rc)
    g_nan = torch.full_like(out_k, float("nan"))
    fc = dataclasses.replace(rc, flat_stream=True)
    packed, _, fb = synthetic_stream(rng, fc, True, device, per_tile=20, deep=64)
    stream = gathered(packed, fb.gauss_flat, 0.0)
    forig = _default_origins(fc.num_tiles, fc, device)
    fbg = _bg_to_tiles(torch.zeros((7, fc.height, fc.width), device=device),
                       fc.num_tiles, fc)
    fout, _ = flat.composite_forward_flat_cuda(stream, fbg, fb.tile_start,
                                               fb.tile_count, forig, fc)
    # The NaN inputs are made outside the mode, which would stop at them.
    nan = {k: torch.full_like(v, float("nan"))
           for k, v in (("bg", bg), ("fbg", fbg), ("fg", fout))}
    checks = {
        "the dense_forward kernel": lambda: dense.composite_forward_cuda(
            feat, nan["bg"], counts, origins, rc),
        "the dense_backward kernel": lambda: dense.composite_backward_cuda(
            feat, bg, out_k, g_nan, counts, origins, rc, True),
        "the flat_forward kernel": lambda: flat.composite_forward_flat_cuda(
            stream, nan["fbg"], fb.tile_start, fb.tile_count, forig, fc),
        "the flat_backward kernel": lambda: flat.composite_backward_flat_cuda(
            stream, fbg, fout, nan["fg"], fb.tile_start, fb.tile_count, forig,
            fc, True),
    }
    if device.type == "cuda":
        for name, fn in checks.items():
            fn()  # outside the mode: no check
            with debug_nans.nan_checks():
                expect_nan_error(fn, name)
    # A backward function that makes a NaN (a norm's gradient at 0), caught
    # whether the mode reaches autograd's device thread or anomaly mode does.
    x = torch.zeros(3, device=device, requires_grad=True)
    with debug_nans.nan_checks():
        backward_msg = expect_nan_error(
            lambda: torch.linalg.vector_norm(x).backward(), "NaN")
    log("debug_nans", f"ftorf full width ({n_ftorf} frames), {iters} "
        f"iterations (deform MLP and flow from 3): with --debug_nans "
        f"{t_on:.1f} s, {seen['ops']} aten ops checked, {seen['backward']} of "
        f"them backward ops on {len(seen['threads'])} thread(s) (autograd's "
        f"device thread among them: "
        f"{bool(seen['threads'] - {threading.main_thread().ident})}); without "
        f"{t_off:.1f} s; the same state digest {d_on} and losses; the "
        f"checkpoint with a NaN opacity resumes without the switch and raises "
        f"with it ({msg!r}); a norm's gradient at 0 raises "
        f"({backward_msg!r}); "
        + ("each kernel wrapper raises on its NaN output inside the mode: "
           f"{sorted(checks)}" if device.type == "cuda"
           else "kernel wrapper checks only on CUDA"))
    if debug_nans.active() or torch.is_anomaly_enabled():
        raise AssertionError("the NaN checks outlived their block")
    log("debug_nans", "ok")


# ---------------------------------------------------------------- phase 7


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
    return (ci.feat, ci.bg_tiles, ci.binning.tile_count, ci.origins), cfg


def work_of(feat_tl, counts, origins, cfg, contrib, backward=False,
            has_flow=False, stream_rows=None):
    """Bytes the function must move and fp32 operations it must do on
    these inputs: rows up to each tile's last evaluated instance, pairs
    evaluated up to each pixel's early exit, contributing pairs. The
    forward reads the rows and bg and writes the (T, PIX, 32) block and
    the (T, L) counts; the backward also reads that block and the
    cotangent, and writes the (T, L, 24) gradient. For the flat kernels
    ``feat_tl`` is the stream cut into tiles (flat.stream_slots) and
    ``stream_rows`` the stream's length K_pad: they write K_pad counts or
    gradient rows, and read tile_start besides the counts and origins."""
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
    out_rows = T * L if stream_rows is None else stream_rows
    ints = T * (3 if stream_rows is None else 4)
    if backward:
        nbytes = 4 * (rows * C + ints + T * pix * (12 + 32 + 32) + out_rows * C)
        per_pair = (OPS_CONTRIB_BWD + (OPS_FLOW_BWD if has_flow else 0)
                    + (OPS_DD_BWD if cfg.need_dd else 0))
        ops = OPS_EVAL * evaluated + per_pair * contributing
    else:
        nbytes = 4 * (rows * C + ints + T * pix * (12 + 32) + out_rows)
        ops = (OPS_EVAL * evaluated + OPS_CONTRIB * contributing
               + (OPS_DD * contributing if cfg.need_dd else 0))
    return nbytes, ops


def bound(nbytes, ops):
    """(bound_ms, bound_by, ms for the bytes, ms for the operations)."""
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


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


class capturing:
    """For a ``with`` block, ``self.calls[name]`` holds the arguments of
    the first call of each ``name: (module, attr)`` of ``targets``."""

    def __init__(self, targets):
        self.targets, self.calls = targets, {}
        self.originals = {name: getattr(module, attr)
                          for name, (module, attr) in targets.items()}

    def _spy(self, name):
        import torch

        def call(*args):
            self.calls.setdefault(name, tuple(
                a.detach() if torch.is_tensor(a) else a for a in args))
            return self.originals[name](*args)
        return call

    def __enter__(self):
        for name, (module, attr) in self.targets.items():
            setattr(module, attr, self._spy(name))
        return self

    def __exit__(self, *exc):
        for name, (module, attr) in self.targets.items():
            setattr(module, attr, self.originals[name])


def capture_calls(run, it, idx, targets):
    """The arguments of the first call of each ``name: (module, attr)`` of
    ``targets`` in one step of ``run`` (outside any counted window): what
    the training step hands the compositor, the instance gather, etc."""
    with capturing(targets) as cap:
        run.run_step(it, idx)
    return cap.calls


def gather_costs(packed, ids_flat, ids_dense):
    """Milliseconds of the work around the compositor that scales with its
    layout's row count, for one render: the instance gather (with the flat
    path's zeroing of padding rows), its backward (``segment_sum_rows``
    over the rows), and zeroing the flat backward's (K_pad, 24) output."""
    import torch

    from gftorf_tpu_torch.render.rasterize import segment_sum_rows

    P = packed.shape[0]
    ids_dense = ids_dense.reshape(-1)
    g_flat = torch.ones((ids_flat.shape[0], 24), device=packed.device)
    g_dense = torch.ones((ids_dense.shape[0], 24), device=packed.device)
    with torch.no_grad():
        return {
            "flat gather + where": time_ms(lambda: torch.where(
                (ids_flat >= 0)[:, None], packed[ids_flat.clamp(min=0).long()],
                0.0), 20),
            "dense gather": time_ms(
                lambda: packed[ids_dense.clamp(min=0).long()], 20),
            "flat segment_sum_rows": time_ms(
                lambda: segment_sum_rows(g_flat, ids_flat, P), 20),
            "dense segment_sum_rows": time_ms(
                lambda: segment_sum_rows(g_dense, ids_dense, P), 20),
            "flat dfeat zero-fill": time_ms(lambda: torch.zeros_like(g_flat), 20),
        }


def phase_timing(scenes, runs, flat_runs, worst, launches, render_launches,
                 sharded_launches, trainer_launches, bench_launches):
    import torch

    from gftorf_tpu_torch.render.kernels import dense, flat

    for s in scenes:  # the serving shapes (slice 1's measurement)
        args, cfg = composite_inputs_of(s, 1)
        out, contrib = dense.composite_forward_cuda(*args, cfg)
        ref_out, ref_contrib = dense.composite_forward_plain(*args, cfg)
        err, _ = compare(out, contrib, ref_out, ref_contrib, f"{s.name} serving")
        worst["dense_forward"] = max(worst["dense_forward"], err)
        ms = time_ms(lambda: dense.composite_forward_cuda(*args, cfg), 50)
        plain_ms = time_ms(lambda: dense.composite_forward_plain(*args, cfg), 3)
        b_ms, b_by, t_bytes, t_ops = bound(*work_of(args[0], args[2], args[3],
                                                     cfg, contrib))
        T, L, _ = args[0].shape
        log("timing", f"dense_forward at {s.name} serving shapes (T={T}, "
            f"PIX={cfg.tile_pixels}, L={L}, instances {int(args[2].sum())}, "
            f"gates={cfg.need_dd}): {ms:.4f} ms; plain {plain_ms:.3f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}); max_abs_err {err:.3g}")

    # The ftorf training shapes: the blocks of one step on an integration
    # frame (flow on), as the step hands them to the kernels, dense and flat.
    # The module (the package re-exports the function under its name).
    rasterize = sys.modules["gftorf_tpu_torch.render.rasterize"]

    calls = capture_calls(runs[0], 2122, 0, {
        "forward": (dense, "composite_forward"),
        "backward": (dense, "composite_backward"),
        "gather": (rasterize, "gather_rows")})
    feat, bg, counts, origins, cfg = calls["forward"]
    _, _, out, g, _, _, _, has_flow = calls["backward"]
    out_k, contrib = dense.composite_forward_cuda(feat, bg, counts, origins, cfg)
    ref_out, ref_contrib = dense.composite_forward_plain(feat, bg, counts,
                                                         origins, cfg)
    err_f, lanes = compare(out_k, contrib, ref_out, ref_contrib, "ftorf training")
    dfeat = dense.composite_backward_cuda(feat, bg, out, g, counts, origins,
                                          cfg, has_flow)
    ref_dfeat = dense.composite_backward_plain(feat, bg, out, g, counts,
                                               origins, cfg, has_flow)
    err_b, _ = compare_bwd(dfeat, ref_dfeat, lanes, "ftorf training")
    worst["dense_forward"] = max(worst["dense_forward"], err_f)
    worst["dense_backward"] = max(worst["dense_backward"], err_b)

    fcalls = capture_calls(flat_runs[0], 2122, 0, {
        "forward": (flat, "composite_forward_flat"),
        "backward": (flat, "composite_backward_flat"),
        "gather": (rasterize, "gather_rows")})
    fwd, bwd = fcalls["forward"], fcalls["backward"]
    ffeat, _, fstart, fcount, forigins, fcfg = fwd
    fhas_flow = bwd[-1]
    fout, fcontrib = flat.composite_forward_flat_cuda(*fwd)
    ref_out, ref_contrib = flat.composite_forward_flat_plain(*fwd)
    err_ff, flanes = compare(fout, fcontrib, ref_out, ref_contrib,
                             "ftorf flat training")
    fdfeat = flat.composite_backward_flat_cuda(*bwd)
    ref_fdfeat = flat.composite_backward_flat_plain(*bwd)
    err_fb, _ = compare_bwd(fdfeat, ref_fdfeat, flanes, "ftorf flat training")
    worst["flat_forward"] = max(worst["flat_forward"], err_ff)
    worst["flat_backward"] = max(worst["flat_backward"], err_fb)
    slot, _ = flat.stream_slots(fstart, fcount)
    K = ffeat.shape[0]
    costs = gather_costs(fcalls["gather"][0], fcalls["gather"][1],
                         calls["gather"][1])
    log("timing", f"work around the compositor of one ftorf training render "
        f"(packed rows {fcalls['gather'][0].shape[0]}, stream K_pad {K}, dense "
        f"block T*L {calls['gather'][1].numel()}), ms: " + "; ".join(
            f"{k} {v:.4f}" for k, v in costs.items()))

    T, L, _ = feat.shape
    shapes = {
        "dense": f"T={T}, PIX={cfg.tile_pixels}, L={L}, instances {int(counts.sum())}",
        "flat": f"T={T}, PIX={fcfg.tile_pixels}, K_pad={K}, deepest tile "
                f"{int(fcount.max())}, instances {int(fcount.sum())}",
    }
    timings = {
        "dense_forward": (
            lambda: dense.composite_forward_cuda(feat, bg, counts, origins, cfg),
            lambda: dense.composite_forward_plain(feat, bg, counts, origins, cfg),
            work_of(feat, counts, origins, cfg, contrib), has_flow),
        "dense_backward": (
            lambda: dense.composite_backward_cuda(feat, bg, out, g, counts,
                                                  origins, cfg, has_flow),
            lambda: dense.composite_backward_plain(feat, bg, out, g, counts,
                                                   origins, cfg, has_flow),
            work_of(feat, counts, origins, cfg, contrib, backward=True,
                    has_flow=has_flow), has_flow),
        "flat_forward": (
            lambda: flat.composite_forward_flat_cuda(*fwd),
            lambda: flat.composite_forward_flat_plain(*fwd),
            work_of(ffeat[slot], fcount, forigins, fcfg, fcontrib,
                    stream_rows=K), fhas_flow),
        "flat_backward": (
            lambda: flat.composite_backward_flat_cuda(*bwd),
            lambda: flat.composite_backward_flat_plain(*bwd),
            work_of(ffeat[slot], fcount, forigins, fcfg, fcontrib,
                    backward=True, has_flow=fhas_flow, stream_rows=K), fhas_flow),
    }
    steps = sum(r.steps for r in runs)
    # The train-flat phase also counts its first steps against dense.
    counted = {"dense": f"{steps} steps",
               "flat": f"{steps} steps and {len(flat_runs)} first steps "
                       "compared with dense"}
    # Blocks per SM, registers, spills and shared memory of the instances
    # these shapes run.
    occupancy = {
        "dense_forward": dense.forward_occupancy(cfg.tile_pixels, cfg.need_dd,
                                                 cfg.need_distribution),
        "flat_forward": flat.forward_occupancy(fcfg.tile_pixels, fcfg.need_dd,
                                               fcfg.need_distribution),
        "dense_backward": dense.backward_occupancy(cfg.tile_pixels, cfg.need_dd,
                                                   has_flow),
        "flat_backward": flat.backward_occupancy(fcfg.tile_pixels, fcfg.need_dd,
                                                 fhas_flow),
    }
    kernels = []
    for name, (kernel, plain, (nbytes, ops), flow_on) in timings.items():
        ms = time_ms(kernel, 20)
        plain_ms = time_ms(plain, 2)
        b_ms, b_by, t_bytes, t_ops = bound(nbytes, ops)
        occ = occupancy[name]
        log("timing", f"{name} at ftorf training shapes "
            f"({shapes[name.split('_')[0]]}, flow={flow_on}): {ms:.4f} ms; "
            f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms ({nbytes} B -> "
            f"{t_bytes:.4f} ms, {ops} fp32 ops -> {t_ops:.4f} ms); launches in "
            f"the {'train-flat' if name.startswith('flat') else 'train'} phase "
            f"{launches[name]} over {counted[name.split('_')[0]]}, in the "
            f"render phase {render_launches[name]}, in the sharded phase "
            f"{sharded_launches[name]} (summed over ranks), in the trainer "
            f"phase's torf run {trainer_launches[name]}, in the bench phase "
            f"{bench_launches[name]}; max_abs_err "
            f"{worst[name]:.3g}; {occ['blocks_per_sm']} block(s) of "
            f"{cfg.tile_pixels} threads per SM, {occ['registers']} registers, "
            f"{occ['spill_bytes']} B local, {occ['shared_bytes']} B shared "
            f"(need_dd={cfg.need_dd}, need_distribution={cfg.need_distribution})")
        kernels.append(dict(
            name=name, route="cuda", source=f"gftorf_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=(launches[name] + render_launches[name]
                      + sharded_launches[name] + trainer_launches[name]
                      + bench_launches[name]),
            max_abs_err=worst[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
    torch.cuda.synchronize()
    log("timing", "ok")
    return kernels


def phase_fit_check(device, main_launches):
    """Kernel 5, the Trainer's start-up fit check (module docstring, 13);
    returns its entry of the ``kernels`` line, ``main_launches`` the
    checks counted in the main-path phases."""
    import torch

    from gftorf_tpu_torch import render_sets
    from gftorf_tpu_torch.render.kernels import dense

    props = torch.cuda.get_device_properties(device)
    log("fit-check", f"{card_line()}; the device properties the plain model "
        "reads: " + ", ".join(f"{k} {getattr(props, k)}" for k in FIT_PROPS))

    # Every instance of the backward template at the tiles the main path
    # runs (16x32 in the configs, 16x16 in the rasterizer bench): the
    # card's query against the plain model.
    worst = 0
    for pix in (512, 256):
        for need_dd in (False, True):
            for has_flow in (True, False):
                occ = dense.backward_occupancy(pix, need_dd, has_flow)
                plain = dense.blocks_per_sm_plain(
                    props, pix, occ["registers"], occ["shared_bytes"])
                worst = max(worst, abs(occ["blocks_per_sm"] - plain))
                log("fit-check", f"instance need_dd={need_dd}, has_flow="
                    f"{has_flow} at {pix} pixels: {occ['blocks_per_sm']} "
                    f"block(s) per SM (plain model {plain}), "
                    f"{occ['registers']} registers, {occ['spill_bytes']} B "
                    f"local, {occ['shared_bytes']} B shared")
    if worst:
        raise AssertionError(f"the occupancy query and its plain model differ "
                             f"by up to {worst} blocks per SM")

    # A Trainer start on the card (load_trained on each [trainer] model)
    # checks the instances its steps launch and launches no kernel.
    trainers = {}
    for name in ("ftorf", "torf"):
        reset_launches()
        tr, _, _ = render_sets.load_trained(
            os.path.join(TRAINER_DIR, "out", name), -1, device)
        torch.cuda.synchronize(device)
        n = read_launches()
        if n[FIT_CHECK] != 1 or any(n[k] for k in KERNELS):
            raise AssertionError(f"a {name} Trainer start launched {n}")
        want = {(tr.dd_possible, True), (tr.dd_possible, False)}
        if not want <= set(tr.backward_fits):
            raise AssertionError(f"the {name} Trainer checked "
                                 f"{sorted(tr.backward_fits)}, not {want}")
        trainers[name] = tr
        log("fit-check", f"{name} Trainer start (configs/{name}.json, "
            f"{tr.cfg.tpu.tile_h}x{tr.cfg.tpu.tile_w} tiles, dd_possible "
            f"{tr.dd_possible}): kernel launches {n}; " + "; ".join(
                f"need_dd={dd}, has_flow={fl}: {o['blocks_per_sm']} block(s) "
                f"per SM, {o['registers']} registers, {o['spill_bytes']} B "
                f"local, {o['shared_bytes']} B shared"
                for (dd, fl), o in tr.backward_fits.items()))

    # Host time per check (the first call, which loads the library, is
    # behind us), and the plain model's for the same instances.
    tr = trainers["ftorf"]
    t = tr.cfg.tpu
    pix = t.tile_h * t.tile_w
    attrs = {k: (o["registers"], o["shared_bytes"])
             for k, o in tr.backward_fits.items()}

    def check():
        return dense.check_backward_fits(t.tile_h, t.tile_w, tr.dd_possible,
                                         device)

    def plain():
        p = torch.cuda.get_device_properties(device)
        return {k: dense.blocks_per_sm_plain(p, pix, r, b)
                for k, (r, b) in attrs.items()}

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(FIT_REPS):
            fn()
        return 1e3 * (time.perf_counter() - t0) / FIT_REPS

    ms, plain_ms = host_ms(check), host_ms(plain)
    if plain() != {k: o["blocks_per_sm"] for k, o in check().items()}:
        raise AssertionError("the check and the plain model disagree")

    # No device work: under the profiler, in a fresh process (this one's
    # saw no device operation at all after the phases before it).
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.fit_check_device_ops()"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the fit check's profile failed:\n{proc.stderr[-3000:]}")
    device_ops = json.loads(proc.stdout.strip().splitlines()[-1])
    if device_ops[0] and device_ops[1] != device_ops[0]:
        raise AssertionError(f"device operations: {device_ops[0]} in the "
                             f"marker's window, {device_ops[1]} with 20 checks")
    seen = (f"{device_ops[0]} device operations with and without 20 checks, "
            "the marker's" if device_ops[0] else
            "not measured: the profiler saw no device operation")

    # Refusals: a tile past the kernel's block, a query that reports no
    # block, and one that returns a CUDA error; each stub undone after.
    lib = dense._lib_backward()
    query = lib.gftorf_dense_backward_occupancy

    def no_block(p, dd, fl, info):
        err = query(p, dd, fl, info)
        info[0] = 0
        return err

    refusals = []
    for what, stub, fn in (
            ("32x32 tiles", None,
             lambda: dense.check_backward_fits(32, 32, tr.dd_possible, device)),
            ("a query reporting 0 blocks", no_block, check),
            ("a query returning cudaError 2", lambda p, dd, fl, info: 2, check)):
        if stub is not None:
            lib.gftorf_dense_backward_occupancy = stub
        try:
            fn()
        except RuntimeError as e:
            refusals.append(f"{what}: {e}")
        else:
            raise AssertionError(f"the fit check passed {what}")
        finally:
            lib.gftorf_dense_backward_occupancy = query
        check()
    for line in refusals:
        log("fit-check", f"refused {line}")
    if main_launches < 1:
        raise AssertionError("the fit check ran no time on the main path")
    log("fit-check", f"check of {len(attrs)} instances: {ms:.6f} ms a call "
        f"on the host (mean of {FIT_REPS}), plain model {plain_ms:.6f} ms; no "
        f"device work (bound 0: 0 bytes, 0 operations; {seen}); query = plain "
        f"model in every instance; {main_launches} checks on the main path")
    log("fit-check", "ok")
    return dict(name=FIT_CHECK, route="cuda",
                source="gftorf_tpu_torch/csrc/dense_backward.cu",
                replaces=REPLACES[FIT_CHECK], launches=main_launches,
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=0.0,
                bound_by="bytes", library_ms=None)


def fit_check_device_ops():
    """Print, as JSON, the device operations torch.profiler sees in a window
    that runs one marker (a fill and an add) without and with 20 fit
    checks at 16x32 tiles: the [fit-check] phase runs it in a fresh
    process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gftorf_tpu_torch.render.kernels import dense

    device = torch.device("cuda")
    dense.check_backward_fits(16, 32, False, device)  # loads the library
    ops = []
    for n in (0, 20):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=device).add_(1)
            for _ in range(n):
                dense.check_backward_fits(16, 32, False, device)
            torch.cuda.synchronize(device)
        events = trace_events(prof, os.path.join(
            ROOT, "build", "profile", f"fit_check_{n}.json"))
        ops.append(len(device_busy(events)[2]))
    print(json.dumps(ops), flush=True)


# ------------------------------------------------------- --profile only


def trace_events(prof, path):
    """Write the profiler's chrome trace to ``path`` and read its events."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_busy(events):
    """(busy us, us by device op name, spans): the union of the kernel,
    memcpy and memset intervals of a trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, by_name = 0.0, -1.0, {}
    for a, z, name in spans:
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
        by_name[name] = by_name.get(name, 0.0) + (z - a)
    return busy, by_name, spans


def phase_profile(scenes, reps=5):
    """Where a served frame's time goes. Per stage of one ToF render:
    host clock around each synchronised stage, median of ``reps``. Per
    scene: the device's busy share of whole frames under torch.profiler
    (the union of kernel, memcpy and memset intervals over the host wall
    time of the window), and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gftorf_tpu_torch.render.binning import bin_gaussians, bin_gaussians_flat
    from gftorf_tpu_torch.render.composite import tiles_to_image
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.preprocess import preprocess
    from gftorf_tpu_torch.train.step import _compose, _query_deform

    for s in scenes:
        st, frame, cfg = s.static, s.frames[1], s.static.config_tof
        n = s.n_points
        tag = f"{s.name}{' flat' if cfg.flat_stream else ''}"
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
                T = cfg.num_tiles
                bg = dense._bg_to_tiles(torch.zeros((7, cfg.height, cfg.width),
                                                    device=s.device), T, cfg)
                org = dense._default_origins(T, cfg, s.device)
                binner = bin_gaussians_flat if cfg.flat_stream else bin_gaussians
                b = stage("binning", lambda: binner(
                    pre.rect, pre.depth_view, pre.valid, cfg, cfg.capacity_for(n)))
                ids = b.gauss_flat if cfg.flat_stream else b.gauss_id.reshape(-1)
                idc = ids.clamp(min=0).to(torch.int64)
                if cfg.flat_stream:
                    feat = stage("pack + gather", lambda: torch.where(
                        (ids >= 0)[:, None], dense.pack_gaussian_features(pre)[idc],
                        0.0))
                    blk, contrib = stage("composite kernel", lambda: flat.composite_forward_flat(
                        feat, bg, b.tile_start, b.tile_count, org, cfg))
                else:
                    feat = stage("pack + gather", lambda: dense.pack_gaussian_features(
                        pre)[idc].reshape(T, -1, 24))
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
        log("profile", f"{tag} one ToF render, stage medians of {reps}: "
            + "; ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in med.items()) + f"; sum {total:.3f} ms")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fid in range(len(s.frames)):
                s.render(fid)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        path = os.path.join(ROOT, "build", "profile",
                            f"trace_{tag.replace(' ', '_')}.json")
        events = trace_events(prof, path)
        busy, by_name, spans = device_busy(events)
        if not spans:
            log("profile", f"{tag}: the profiler saw no device activity "
                "(device busy share not measured)")
            continue
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        nf = len(s.frames)
        log("profile", f"{tag} {nf} frames under the profiler: wall "
            f"{wall_us / 1e3 / nf:.3f} ms/frame, device busy "
            f"{busy / 1e3 / nf:.3f} ms/frame, idle share "
            f"{1 - busy / wall_us:.3f}, {len(spans) / nf:.0f} device ops/frame")
        for name, us in top:
            log("profile", f"  {us / 1e3 / nf:.4f} ms/frame "
                f"({100 * us / busy:.1f}% of busy): {name[:110]}")


def phase_profile_train(run, steps=4):
    """Where a training step's time goes: torch.profiler over ``steps``
    ftorf steps; device busy share, device time by the step's spans
    (train_step.forward / .backward / .update, found through each kernel's
    launch) and by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run.step(2200, 0)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(steps):
            run.step(2201 + k, k % len(run.frame_ids))
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    tag = f"{run.name}{'_flat' if run.flat else ''}"
    path = os.path.join(ROOT, "build", "profile", f"trace_train_{tag}.json")
    events = trace_events(prof, path)
    busy, by_name, spans = device_busy(events)
    if not spans:
        log("profile", f"{tag} training: the profiler saw no device "
            "activity (device busy share not measured)")
        return
    # Kernel -> launching runtime call (by correlation id) -> enclosing span.
    regions = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("cat") == "user_annotation"
               and e["name"].startswith("train_step.")]
    # Launch calls of both CUDA APIs ("cuda_runtime", and the low-level one
    # that cuBLAS launches its GEMMs through).
    launch_ts = {e["args"].get("correlation"): e["ts"] for e in events
                 if str(e.get("cat", "")).startswith("cuda_") and "args" in e}
    by_region = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        region = next((r for a, z, r in regions
                       if ts is not None and a <= ts <= z), "outside spans")
        by_region[region] = by_region.get(region, 0.0) + e["dur"]
    log("profile", f"{tag} {steps} training steps under the profiler: "
        f"wall {wall_us / 1e3 / steps:.3f} ms/step, device busy "
        f"{busy / 1e3 / steps:.3f} ms/step, idle share {1 - busy / wall_us:.3f}, "
        f"{len(spans) / steps:.0f} device ops/step")
    log("profile", "  device time by span: " + "; ".join(
        f"{k} {v / 1e3 / steps:.3f} ms/step" for k, v in sorted(
            by_region.items(), key=lambda kv: -kv[1])))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log("profile", f"  {us / 1e3 / steps:.4f} ms/step "
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
    phase_kernels_flat(device, worst)
    scenes = phase_serve(device)
    flat_scenes = phase_serve_flat(scenes)
    runs, launches = phase_train(device)
    flat_runs, flat_launches = phase_train_flat(runs)
    launches.update(flat_launches)
    phase_train_vs_cpu(device)
    phase_deep_tile(device)
    phase_determinism(scenes + flat_scenes, runs + flat_runs)
    trainer_launches = phase_trainer(device, drift="--drift" in sys.argv[1:])
    render_launches = phase_render(device)
    sharded_launches = phase_sharded(device, runs)
    phase_sharded_trainer(device)
    log("sharded", "ok")
    bench_launches = phase_bench(device, worst)
    log("bench", "ok")
    phase_debug_nans(device)
    kernels = phase_timing(scenes, runs, flat_runs, worst, launches,
                           render_launches, sharded_launches, trainer_launches,
                           bench_launches)
    kernels.append(phase_fit_check(device, sum(
        n[FIT_CHECK] for n in (trainer_launches, render_launches, bench_launches))))
    if "--profile" in sys.argv[1:]:
        phase_profile(scenes + flat_scenes)
        phase_profile_train(runs[0])
        phase_profile_train(flat_runs[0])
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
