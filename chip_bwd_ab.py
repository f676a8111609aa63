#!/usr/bin/env python3
"""Times builds of the backward compositing kernels against each other on
one card, in one process, on the same inputs.

    python3 chip_bwd_ab.py [--parent DIR]

Builds csrc/dense_backward.cu and csrc/flat_backward.cu of this checkout
as they are ("final") and once for each entry of VARIANTS, a copy of
csrc/ with composite_tile.cuh patched to undo one design choice (the
cull, the paired rows, the single reciprocal, the 32-row sub-batch, one
block per SM) or the plan the redesign started from; with ``--parent``, also
the same two sources of another checkout (DIR is its root; its C entries
must take the same arguments). Inputs: the blocks that one ftorf training
step (iteration 2101, an integration frame, flow on) hands the dense and
the flat backward, at full width (chip_smoke.py's TrainRun), and the flat
stream of chip_smoke.py's deep-tile scene. For each input it prints what
the warps meet there (``work_split``), then each build's time (20
launches, CUDA events, every build once forwards and once backwards
through the list) and the largest difference of its output from the
final build's (0: bitwise equal); for the dense input also each tile's
time alone. Needs a CUDA card and nvcc; prints the card's name and power
limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NAMES = ("dense_backward", "flat_backward")
# Patches of composite_tile.cuh that undo one design choice each.
NO_CULL = [("lane < m && !culled(sm.box[s0 + lane], rect)", "lane < m")]
SUB16 = [("constexpr int SUB = 32;", "constexpr int SUB = 16;")]
IEEE_DIV = [("    const float iq = 1.0f / q;  // one division, not four\n", ""),
            ("T * e - (e_tot - uf) * iq + T * T * e_p -\n"
             "                    2.0f * (ep_tot - up) * iq - t_final * iq * bg_dot;",
             "T * e - (e_tot - uf) / q + T * T * e_p -\n"
             "                    2.0f * (ep_tot - up) / q - t_final / q * bg_dot;"),
            ("(u_dd_tot - udd) * iq;", "(u_dd_tot - udd) / q;")]
ONE_ROW = [("if (rest != 0u) {  // a second live row: walk the two together",
            "if (false) {")]
# Two blocks an SM need SUB = 16 to fit their shared memory.
TWO_BLOCKS = SUB16 + [("constexpr int BWD_MIN_BLOCKS = 1;",
                       "constexpr int BWD_MIN_BLOCKS = 2;")]
# tag -> patch of composite_tile.cuh
VARIANTS = {
    "final": [],
    "one_row": ONE_ROW,
    "ieee_div": IEEE_DIV,
    "sub16": SUB16,
    "no_cull": NO_CULL,
    "two_blocks": TWO_BLOCKS,
    # The plan before these measurements, as near as a patch gets: 16-row
    # sub-batches, two blocks an SM, four IEEE divisions, one row at a
    # time (the step stays without branches).
    "planned": TWO_BLOCKS + IEEE_DIV + ONE_ROW,
}
REF = "final"  # outputs are compared with this build's


def patched(tag, csrc, patch):
    """A copy of ``csrc`` under build/ab/<tag>/ with each (old, new) text
    replacement of ``patch`` made (each old text must occur once)."""
    import shutil

    dst = os.path.join(ROOT, "build", "ab", tag)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for old, new in patch:
        path = os.path.join(dst, "composite_tile.cuh")
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"patch {tag}: {old!r} does not occur once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def build_all(variants):
    """(tag, csrc dir, patch) -> {(tag, name): C entry}, one nvcc per
    library, all at once."""
    from gftorf_tpu_torch.render.kernels.build import NVCC_FLAGS, _nvcc

    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for tag, csrc, patch in variants:
        if patch:
            csrc = patched(tag, csrc, patch)
        for name in NAMES:
            lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib,
                   os.path.join(csrc, f"{name}.cu")]
            jobs[tag, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ab] build {key[0]} {key[1]}: {line.strip()}")
        fn_lib = ctypes.CDLL(lib)
        fn = getattr(fn_lib, f"gftorf_{key[1]}")
        n_ptr = 7 if key[1] == "dense_backward" else 8
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def launcher(fn, name, args):
    """A call of C entry ``fn`` on wrapper-style ``args``; returns dfeat."""
    import torch

    from gftorf_tpu_torch.render.kernels.dense import aligned16

    if name == "dense_backward":
        feat, bg, out, g, counts, origins, cfg, flow = args
        feat = aligned16(feat)
        T, L, _ = feat.shape

        def call():
            dfeat = torch.empty_like(feat)
            err = fn(feat.data_ptr(), bg.data_ptr(), out.data_ptr(), g.data_ptr(),
                     counts.data_ptr(), origins.data_ptr(), dfeat.data_ptr(), T, L,
                     cfg.tile_pixels, cfg.tile_w, cfg.width, cfg.height,
                     int(cfg.need_dd), int(flow),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return dfeat
        return call
    feat, bg, out, g, start, count, origins, cfg, flow = args
    feat = aligned16(feat)
    K, T = feat.shape[0], bg.shape[0]

    def call():
        dfeat = torch.zeros_like(feat)
        err = fn(feat.data_ptr(), bg.data_ptr(), out.data_ptr(), g.data_ptr(),
                 start.data_ptr(), count.data_ptr(), origins.data_ptr(),
                 dfeat.data_ptr(), T, K, cfg.tile_pixels, cfg.tile_w, cfg.width,
                 cfg.height, int(cfg.need_dd), int(flow),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return dfeat
    return call


def tile_times(fn, args):
    """The dense backward of ``fn`` on each tile of ``args`` alone (ms,
    CUDA events, 5 launches each), and on the first 132 tiles (one per SM
    of an H100)."""
    import chip_smoke as cs

    feat, bg, out, g, counts, origins, cfg, flow = args
    T = feat.shape[0]

    def part(sl):
        return launcher(fn, "dense_backward", (feat[sl], bg[sl], out[sl], g[sl],
                                               counts[sl], origins[sl], cfg, flow))
    each = [cs.time_ms(part(slice(t, t + 1)), 5) for t in range(T)]
    return each, cs.time_ms(part(slice(0, min(T, 132))), 20)


def work_split(label, name, args, chunk=4):
    """What the kernel's warps meet on these inputs, from the plain
    version's arithmetic: (row, warp) pairs up to each tile's count, those
    the cull skips, those after every pixel of the warp stopped, those the
    warp walks, those with a contributing pixel, and how many of the
    warp's 32 lanes contribute there."""
    import torch

    from gftorf_tpu_torch.render.composite import ALPHA_EPS, ALPHA_MAX, T_STOP
    from gftorf_tpu_torch.render.kernels import dense, flat

    if name == "dense_backward":
        feat, _, _, _, counts, origins, cfg, _ = args
    else:
        feat, _, _, _, start, counts, origins, cfg, _ = args
        slot, present = flat.stream_slots(start, counts)
        feat = torch.where(present[..., None], feat[slot], 0.0)
    T, L, _ = feat.shape
    pix, tw = cfg.tile_pixels, cfg.tile_w
    W = pix // 32
    rects = dense.warp_rects(origins, tw, pix)
    pid = torch.arange(pix, device=feat.device)
    lane = torch.arange(L, device=feat.device)
    tot = {k: 0 for k in ("pairs", "culled", "done", "walked", "hit", "lanes")}
    crit = {k: [] for k in ("total", "row", "sub16", "sub64", "free")}
    hist = torch.zeros(33, dtype=torch.int64, device=feat.device)
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        c = feat[sl].shape[0]
        n = counts[sl, None].long()
        present = lane < n  # (c, L)
        f = torch.where(present[..., None], feat[sl], 0.0)
        cull = torch.stack([dense.warp_cull_plain(f[i], rects[t0 + i])
                            for i in range(c)])  # (c, L, W)
        px = (origins[sl, 0, None] + pid % tw).float()
        py = (origins[sl, 1, None] + pid // tw).float()
        inside = (px < cfg.width) & (py < cfg.height)
        dx = f[:, None, :, 0] - px[..., None]
        dy = f[:, None, :, 1] - py[..., None]
        power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
                 - f[:, None, :, 3] * dx * dy)
        alpha = torch.clamp(f[:, None, :, 5] * torch.exp(power.clamp(max=0)),
                            max=ALPHA_MAX)
        valid = (power <= 0) & (alpha >= ALPHA_EPS) & present[:, None, :] & inside[..., None]
        t_incl = torch.cumprod(1.0 - torch.where(valid, alpha, 0.0), -1)
        stop = valid & (t_incl < T_STOP)
        contrib = valid & ~stop & (torch.cumsum(stop.int(), -1) == 0)
        # A pixel is done before row j once it stopped at a row < j.
        done = (torch.cumsum(stop.int(), -1) - stop.int()) > 0
        done = done | ~inside[..., None]
        wdone = done.reshape(c, W, 32, L).all(2).transpose(1, 2)  # (c, L, W)
        hits = contrib.reshape(c, W, 32, L).sum(2).transpose(1, 2)  # (c, L, W)
        p = present[..., None].expand(-1, -1, W)
        walked = p & ~cull & ~wdone
        tot["pairs"] += int(p.sum())
        tot["culled"] += int((p & cull).sum())
        tot["done"] += int((p & ~cull & wdone).sum())
        tot["walked"] += int(walked.sum())
        tot["hit"] += int((walked & (hits > 0)).sum())
        tot["lanes"] += int(hits[walked].sum())
        hist += torch.bincount(hits[walked & (hits > 0)].flatten(), minlength=33)
        # Per tile, in walked pairs: all of them, and the longest chain of
        # one warp between barriers every row, every 16 or 64 rows, or none.
        wk = walked.int()
        Lp = -(-L // 64) * 64
        wk = torch.nn.functional.pad(wk, (0, 0, 0, Lp - L))
        crit["total"] += wk.sum((1, 2)).tolist()
        crit["row"] += wk.amax(2).sum(1).tolist()
        crit["sub16"] += wk.reshape(c, Lp // 16, 16, W).sum(2).amax(2).sum(1).tolist()
        crit["sub64"] += wk.reshape(c, Lp // 64, 64, W).sum(2).amax(2).sum(1).tolist()
        crit["free"] += wk.sum(1).amax(1).tolist()
    h = hist.tolist()
    print(f"[ab] work on {label} (T={T}, L={L}): (row, warp) pairs {tot['pairs']}, "
          f"culled {tot['culled']}, after the warp's pixels stopped {tot['done']}, "
          f"walked {tot['walked']}, with a contributing lane {tot['hit']} "
          f"(contributing lanes {tot['lanes']}; pairs with 1 / 2 / 3-8 / 9-16 / "
          f"17-32 lanes: {h[1]} / {h[2]} / {sum(h[3:9])} / {sum(h[9:17])} / "
          f"{sum(h[17:])})", flush=True)
    print(f"[ab]   walked pairs per tile, max / mean over tiles: " + "; ".join(
        f"{k} {max(v)} / {sum(v) / len(v):.1f}" for k, v in crit.items())
        + " (row, sub16, sub64, free: one warp's longest chain with a barrier "
        "every row, 16 rows, 64 rows, or none)", flush=True)


def inputs(device):
    """{label: (kernel name, wrapper args)} at the ftorf training shapes
    (dense and flat) and on the deep-tile scene (flat)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.rasterize import composite_inputs
    from gftorf_tpu_torch.render.settings import RasterConfig

    run = cs.TrainRun("ftorf", 100_000, 200_000, device)
    got = {}
    for r, mod, attr, name in ((run, dense, "composite_backward", "dense_backward"),
                               (run.restart(flat=True), flat,
                                "composite_backward_flat", "flat_backward")):
        calls = cs.capture_calls(r, 2101, 0, {"bwd": (mod, attr)})
        got[f"{name} at ftorf training shapes"] = (name, calls["bwd"])
    x, cam = cs.crowded_scene(device, 100_000, 20_000)
    cfg = RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                       max_per_tile=cs.MAX_PER_TILE_LIMIT, flat_stream=True)
    with torch.no_grad():
        fi = composite_inputs(x["means3d"], x["scales"], x["rotations"],
                              x["opacities"], x["shs"], x["shs_p"], 0.1, 0.02,
                              x["means2d_ndc"], x["bg_map"], cam, cfg)
    fb = fi.binning
    out, _ = flat.composite_forward_flat_cuda(fi.feat, fi.bg_tiles, fb.tile_start,
                                              fb.tile_count, fi.origins, cfg)
    g = cs.cotangent(np.random.default_rng(cs.SEED), cfg, device)
    got[f"flat_backward on the deep tile ({int(fb.tile_count.max())} instances)"] = (
        "flat_backward", (fi.feat, fi.bg_tiles, out, g, fb.tile_start,
                          fb.tile_count, fi.origins, cfg, False))
    return got


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    here = os.path.join(ROOT, "gftorf_tpu_torch", "csrc")
    variants = [(tag, here, patch) for tag, patch in VARIANTS.items()]
    if "--parent" in sys.argv:
        parent = sys.argv[sys.argv.index("--parent") + 1]
        variants.insert(0, ("parent", os.path.join(parent, "gftorf_tpu_torch",
                                                   "csrc"), []))
    t0 = time.perf_counter()
    libs = build_all(variants)
    print(f"[ab] built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    device = torch.device("cuda")
    tags = [v[0] for v in variants]
    turns = tags + tags[::-1]
    for label, (name, args) in inputs(device).items():
        work_split(label, name, args)
        calls = {tag: launcher(libs[tag, name], name, args) for tag in tags}
        ref = calls[REF]()
        errs = {tag: float((calls[tag]() - ref).abs().max()) for tag in tags}
        times = {tag: [] for tag in tags}
        for tag in turns:
            times[tag].append(cs.time_ms(calls[tag], 20))
        torch.cuda.synchronize()
        print(f"[ab] {label}: " + "; ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in times[tag])} ms "
            f"(max |diff| from {REF} {errs[tag]:.3g})" for tag in tags), flush=True)
        if name == "dense_backward":
            for tag in ("parent", REF):
                if tag not in tags:
                    continue
                each, first = tile_times(libs[tag, name], args)
                top = sorted(range(len(each)), key=lambda t: -each[t])[:3]
                print(f"[ab]   {tag}, each tile alone: max {max(each):.4f} ms, mean "
                      f"{sum(each) / len(each):.4f}, min {min(each):.4f}, sum / 132 "
                      f"{sum(each) / 132:.4f} (slowest tiles {top}, depths "
                      f"{[int(args[4][t]) for t in top]}); the first 132 tiles "
                      f"together {first:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
