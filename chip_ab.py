#!/usr/bin/env python3
"""Times builds of one pair of compositing kernels against each other on
one card, in one process, on the same inputs.

    python3 chip_ab.py --pair forward|backward [--parent DIR]

``--pair forward`` builds csrc/dense_forward.cu and csrc/flat_forward.cu,
``--pair backward`` csrc/dense_backward.cu and csrc/flat_backward.cu: each
pair of this checkout as it is ("final") and once for each entry of the
pair's VARIANTS, a copy of csrc/ patched to undo one design choice or to
make one that was measured and dropped; with
``--parent``, also the same two sources of another checkout (DIR is its
root; its C entries must take the same arguments). Inputs: the blocks that
one ftorf training step (iteration 2101, an integration frame, flow on)
hands the dense and the flat kernel of the pair, at full width
(chip_smoke.py's TrainRun), and the flat stream of chip_smoke.py's
deep-tile scene. For each input it prints what the warps meet there
(``work_split``), then each build's time (20 launches, CUDA events, every
build once forwards and once backwards through the list) and the largest
difference of each output from the reference build's (the parent's with
``--parent``, else the final one's; 0 is bitwise equal): ``out`` and
``contrib`` for a forward, ``dfeat`` for a backward. For the dense input
it also prints each tile's time alone. Exits 1 if the final build differs
from the parent's by any bit. Needs a CUDA card and nvcc; prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADER = "composite_tile.cuh"
NAMES = {"forward": ("dense_forward", "flat_forward"),
         "backward": ("dense_backward", "flat_backward")}
# Pointer arguments of each C entry (then 8 ints and the stream).
POINTERS = {"dense_forward": 6, "flat_forward": 7, "dense_backward": 7,
            "flat_backward": 8}

# Patches that undo one design choice each, or make one that was dropped:
# (old, new) text replacements in composite_tile.cuh, or (file, old, new)
# in another file of csrc/.
# -- forward
NO_CULL = [("lane < m && !culled(box[s0 + lane], rect)", "lane < m")]
# All threads copy each batch and meet at a barrier before its boxes.
SYNC_LOAD = [
    ("    if (count > 0) bulk_load(sm.feat[0], tile_feat, min(BATCH, count), "
     "&sm.full[0]);\n  }\n  PixelBlend", "  }\n  PixelBlend"),
    ("    mbar_wait(&sm.full[k & 1], (k >> 1) & 1);\n    float4* box",
     "    for (int i = pid; i < n * FEAT; i += pix)\n"
     "      sm.feat[k & 1][i] = tile_feat[(size_t)base * FEAT + i];\n"
     "    __syncthreads();\n    float4* box"),
    ("    if (pid == 0 && base + BATCH < count)\n      bulk_load(",
     "    if (false)\n      bulk_load("),
]
# One shared integer atomicAdd per live row with a hit, in place of the
# per-warp count slots added at the batch boundary.
ROW_ATOMICS = [
    ("        if (lane == j) cnt = __popc(ballot);",
     "        if (lane == 0 && ballot)\n"
     "          atomicAdd(&sm.hits[k & 1][0][s0 + j], (int)__popc(ballot));"),
    ("      if (lane < m) hits[s0 + lane] = (int)cnt;  // 0 for the rows it skips\n", ""),
    ("store_counts(const int (&hits)", "store_counts(int (&hits)"),
    ("    for (int w = 0; w < nwarps; ++w) sum += hits[w][i];\n",
     "    sum = hits[0][i];\n    hits[0][i] = 0;\n"),
    ("  PixelBlend<NEED_DD, NEED_DIST> px(p);\n  __syncthreads();",
     "  PixelBlend<NEED_DD, NEED_DIST> px(p);\n"
     "  for (int i = pid; i < 2 * BATCH; i += pix) sm.hits[i / BATCH][0][i % BATCH] = 0;\n"
     "  __syncthreads();"),
]
# The next live row's sample (which does not depend on T) evaluated
# before this row's blend, to hide the expf latency.
LOOKAHEAD = [(
    """      for (; live != 0u; live &= live - 1u) {
        const int j = __ffs(live) - 1;
        const float* g = rows + (s0 + j) * FEAT;
        const bool hit = px.blend(px.sample(g), g);
        const unsigned ballot = __ballot_sync(FULL, hit);
        if (lane == j) cnt = __popc(ballot);
      }
""",
    """      if (live != 0u) {
        int j = __ffs(live) - 1;
        live &= live - 1u;
        Sample s = px.sample(rows + (s0 + j) * FEAT);
        for (;;) {
          const int jn = __ffs(live) - 1;
          live &= live - 1u;
          Sample sn;
          if (jn >= 0) sn = px.sample(rows + (s0 + jn) * FEAT);
          const bool hit = px.blend(s, rows + (s0 + j) * FEAT);
          const unsigned ballot = __ballot_sync(FULL, hit);
          if (lane == j) cnt = __popc(ballot);
          if (jn < 0) break;
          j = jn;
          s = sn;
        }
      }
""")]
# Warps hold 32 consecutive pixels (16x2 rows at tile_w 16, 32x1 at 32),
# as in the backward, in place of 8x4 blocks.
ROW_RECTS = [("warp_cull.cuh",
              "  return tile_w % 8 == 0 && pix % tile_w == 0 && (pix / tile_w) % 4 == 0;",
              "  return false;")]
# Blocks take tiles deepest first (ties by index), each block ranking
# every tile's count.
_ORDER_FN = """// Blocks take tiles deepest first (ties by index).
__device__ __forceinline__ int deepest_first(const int* counts, int* slot) {
  const int T = gridDim.x;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int c = counts[t];
    int rank = 0;
    for (int u = 0; u < T; ++u) {
      const int cu = counts[u];
      rank += (cu > c) || (cu == c && u < t);
    }
    if (rank == (int)blockIdx.x) *slot = t;
  }
  __syncthreads();
  return *slot;
}

"""
_AT = "// Rows [0, n) of a walked batch"
DEEPEST_FIRST = [
    (_AT, _ORDER_FN + _AT),
    ("dense_forward.cu", "  const int t = blockIdx.x;\n  const int i",
     "  __shared__ int s_tile;\n  const int t = deepest_first(counts, &s_tile);\n"
     "  const int i"),
    ("flat_forward.cu", "  const int t = blockIdx.x;\n  int start",
     "  __shared__ int s_tile;\n  const int t = deepest_first(tile_count, &s_tile);\n"
     "  int start")]
# The blend's 18 columns read as five 16-byte loads.
VEC_LOADS = [("""    const float w = alpha * T;
    const float wp = w * T;
#pragma unroll
    for (int k = 0; k < 3; ++k) color[k] += w * g[7 + k];
    depth += w * g[10];
#pragma unroll
    for (int k = 0; k < 7; ++k) phasor[k] += wp * g[11 + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) flow[k] += w * g[18 + k];
    if (NEED_DD) {
      const float z = g[6];""", """    const float w = alpha * T;
    const float wp = w * T;
    float r[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 v = reinterpret_cast<const float4*>(g + 4)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) color[k] += w * r[3 + k];
    depth += w * r[6];
#pragma unroll
    for (int k = 0; k < 7; ++k) phasor[k] += wp * r[7 + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) flow[k] += w * r[14 + k];
    if (NEED_DD) {
      const float z = r[2];""")]
_BOUNDS = "__launch_bounds__(MAX_PIX, MAX_PIX <= 512 ? FWD_MIN_BLOCKS : 1)"
OLD_BOUNDS = [(f"{name}.cu", _BOUNDS, "__launch_bounds__(1024)")
              for name in NAMES["forward"]]
ONE_BLOCK = [("constexpr int FWD_MIN_BLOCKS = 2;", "constexpr int FWD_MIN_BLOCKS = 1;")]
# -- backward
BWD_NO_CULL = [("lane < m && !culled(sm.box[s0 + lane], rect)", "lane < m")]
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
# pair -> tag -> patch
VARIANTS = {
    "forward": {
        "final": [],
        "row_rects": ROW_RECTS,
        "no_cull": NO_CULL,
        "sync_load": SYNC_LOAD,
        "row_atomics": ROW_ATOMICS,
        "lookahead": LOOKAHEAD,
        "old_bounds": OLD_BOUNDS,
        "one_block": ONE_BLOCK,
        "deepest_first": DEEPEST_FIRST,
        "vec_loads": VEC_LOADS,
    },
    "backward": {
        "final": [],
        "one_row": ONE_ROW,
        "ieee_div": IEEE_DIV,
        "sub16": SUB16,
        "no_cull": BWD_NO_CULL,
        "two_blocks": TWO_BLOCKS,
        # The backward's plan before these measurements, as near as a
        # patch gets: 16-row sub-batches, two blocks an SM, four IEEE
        # divisions, one row at a time (the step stays without branches).
        "planned": TWO_BLOCKS + IEEE_DIV + ONE_ROW,
    },
}


def patched(tag, csrc, patch):
    """A copy of ``csrc`` under build/ab/<tag>/ with each text replacement
    of ``patch`` made (each old text must occur once in its file)."""
    import shutil

    dst = os.path.join(ROOT, "build", "ab", tag)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for edit in patch:
        name, old, new = edit if len(edit) == 3 else (HEADER, *edit)
        path = os.path.join(dst, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"patch {tag}: {old!r} does not occur once in {name}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def build_all(variants, names):
    """(tag, csrc dir, patch) -> {(tag, name): C entry} for each of
    ``names``, one nvcc per library, all at once."""
    from gftorf_tpu_torch.render.kernels.build import NVCC_FLAGS, _nvcc

    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for tag, csrc, patch in variants:
        if patch:
            csrc = patched(tag, csrc, patch)
        for name in names:
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
        fn = getattr(ctypes.CDLL(lib), f"gftorf_{key[1]}")
        fn.argtypes = ([ctypes.c_void_p] * POINTERS[key[1]] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def launcher(fn, name, args):
    """A call of C entry ``fn`` on wrapper-style ``args``; returns the
    kernel's outputs: (out, contrib) for a forward, (dfeat,) for a
    backward."""
    import torch

    from gftorf_tpu_torch.render.kernels.dense import aligned16

    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    if name == "dense_forward":
        feat, bg, counts, origins, cfg = args
        feat = aligned16(feat)
        T, L, _ = feat.shape

        def call():
            out = torch.empty((T, cfg.tile_pixels, 32), device=feat.device)
            contrib = torch.empty((T, L), device=feat.device)
            check(fn(feat.data_ptr(), bg.data_ptr(), counts.data_ptr(),
                     origins.data_ptr(), out.data_ptr(), contrib.data_ptr(), T, L,
                     cfg.tile_pixels, cfg.tile_w, cfg.width, cfg.height,
                     int(cfg.need_dd), int(cfg.need_distribution), stream))
            return out, contrib
        return call
    if name == "flat_forward":
        feat, bg, start, count, origins, cfg = args
        feat = aligned16(feat)
        K, T = feat.shape[0], bg.shape[0]

        def call():
            out = torch.empty((T, cfg.tile_pixels, 32), device=feat.device)
            contrib = torch.zeros((K,), device=feat.device)
            check(fn(feat.data_ptr(), bg.data_ptr(), start.data_ptr(),
                     count.data_ptr(), origins.data_ptr(), out.data_ptr(),
                     contrib.data_ptr(), T, K, cfg.tile_pixels, cfg.tile_w,
                     cfg.width, cfg.height, int(cfg.need_dd),
                     int(cfg.need_distribution), stream))
            return out, contrib
        return call
    if name == "dense_backward":
        feat, bg, out, g, counts, origins, cfg, flow = args
        feat = aligned16(feat)
        T, L, _ = feat.shape

        def call():
            dfeat = torch.empty_like(feat)
            check(fn(feat.data_ptr(), bg.data_ptr(), out.data_ptr(), g.data_ptr(),
                     counts.data_ptr(), origins.data_ptr(), dfeat.data_ptr(), T, L,
                     cfg.tile_pixels, cfg.tile_w, cfg.width, cfg.height,
                     int(cfg.need_dd), int(flow), stream))
            return (dfeat,)
        return call
    feat, bg, out, g, start, count, origins, cfg, flow = args
    feat = aligned16(feat)
    K, T = feat.shape[0], bg.shape[0]

    def call():
        dfeat = torch.zeros_like(feat)
        check(fn(feat.data_ptr(), bg.data_ptr(), out.data_ptr(), g.data_ptr(),
                 start.data_ptr(), count.data_ptr(), origins.data_ptr(),
                 dfeat.data_ptr(), T, K, cfg.tile_pixels, cfg.tile_w, cfg.width,
                 cfg.height, int(cfg.need_dd), int(flow), stream))
        return (dfeat,)
    return call


OUTPUTS = {"forward": ("out", "contrib"), "backward": ("dfeat",)}


def tiles_of(name, args):
    """The tile blocks a kernel call composites: (feat (T, L, 24) with
    zeros past each count, counts, origins, config); a flat stream cut
    into tiles."""
    import torch

    from gftorf_tpu_torch.render.kernels import flat

    if name == "dense_forward":
        feat, _, counts, origins, cfg = args
    elif name == "flat_forward":
        feat, _, start, counts, origins, cfg = args
    elif name == "dense_backward":
        feat, _, _, _, counts, origins, cfg, _ = args
    else:
        feat, _, _, _, start, counts, origins, cfg, _ = args
    if name.startswith("flat"):
        slot, present = flat.stream_slots(start, counts)
        feat = torch.where(present[..., None], feat[slot], 0.0)
    return feat, counts, origins, cfg


def sliced(name, args, sl):
    """A dense kernel's wrapper-style ``args`` cut to the tiles ``sl``."""
    if name == "dense_forward":
        feat, bg, counts, origins, cfg = args
        return feat[sl], bg[sl], counts[sl], origins[sl], cfg
    feat, bg, out, g, counts, origins, cfg, flow = args
    return feat[sl], bg[sl], out[sl], g[sl], counts[sl], origins[sl], cfg, flow


def tile_times(fn, name, args):
    """A dense kernel of ``fn`` on each tile of ``args`` alone (ms, CUDA
    events, 5 launches each), and on the first 132 tiles (one per SM of an
    H100)."""
    import chip_smoke as cs

    T = args[0].shape[0]
    each = [cs.time_ms(launcher(fn, name, sliced(name, args, slice(t, t + 1))), 5)
            for t in range(T)]
    return each, cs.time_ms(launcher(fn, name, sliced(name, args,
                                                      slice(0, min(T, 132)))), 20)


def work_split(label, name, args, chunk=4):
    """What the kernel's warps meet on these inputs, from the plain
    version's arithmetic: (row, warp) pairs up to each tile's count, those
    the cull skips, those after every pixel of the warp stopped, those the
    warp walks, those with a contributing pixel, and how many of the
    warp's 32 lanes contribute there."""
    import torch

    from gftorf_tpu_torch.render.composite import ALPHA_EPS, ALPHA_MAX, T_STOP
    from gftorf_tpu_torch.render.kernels import dense

    feat, counts, origins, cfg = tiles_of(name, args)
    T, L, _ = feat.shape
    pix, tw = cfg.tile_pixels, cfg.tile_w
    W = pix // 32
    blocks = name.endswith("forward")  # the forward's map of threads to pixels
    rects = dense.warp_rects(origins, tw, pix, blocks)
    pid = dense.warp_pixels(tw, pix, blocks, feat.device)  # each thread's pixel
    lane = torch.arange(L, device=feat.device)
    tot = {k: 0 for k in ("pairs", "culled", "done", "walked", "hit", "lanes")}
    crit = {k: [] for k in ("total", "row", "sub16", "sub64", "batch", "free")}
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
        # one warp between barriers every row, every 16, 64 or 256 rows, or
        # none.
        wk = walked.int()
        Lp = -(-L // 256) * 256
        wk = torch.nn.functional.pad(wk, (0, 0, 0, Lp - L))
        crit["total"] += wk.sum((1, 2)).tolist()
        crit["row"] += wk.amax(2).sum(1).tolist()
        for k, m in (("sub16", 16), ("sub64", 64), ("batch", 256)):
            crit[k] += wk.reshape(c, Lp // m, m, W).sum(2).amax(2).sum(1).tolist()
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
        + " (row, sub16, sub64, batch, free: one warp's longest chain with a "
        "barrier every row, 16, 64 or 256 rows, or none)", flush=True)


def inputs(device, pair):
    """{label: (kernel name, wrapper args)} at the ftorf training shapes
    (dense and flat) and on the deep-tile scene (flat), for ``pair``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.render.rasterize import composite_inputs
    from gftorf_tpu_torch.render.settings import RasterConfig

    dense_name, flat_name = NAMES[pair]
    attr = {"forward": ("composite_forward", "composite_forward_flat"),
            "backward": ("composite_backward", "composite_backward_flat")}[pair]
    run = cs.TrainRun("ftorf", 100_000, 200_000, device)
    got = {}
    for r, mod, a, name in ((run, dense, attr[0], dense_name),
                            (run.restart(flat=True), flat, attr[1], flat_name)):
        calls = cs.capture_calls(r, 2101, 0, {"call": (mod, a)})
        got[f"{name} at ftorf training shapes"] = (name, calls["call"])
    x, cam = cs.crowded_scene(device, 100_000, 20_000)
    cfg = RasterConfig(height=240, width=320, tile_h=16, tile_w=32,
                       max_per_tile=cs.MAX_PER_TILE_LIMIT, flat_stream=True)
    with torch.no_grad():
        fi = composite_inputs(x["means3d"], x["scales"], x["rotations"],
                              x["opacities"], x["shs"], x["shs_p"], 0.1, 0.02,
                              x["means2d_ndc"], x["bg_map"], cam, cfg)
    fb = fi.binning
    label = f"{flat_name} on the deep tile ({int(fb.tile_count.max())} instances)"
    fwd = (fi.feat, fi.bg_tiles, fb.tile_start, fb.tile_count, fi.origins, cfg)
    if pair == "forward":
        got[label] = (flat_name, fwd)
    else:
        out, _ = flat.composite_forward_flat_cuda(*fwd)
        g = cs.cotangent(np.random.default_rng(cs.SEED), cfg, device)
        got[label] = (flat_name, (fi.feat, fi.bg_tiles, out, g, fb.tile_start,
                                  fb.tile_count, fi.origins, cfg, False))
    return got


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=("forward", "backward"), required=True)
    ap.add_argument("--parent", help="root of another checkout to time against")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    here = os.path.join(ROOT, "gftorf_tpu_torch", "csrc")
    variants = [(tag, here, patch) for tag, patch in VARIANTS[opt.pair].items()]
    if opt.parent:
        variants.insert(0, ("parent", os.path.join(opt.parent, "gftorf_tpu_torch",
                                                   "csrc"), []))
    ref = "parent" if opt.parent else "final"
    t0 = time.perf_counter()
    libs = build_all(variants, NAMES[opt.pair])
    print(f"[ab] {opt.pair}: built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda")
    tags = [v[0] for v in variants]
    turns = tags + tags[::-1]
    differs = []
    for label, (name, args) in inputs(device, opt.pair).items():
        work_split(label, name, args)
        calls = {tag: launcher(libs[tag, name], name, args) for tag in tags}
        want = calls[ref]()
        errs = {}
        for tag in tags:
            got = calls[tag]()
            errs[tag] = [float((a - b).abs().max()) if a.numel() else 0.0
                         for a, b in zip(got, want)]
            if tag == "final" and not all(torch.equal(a, b) for a, b in zip(got, want)):
                differs.append(label)
        times = {tag: [] for tag in tags}
        for tag in turns:
            times[tag].append(cs.time_ms(calls[tag], 20))
        torch.cuda.synchronize()
        print(f"[ab] {label}: " + "; ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in times[tag])} ms (max |diff| "
            f"from {ref}: " + ", ".join(
                f"{o} {e:.3g}" for o, e in zip(OUTPUTS[opt.pair], errs[tag])) + ")"
            for tag in tags), flush=True)
        if name.startswith("dense"):
            for tag in ("parent", "final"):
                if tag not in tags:
                    continue
                each, first = tile_times(libs[tag, name], name, args)
                counts = tiles_of(name, args)[1]
                top = sorted(range(len(each)), key=lambda t: -each[t])[:3]
                print(f"[ab]   {tag}, each tile alone: max {max(each):.4f} ms, mean "
                      f"{sum(each) / len(each):.4f}, min {min(each):.4f}, sum / 132 "
                      f"{sum(each) / 132:.4f} (slowest tiles {top}, depths "
                      f"{[int(counts[t]) for t in top]}); the first 132 tiles "
                      f"together {first:.4f} ms", flush=True)
    if differs and opt.parent:
        print(f"[ab] the final build differs from the parent's on: {differs}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
