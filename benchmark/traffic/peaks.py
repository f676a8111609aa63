"""Peaks of one H100 and the work of the compositing kernels, dense and
flat.

Copied from ``chip_smoke.py`` at commit 518578d (``PEAK_*``, ``OPS_*``,
``work_of`` and ``bound``), with the blend thresholds of
``gftorf_tpu_torch/render/composite.py`` at that commit. The work is
counted from a compositing call's inputs and outputs, never from the
kernels' launch design, so a redesigned kernel is held to the same work.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations the kernel does per (pixel, instance) pair it evaluates
# (offset, conic power, exp, clamps, tests) and per contributing pair
# (transmittance, 17 weighted channels, acc), plus the dd moments.
OPS_EVAL, OPS_CONTRIB, OPS_DD = 16, 41, 12
# The backward: the same evaluation, then per contributing pair d_alpha and
# the 24 gradient shares (79) and the adds of the per-instance sums (17);
# +12 with flow, +20 with dd.
OPS_CONTRIB_BWD, OPS_FLOW_BWD, OPS_DD_BWD = 96, 12, 20
# The blend thresholds (the reference's forward.cu:539-546).
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
# Pairs (pixel, lane) a step of ``flat_work_of`` holds at most, past one tile.
FLAT_PAIRS = 1 << 25


def _pairs(feat_tl, counts, origins, cfg):
    """(rows, evaluated) of a (T, L, 24) block of tiles with ``counts``
    instances each: rows up to each tile's last evaluated instance, and
    pairs evaluated up to each pixel's early exit, 16 tiles at a time."""
    T, L, _ = feat_tl.shape
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
    return rows, evaluated


def _totals(rows, evaluated, contributing, out_rows, ints, T, C, cfg,
            backward, has_flow):
    """Bytes and fp32 operations of a compositing call from its counts."""
    pix = cfg.tile_pixels
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


def work_of(feat_tl, counts, origins, cfg, contrib, backward=False,
            has_flow=False):
    """Bytes a dense compositing call must move and fp32 operations it must
    do on these inputs: rows up to each tile's last evaluated instance,
    pairs evaluated up to each pixel's early exit, contributing pairs. The
    forward reads the rows and bg and writes the (T, PIX, 32) block and the
    (T, L) counts; the backward also reads that block and the cotangent,
    and writes the (T, L, 24) gradient. ``cfg`` needs ``tile_pixels``,
    ``tile_w``, ``width``, ``height`` and ``need_dd``."""
    T, L, C = feat_tl.shape
    rows, evaluated = _pairs(feat_tl, counts, origins, cfg)
    return _totals(rows, evaluated, int(contrib.sum()), T * L, T * 3, T, C,
                   cfg, backward, has_flow)


def flat_work_of(feat_fl, tile_start, tile_count, origins, cfg, contrib,
                 backward=False, has_flow=False):
    """``work_of`` for a flat compositing call on the (K_pad, 24) stream,
    tile ``t``'s instances at rows ``tile_start[t]`` on, ``tile_count[t]``
    of them, every other row padding. The same pairs as the dense call on
    the same tiles; it reads ``tile_start`` beside the counts and origins,
    and writes the counts and the gradient rows of the stream's instances
    only, not of its padding. Tiles are cut from the stream a few at a time,
    so a deep tile takes no more memory than its own pairs."""
    T, C = tile_count.shape[0], feat_fl.shape[1]
    deepest = max(1, int(tile_count.max())) if T else 1
    step = max(1, min(16, FLAT_PAIRS // (cfg.tile_pixels * deepest)))
    lane = torch.arange(deepest, device=feat_fl.device)
    rows = evaluated = 0
    for t0 in range(0, T, step):
        sl = slice(t0, min(T, t0 + step))
        present = lane < tile_count[sl, None]
        slot = torch.where(present, tile_start[sl, None].long() + lane, 0)
        r, e = _pairs(feat_fl[slot], tile_count[sl], origins[sl], cfg)
        rows += r
        evaluated += e
    instances = int(tile_count.sum())
    return _totals(rows, evaluated, int(contrib.sum()), instances, T * 4, T,
                   C, cfg, backward, has_flow)


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the bytes over the
    peak bandwidth and the operations over the peak fp32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)


def deform_gemm_ops(hidden_inputs, width: int, head_outputs, rows: int,
                    backward: bool) -> int:
    """fp32 operations of the deform MLP's GEMMs over ``rows`` queried rows:
    2 * rows * in * out a layer forward (the hidden layers of
    ``hidden_inputs`` widths and the heads of ``head_outputs`` widths). The
    backward adds the weight gradients of every layer and the input
    gradients of every layer but the first, whose input (the embedded
    position and time) takes no gradient."""
    per_row = sum(i * width for i in hidden_inputs) + sum(
        width * o for o in head_outputs)
    fwd = 2 * rows * per_row
    if not backward:
        return fwd
    return fwd + fwd + (fwd - 2 * rows * hidden_inputs[0] * width)
