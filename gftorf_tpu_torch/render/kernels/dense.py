"""Dense-layout tile compositor: the Hopper kernels and their plain versions.

Counterpart of ``gftorf_tpu/render/pallas_composite.py``. The two TPU
kernels become CUDA C++ kernels for sm_90a bound with ctypes (see the
notes in those files for their design and bound):

 - ``_forward_kernel`` (``composite_forward_pallas``) ->
   ``csrc/dense_forward.cu``, wrapper ``composite_forward_cuda``;
 - ``_backward_kernel`` (``composite_backward_pallas``) ->
   ``csrc/dense_backward.cu``, wrapper ``composite_backward_cuda``.

The TPU's third kernel of this layout, ``render/vmem_check.py::
try_compile_bwd`` (a compile of the backward that checks it fits scoped
VMEM), becomes ``check_backward_fits``: the card's occupancy query for
each instance of the backward that a step launches, beside its plain
version ``blocks_per_sm_plain``.

``composite_forward`` and ``composite_backward`` dispatch on the tensors'
device: a CUDA tensor goes through the kernel (or the call raises), a CPU
tensor through ``composite_forward_plain`` / ``composite_backward_plain``,
the same functions in vectorised torch. ``DenseComposite`` is the
``torch.autograd.Function`` in place of the JAX package's custom VJP
(``_make_pallas_vjp`` / ``_run_pallas_vjp``). ``warp_cull_plain``,
``warp_pixels`` and ``warp_rects`` are the kernels' per-warp cull and
their warps' pixels (``csrc/warp_cull.cuh``) in torch, for the tests and
chip_smoke.py; ``warp_cull_mask_cuda`` runs the kernels' own predicate on
the card.

Packed feature columns (pack_gaussian_features):
  0:2 mean2d | 2:5 conic | 5 opacity | 6 dist_ndc
  7:10 rgb | 10 dist | 11:18 phasor | 18:24 flow
Output block (T, PIX, 32):
  0:3 color(+bg), 3 depth, 4:11 phasor(+bg), 11 acc, 12 dd,
  13 final_T, 14:17 first-sample (alpha, dist, amp),
  17 A_tot, 18 WZ_tot, 19 WZ2_tot, 20:26 flow (no bg), 26:32 zero
(12/18/19 are zeros when config.need_dd is off, 14:17 when
config.need_distribution is off.)

Never differentiate ``composite_forward_plain`` with autograd directly:
its flow columns are computed with weights that are not detached, so the
flow gradient would leak into the geometry, which the JAX package forbids
(pallas_composite.py:551-553). Gradients go through ``DenseComposite``,
whose backward is ``composite_backward``; a direct call of the CUDA
forward wrapper with inputs that require grad is refused.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from gftorf_tpu_torch.render.composite import ALPHA_EPS, ALPHA_MAX, T_STOP
from gftorf_tpu_torch.render.settings import RasterConfig
from gftorf_tpu_torch.utils import debug_nans

FEAT_COLS = 24
BG_COLS = 12
OUT_COLS = 32


class TileOutputs(NamedTuple):
    color: torch.Tensor  # (T, PIX, 3)
    phasor: torch.Tensor  # (T, PIX, 7)
    depth: torch.Tensor  # (T, PIX)
    acc: torch.Tensor  # (T, PIX)
    dd: torch.Tensor  # (T, PIX)
    distribution: torch.Tensor  # (T, PIX, 3)
    contrib_pixels: torch.Tensor  # (T, L) pixels touched per instance
    flow: torch.Tensor  # (T, PIX, 6)


def pack_gaussian_features(pre, flow=None) -> torch.Tensor:
    """PreprocessOutputs -> one (P, 24) feature matrix, so the tile layout
    needs a single instance gather. ``flow`` is an optional (P, 6) block
    of fused scene-flow channels."""
    P = pre.mean2d.shape[0]
    if flow is None:
        flow = torch.zeros((P, 6), dtype=torch.float32, device=pre.mean2d.device)
    return torch.cat(
        [
            pre.mean2d,  # 0:2
            pre.conic,  # 2:5
            pre.opacity[:, None],  # 5
            pre.dist_ndc[:, None],  # 6
            pre.rgb,  # 7:10
            pre.dist[:, None],  # 10
            pre.phasor,  # 11:18
            flow,  # 18:24
        ],
        dim=-1,
    )


def _bg_to_tiles(bg_map: torch.Tensor, T: int, config: RasterConfig) -> torch.Tensor:
    """(7, H, W) background -> (T, PIX, 12) tile blocks laid out like the
    kernel's output: bg color at 0:3, the 7 phasor channels at 4:11."""
    th, tw = config.tile_h, config.tile_w
    pix = th * tw
    bg_h, bg_w = bg_map.shape[1], bg_map.shape[2]
    gw_l = -(-bg_w // tw)
    gh_l = T // gw_l
    bg_p = torch.nn.functional.pad(
        bg_map, (0, gw_l * tw - bg_w, 0, gh_l * th - bg_h)
    )
    bgt = (
        bg_p.reshape(7, gh_l, th, gw_l, tw)
        .permute(1, 3, 2, 4, 0)
        .reshape(T, pix, 7)
    )
    zero = bgt.new_zeros((T, pix, 1))
    return torch.cat([bgt[..., :3], zero, bgt, zero], dim=-1).contiguous()


def _default_origins(T: int, config: RasterConfig, device) -> torch.Tensor:
    """(T, 2) int32 pixel coordinates (x, y) of each tile's corner."""
    gw = config.grid_w
    tid = torch.arange(T, dtype=torch.int32, device=device)
    return torch.stack(
        [(tid % gw) * config.tile_w, (tid // gw) * config.tile_h], -1
    ).to(torch.int32)


def unpack_outputs(out: torch.Tensor, contrib: torch.Tensor) -> TileOutputs:
    """Kernel output block -> TileOutputs."""
    return TileOutputs(
        color=out[..., 0:3],
        phasor=out[..., 4:11],
        depth=out[..., 3],
        acc=out[..., 11],
        dd=out[..., 12],
        distribution=out[..., 14:17],
        contrib_pixels=contrib,
        flow=out[..., 20:26],
    )


def check_tensors(expect, dev) -> None:
    """Raise unless each ``name: (tensor, dtype, shape)`` of ``expect`` is
    a contiguous tensor of that dtype and shape on ``dev``: what a CUDA
    wrapper checks before it hands pointers to its kernel."""
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def composite_forward(feat_tl, bg_tiles, counts, origins, config: RasterConfig):
    """Composite the packed (T, L, 24) block; returns (out (T, PIX, 32),
    contrib (T, L)). CUDA tensors run the Hopper kernel, CPU tensors the
    plain version."""
    if feat_tl.device.type == "cuda":
        return composite_forward_cuda(feat_tl, bg_tiles, counts, origins, config)
    if feat_tl.device.type == "cpu":
        return composite_forward_plain(feat_tl, bg_tiles, counts, origins, config)
    raise ValueError(f"no compositor for device {feat_tl.device}")


def composite_forward_plain(feat_tl, bg_tiles, counts, origins,
                            config: RasterConfig):
    """The kernel's function in vectorised torch, in the prefix form of
    pallas_composite.py:262-438: transmittance as an exclusive cumprod over
    the lanes, the early-exit latch as ``t_incl >= T_STOP`` (t_incl is
    monotone), and the frozen final T as the min over contributing t_incl.
    Chunked over ``config.tile_chunk`` tiles to bound the (tiles, PIX, L)
    temporaries."""
    T, L, _ = feat_tl.shape
    tw = config.tile_w
    pix = config.tile_pixels
    dev = feat_tl.device
    pid = torch.arange(pix, device=dev)
    dx_pix = (pid % tw).to(torch.float32)
    dy_pix = (pid // tw).to(torch.float32)
    lane = torch.arange(L, device=dev)
    out = torch.zeros((T, pix, OUT_COLS), dtype=torch.float32, device=dev)
    contrib = torch.zeros((T, L), dtype=torch.float32, device=dev)
    step = max(1, config.tile_chunk)
    for t0 in range(0, T, step):
        sl = slice(t0, min(T, t0 + step))
        present = lane < counts[sl, None]  # (c, L)
        # Lanes at or past the count are garbage rows of the gather.
        f = torch.where(present[..., None], feat_tl[sl], 0.0)  # (c, L, 24)
        px = origins[sl, 0, None].to(torch.float32) + dx_pix  # (c, PIX)
        py = origins[sl, 1, None].to(torch.float32) + dy_pix
        inside = (px < config.width) & (py < config.height)

        ddx = f[:, None, :, 0] - px[..., None]  # (c, PIX, L)
        ddy = f[:, None, :, 1] - py[..., None]
        con_a = f[:, None, :, 2]
        con_b = f[:, None, :, 3]
        con_c = f[:, None, :, 4]
        power = -0.5 * (con_a * ddx * ddx + con_c * ddy * ddy) - con_b * ddx * ddy
        alpha = torch.clamp(
            f[:, None, :, 5] * torch.exp(torch.clamp(power, max=0.0)),
            max=ALPHA_MAX,
        )
        valid = ((power <= 0.0) & (alpha >= ALPHA_EPS) & inside[..., None]
                 & present[:, None, :])
        q = 1.0 - torch.where(valid, alpha, 0.0)
        cp = torch.cumprod(q, dim=-1)
        t_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        t_incl = t_excl * q
        contribute = valid & (t_incl >= T_STOP)
        w = torch.where(contribute, alpha * t_excl, 0.0)
        w_p = w * t_excl

        sums = w @ f[..., 7:24]  # (c, PIX, 17): rgb, dist, phasor, flow
        sums_p = w_p @ f[..., 11:18]  # (c, PIX, 7)
        acc = w.sum(-1)
        t_frozen = torch.where(contribute, t_incl, 1.0).amin(-1)  # (c, PIX)
        bg = bg_tiles[sl]
        o = out[sl]
        o[..., 0:3] = sums[..., 0:3] + t_frozen[..., None] * bg[..., 0:3]
        o[..., 3] = sums[..., 3]
        o[..., 4:11] = sums_p + t_frozen[..., None] * bg[..., 4:11]
        o[..., 11] = acc
        o[..., 13] = t_frozen
        o[..., 17] = acc
        o[..., 20:26] = sums[..., 11:17]

        if config.need_dd:
            z = f[:, None, :, 6]
            wz = w * z
            wz2 = wz * z
            a_ex = torch.cumsum(w, -1) - w
            wz_ex = torch.cumsum(wz, -1) - wz
            wz2_ex = torch.cumsum(wz2, -1) - wz2
            o[..., 12] = (w * (z * z) * a_ex - 2.0 * wz * wz_ex
                          + w * wz2_ex).sum(-1)
            o[..., 18] = wz.sum(-1)
            o[..., 19] = wz2.sum(-1)

        if config.need_distribution:
            has = contribute.any(-1, keepdim=True)
            first = contribute.to(torch.uint8).argmax(-1, keepdim=True)
            stats = torch.cat(
                [
                    torch.gather(alpha, -1, first),
                    torch.gather(f[..., 10], 1, first[..., 0])[..., None],
                    torch.gather(f[..., 13], 1, first[..., 0])[..., None],
                ],
                dim=-1,
            )
            o[..., 14:17] = torch.where(has, stats, 0.0)

        contrib[sl] = contribute.sum(1).to(torch.float32)
    return out, contrib


@functools.cache
def _lib() -> ctypes.CDLL:
    from gftorf_tpu_torch.render.kernels.build import library

    lib = library("dense_forward")
    fn = lib.gftorf_dense_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gftorf_dense_forward_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def composite_forward_cuda(feat_tl, bg_tiles, counts, origins,
                           config: RasterConfig):
    """Launch csrc/dense_forward.cu on the tensors' card; adds one to
    ``composite_forward_cuda.launches`` per launch."""
    T, L, C = feat_tl.shape
    pix = config.tile_pixels
    dev = feat_tl.device
    if torch.is_grad_enabled():
        for name, x in (("feat_tl", feat_tl), ("bg_tiles", bg_tiles)):
            if x.requires_grad:
                raise ValueError(
                    f"{name} requires grad: call DenseComposite.apply, whose "
                    "backward is the dense backward kernel"
                )
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if C != FEAT_COLS:
        raise ValueError(f"feat_tl has {C} columns, the kernel takes {FEAT_COLS}")
    if pix > 1024 or pix % 32 != 0:
        raise ValueError(f"tile_pixels={pix}: the kernel runs one thread per "
                         "pixel, so it must be a multiple of 32 up to 1024")
    expect = {
        "feat_tl": (feat_tl, torch.float32, (T, L, FEAT_COLS)),
        "bg_tiles": (bg_tiles, torch.float32, (T, pix, BG_COLS)),
        "counts": (counts, torch.int32, (T,)),
        "origins": (origins, torch.int32, (T, 2)),
    }
    check_tensors(expect, dev)
    feat_tl = aligned16(feat_tl)
    out = torch.empty((T, pix, OUT_COLS), dtype=torch.float32, device=dev)
    contrib = torch.empty((T, L), dtype=torch.float32, device=dev)
    if T == 0:
        return out, contrib
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.gftorf_dense_forward(
            feat_tl.data_ptr(), bg_tiles.data_ptr(), counts.data_ptr(),
            origins.data_ptr(), out.data_ptr(), contrib.data_ptr(),
            T, L, pix, config.tile_w, config.width, config.height,
            int(config.need_dd), int(config.need_distribution),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_forward kernel launch failed: cudaError {err}")
    composite_forward_cuda.launches += 1
    debug_nans.check_output("the dense_forward kernel", out, contrib)
    return out, contrib


composite_forward_cuda.launches = 0


def composite_backward(feat_tl, bg_tiles, out_res, g, counts, origins,
                       config: RasterConfig, has_flow: bool):
    """Gradient of the (T, PIX, 32) output block w.r.t. the packed
    (T, L, 24) block, given the forward's output ``out_res`` and the
    cotangent ``g`` (columns 13:20 and 26:32 of g are ignored). CUDA
    tensors run the Hopper kernel, CPU tensors the plain version."""
    if feat_tl.device.type == "cuda":
        return composite_backward_cuda(feat_tl, bg_tiles, out_res, g, counts,
                                       origins, config, has_flow)
    if feat_tl.device.type == "cpu":
        return composite_backward_plain(feat_tl, bg_tiles, out_res, g, counts,
                                        origins, config, has_flow)
    raise ValueError(f"no compositor for device {feat_tl.device}")


def composite_backward_plain(feat_tl, bg_tiles, out_res, g, counts, origins,
                             config: RasterConfig, has_flow: bool):
    """The backward kernel's function in vectorised torch: the prefix form
    of pallas_composite.py:441-599 over the whole tile depth at once.
    Suffix sums are totals (from the forward residual columns 13, 17, 18,
    19) minus inclusive cumsums over the lanes; d_alpha, then per-instance
    sums over the tile's pixels. Chunked over ``config.tile_chunk`` tiles
    like ``composite_forward_plain``."""
    T, L, _ = feat_tl.shape
    tw = config.tile_w
    pix = config.tile_pixels
    dev = feat_tl.device
    pid = torch.arange(pix, device=dev)
    dx_pix = (pid % tw).to(torch.float32)
    dy_pix = (pid // tw).to(torch.float32)
    lane = torch.arange(L, device=dev)
    dfeat = torch.zeros((T, L, FEAT_COLS), dtype=torch.float32, device=dev)
    step = max(1, config.tile_chunk)
    for t0 in range(0, T, step):
        sl = slice(t0, min(T, t0 + step))
        present = lane < counts[sl, None]  # (c, L)
        f = torch.where(present[..., None], feat_tl[sl], 0.0)  # (c, L, 24)
        px = origins[sl, 0, None].to(torch.float32) + dx_pix  # (c, PIX)
        py = origins[sl, 1, None].to(torch.float32) + dy_pix
        inside = (px < config.width) & (py < config.height)
        out, gg, bg = out_res[sl], g[sl], bg_tiles[sl]

        # Per-pixel totals (pallas_composite.py:466-486), (c, PIX, 1).
        t_final = out[..., 13:14]
        a_tot = out[..., 17:18]
        g_acc = gg[..., 11:12]
        accum_f = torch.cat(
            [out[..., 0:3] - t_final * bg[..., 0:3], out[..., 3:4]], dim=-1)
        accum_p = out[..., 4:11] - t_final * bg[..., 4:11]
        e_tot = (gg[..., 0:4] * accum_f).sum(-1, keepdim=True) + g_acc * a_tot
        ep_tot = (gg[..., 4:11] * accum_p).sum(-1, keepdim=True)
        bg_dot = ((bg[..., 0:3] * gg[..., 0:3]).sum(-1, keepdim=True)
                  + (bg[..., 4:11] * gg[..., 4:11]).sum(-1, keepdim=True))

        # The forward's recompute (composite_forward_plain), (c, PIX, L).
        ddx = f[:, None, :, 0] - px[..., None]
        ddy = f[:, None, :, 1] - py[..., None]
        con_a = f[:, None, :, 2]
        con_b = f[:, None, :, 3]
        con_c = f[:, None, :, 4]
        power = -0.5 * (con_a * ddx * ddx + con_c * ddy * ddy) - con_b * ddx * ddy
        exp_p = torch.exp(torch.clamp(power, max=0.0))
        raw = f[:, None, :, 5] * exp_p
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        valid = ((power <= 0.0) & (alpha >= ALPHA_EPS) & inside[..., None]
                 & present[:, None, :])
        q = 1.0 - torch.where(valid, alpha, 0.0)
        cp = torch.cumprod(q, dim=-1)
        t_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        t_incl = t_excl * q
        contribute = valid & (t_incl >= T_STOP)
        w = torch.where(contribute, alpha * t_excl, 0.0)
        w_p = w * t_excl

        e = gg[..., 0:4] @ f[..., 7:11].transpose(1, 2) + g_acc  # (c, PIX, L)
        e_p = gg[..., 4:11] @ f[..., 11:18].transpose(1, 2)
        u_f_incl = torch.cumsum(w * e, dim=-1)
        u_p_incl = torch.cumsum(w_p * e_p, dim=-1)
        d_alpha = (t_excl * e - (e_tot - u_f_incl) / q
                   + t_excl * t_excl * e_p - 2.0 * (ep_tot - u_p_incl) / q
                   - t_final / q * bg_dot)
        d = dfeat[sl]
        if config.need_dd:
            wz_tot = out[..., 18:19]
            wz2_tot = out[..., 19:20]
            g_dd = gg[..., 12:13]
            u_dd_tot = g_dd * 2.0 * (a_tot * wz2_tot - wz_tot * wz_tot)
            z = f[:, None, :, 6]
            sym = z * z * a_tot - 2.0 * z * wz_tot + wz2_tot
            u_dd_incl = torch.cumsum(g_dd * w * sym, dim=-1)
            d_alpha = d_alpha + g_dd * t_excl * sym - (u_dd_tot - u_dd_incl) / q
            d[..., 6] = (g_dd * 2.0 * w * (z * a_tot - wz_tot)).sum(1)
        d_alpha = torch.where(contribute, d_alpha, 0.0)

        not_clamped = raw < ALPHA_MAX
        d_power = torch.where(not_clamped, d_alpha * alpha, 0.0)
        d[..., 5] = torch.where(not_clamped, d_alpha * exp_p, 0.0).sum(1)
        d[..., 0] = (d_power * -(con_a * ddx + con_b * ddy)).sum(1)
        d[..., 1] = (d_power * -(con_c * ddy + con_b * ddx)).sum(1)
        d[..., 2] = (-0.5 * ddx * ddx * d_power).sum(1)
        d[..., 3] = (-ddx * ddy * d_power).sum(1)
        d[..., 4] = (-0.5 * ddy * ddy * d_power).sum(1)
        d[..., 7:11] = w.transpose(1, 2) @ gg[..., 0:4]  # rgb, dist
        d[..., 11:18] = w_p.transpose(1, 2) @ gg[..., 4:11]  # phasor
        if has_flow:
            # Detached weights: the flow gradient has no d_alpha term
            # (pallas_composite.py:551-561).
            d[..., 18:24] = w.transpose(1, 2) @ gg[..., 20:26]
    return dfeat


# csrc/warp_cull.cuh's constants (its notes derive them).
CULL_GAMMA = 4e-6
CULL_DET_FLOOR = 1e-9
CULL_LEVEL_SLACK = 1e-5
CULL_REL_MARGIN = 1e-3
CULL_PIXEL_MARGIN = 0.5


def _f32_outward(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> float32 rounded towards -inf (``down``) or +inf, as
    ``__double2float_rd`` / ``__double2float_ru``."""
    f = x.to(torch.float32)
    if down:
        return torch.where(f.double() > x, torch.nextafter(f, f.new_tensor(-math.inf)), f)
    return torch.where(f.double() < x, torch.nextafter(f, f.new_tensor(math.inf)), f)


def warp_cull_boxes_plain(rows: torch.Tensor) -> torch.Tensor:
    """(n, 24) packed rows -> (n, 4) float32 cull boxes {x_lo, x_hi, y_lo,
    y_hi}: ``csrc/warp_cull.cuh::cull_box`` formula for formula (float64
    inside, rounded outwards). No pixel outside a row's box is valid."""
    g = rows[:, :6]
    mx, my, a, b, c, o = g.unbind(-1)
    da, db, dc = a.double(), b.double(), c.double()
    det = da * dc - db * db
    det_l = da * dc * ((1.0 - CULL_GAMMA) * (1.0 - CULL_GAMMA)) - db * db * (
        (1.0 + CULL_GAMMA) * (1.0 + CULL_GAMMA))
    # The order of cull_box's tests: never cull a non-finite or not
    # positive definite row; always cull a faint one; else the box, unless
    # det' is not clearly positive.
    unsure = ~torch.isfinite(g).all(-1) | ~(a > 0) | ~(det > 0)
    eps = torch.tensor(ALPHA_EPS, dtype=torch.float32)
    faint = ~unsure & (o < eps)
    keep = unsure | ~(det_l > CULL_DET_FLOOR * (da * dc))
    level = (2.0 * (torch.log(o.double() / float(eps)) + CULL_LEVEL_SLACK)
             * (1.0 + CULL_REL_MARGIN))
    hx = torch.sqrt(level * dc * (1.0 - CULL_GAMMA) / det_l) + CULL_PIXEL_MARGIN
    hy = torch.sqrt(level * da * (1.0 - CULL_GAMMA) / det_l) + CULL_PIXEL_MARGIN
    box = torch.stack([_f32_outward(mx.double() - hx, True),
                       _f32_outward(mx.double() + hx, False),
                       _f32_outward(my.double() - hy, True),
                       _f32_outward(my.double() + hy, False)], -1)
    inf = math.inf
    box = torch.where(keep[:, None], box.new_tensor([-inf, inf, -inf, inf]), box)
    return torch.where(faint[:, None], box.new_tensor([inf, -inf, inf, -inf]), box)


def warp_cull_plain(rows: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """(n, m) bool: row r is culled for pixel rectangle q (``rects`` (m, 4)
    float32 {x0, x1, y0, y1}, inclusive pixel coordinates). The plain
    version of the kernels' per-warp cull (csrc/warp_cull.cuh);
    used by the tests and chip_smoke.py, not by the compositor."""
    box = warp_cull_boxes_plain(rows)[:, None, :]
    r = rects[None, :, :]
    return ((box[..., 1] < r[..., 0]) | (box[..., 0] > r[..., 1])
            | (box[..., 3] < r[..., 2]) | (box[..., 2] > r[..., 3]))


def warp_pixels(tile_w: int, pix: int, blocks: bool = False,
                device=None) -> torch.Tensor:
    """(pix,) pixel index each thread of a compositing block holds. Thread
    i holds pixel i (the backward kernels; ``csrc/warp_cull.cuh::
    warp_rect``); with ``blocks``, the forward kernels' map
    (``block_pixel``): lane l of warp w holds pixel (8 (w % (tile_w / 8)) +
    l % 8, 4 (w // (tile_w / 8)) + l // 8) from the tile's corner, an 8x4
    block, where tile_w is a multiple of 8 and the tile's height of 4.
    Pixel i lies at (i % tile_w, i // tile_w)."""
    i = torch.arange(pix, device=device)
    if not (blocks and tile_w % 8 == 0 and pix % tile_w == 0
            and (pix // tile_w) % 4 == 0):
        return i
    warp, lane, across = i // 32, i % 32, tile_w // 8
    return (((warp // across) * 4 + lane // 8) * tile_w + (warp % across) * 8
            + lane % 8)


def warp_rects(origins: torch.Tensor, tile_w: int, pix: int,
               blocks: bool = False) -> torch.Tensor:
    """(T, pix // 32, 4) float32 pixel rectangle {x0, x1, y0, y1} of each
    warp of each tile's block: the bounding box of the warp's 32 pixels
    under ``warp_pixels``' map (``csrc/warp_cull.cuh::warp_rect``, or
    ``block_rect`` with ``blocks``)."""
    p = warp_pixels(tile_w, pix, blocks, origins.device).reshape(-1, 32)
    x, y = p % tile_w, p // tile_w
    ox = origins[:, 0:1].to(torch.float32)
    oy = origins[:, 1:2].to(torch.float32)
    return torch.stack([ox + x.amin(1), ox + x.amax(1), oy + y.amin(1),
                        oy + y.amax(1)], -1)


def warp_cull_mask_cuda(rows: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """The CUDA cull predicate (``gftorf_warp_cull_mask``, built with the
    dense backward) on the card: (n, m) bool, as ``warp_cull_plain``."""
    n, m = rows.shape[0], rects.shape[0]
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    check_tensors({"rows": (rows, torch.float32, (n, FEAT_COLS)),
                   "rects": (rects, torch.float32, (m, 4))}, dev)
    out = torch.empty((n, m), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _lib_backward().gftorf_warp_cull_mask(
            rows.data_ptr(), n, rects.data_ptr(), m, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp_cull_mask kernel launch failed: cudaError {err}")
    return out.bool()


def occupancy(fn, pix: int, flag_a: bool, flag_b: bool) -> dict:
    """What a C entry's ``*_occupancy`` reports for the instance a launch
    at ``pix`` threads a block with its two flags (``need_dd`` and
    ``has_flow`` for a backward, ``need_dd`` and ``need_distribution`` for
    a forward) runs, on the current card."""
    info = (ctypes.c_int * 4)()
    err = fn(pix, int(flag_a), int(flag_b), info)
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return dict(blocks_per_sm=info[0], registers=info[1], spill_bytes=info[2],
                shared_bytes=info[3])


def forward_occupancy(pix: int, need_dd: bool, need_dist: bool) -> dict:
    """Blocks per SM, registers, local bytes per thread and shared bytes
    per block of csrc/dense_forward.cu's instance on the current card."""
    return occupancy(_lib().gftorf_dense_forward_occupancy, pix, need_dd,
                     need_dist)


def backward_occupancy(pix: int, need_dd: bool, has_flow: bool) -> dict:
    """Blocks per SM, registers, local bytes per thread and shared bytes
    per block of csrc/dense_backward.cu's template on the current card."""
    return occupancy(_lib_backward().gftorf_dense_backward_occupancy, pix,
                     need_dd, has_flow)


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it whose data starts on a 16-byte boundary, as
    the compositing kernels' bulk copies need."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.cache
def _lib_backward() -> ctypes.CDLL:
    from gftorf_tpu_torch.render.kernels.build import library

    lib = library("dense_backward")
    fn = lib.gftorf_dense_backward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gftorf_dense_backward_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gftorf_warp_cull_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


BWD_MAX_PIXELS = 512


def backward_pixels_error(pix: int) -> Optional[str]:
    """Why the backward kernels cannot run a tile of ``pix`` pixels, or
    None: they run one thread per pixel, up to their
    ``__launch_bounds__`` of BWD_MAX_PIXELS threads, in whole warps."""
    if pix > BWD_MAX_PIXELS or pix % 32 != 0:
        return (f"tile_pixels={pix}: the backward kernel runs one thread per "
                f"pixel, so it must be a multiple of 32 up to {BWD_MAX_PIXELS}")
    return None


def composite_backward_cuda(feat_tl, bg_tiles, out_res, g, counts, origins,
                            config: RasterConfig, has_flow: bool):
    """Launch csrc/dense_backward.cu on the tensors' card; adds one to
    ``composite_backward_cuda.launches`` per launch. A launch the card
    refuses (too many threads, registers or shared memory) raises; the
    Trainer asks the card at start-up whether it would
    (``check_backward_fits``)."""
    T, L, C = feat_tl.shape
    pix = config.tile_pixels
    dev = feat_tl.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if C != FEAT_COLS:
        raise ValueError(f"feat_tl has {C} columns, the kernel takes {FEAT_COLS}")
    reason = backward_pixels_error(pix)
    if reason:
        raise ValueError(reason)
    expect = {
        "feat_tl": (feat_tl, torch.float32, (T, L, FEAT_COLS)),
        "bg_tiles": (bg_tiles, torch.float32, (T, pix, BG_COLS)),
        "out_res": (out_res, torch.float32, (T, pix, OUT_COLS)),
        "g": (g, torch.float32, (T, pix, OUT_COLS)),
        "counts": (counts, torch.int32, (T,)),
        "origins": (origins, torch.int32, (T, 2)),
    }
    check_tensors(expect, dev)
    feat_tl = aligned16(feat_tl)
    dfeat = torch.empty((T, L, FEAT_COLS), dtype=torch.float32, device=dev)
    if T == 0:
        return dfeat
    lib = _lib_backward()
    with torch.cuda.device(dev):
        err = lib.gftorf_dense_backward(
            feat_tl.data_ptr(), bg_tiles.data_ptr(), out_res.data_ptr(),
            g.data_ptr(), counts.data_ptr(), origins.data_ptr(),
            dfeat.data_ptr(), T, L, pix, config.tile_w, config.width,
            config.height, int(config.need_dd), int(has_flow),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_backward kernel launch failed: cudaError {err}")
    composite_backward_cuda.launches += 1
    debug_nans.check_output("the dense_backward kernel", dfeat)
    return dfeat


composite_backward_cuda.launches = 0


def check_backward_fits(tile_h: int, tile_w: int, need_dd: bool,
                        device) -> dict:
    """Raise unless the card can launch every instance of
    csrc/dense_backward.cu that a training step launches at ``tile_h`` x
    ``tile_w`` tiles: ``need_dd`` (the ToF render's gate; the colour
    render's is always off) and False, each with ``has_flow`` True and
    False. The Hopper counterpart of the TPU kernel
    ``gftorf_tpu/render/vmem_check.py::try_compile_bwd``, which compiles
    the Pallas backward at the Trainer's tile depth to see that it fits
    scoped VMEM.

    No device work. Per instance, ``backward_occupancy`` sets the
    dynamic-shared-memory attribute as a launch does
    (``composite_tile.cuh::kernel_prepare``) and asks the card for its
    blocks per SM. The card refuses a launch for too many threads, too
    many registers or too much shared memory: a tile that the kernel's
    block cannot hold (``backward_pixels_error``), a CUDA error from the
    query, or fewer than one block per SM raises a RuntimeError naming the
    instance, the tile and what the card reported. Spilled registers are
    slow, not refused: they are only reported.

    The tile depth L is not an argument. The kernel's shared memory is
    ``sizeof(BwdShared)`` (composite_tile.cuh), whatever L: rows are
    staged in batches of 256. Its offsets into the (T, L, 24) blocks are
    ``size_t``. So no depth makes the card refuse a launch that it takes
    at a shallow one; chip_smoke.py's deep-tile phase runs the kernel on
    a tile 21,535 rows deep, past the Trainer's 16,384. For the same
    reason the JAX package's calibrated depth table
    (``pallas_composite.py::_BWD_CAP_CALIBRATED``) has no counterpart, and
    the Trainer clamps no ``max_per_tile_limit`` to one.

    Returns ``{(need_dd, has_flow): occupancy}``, each ``backward_occupancy``'s
    report; adds one to ``check_backward_fits.launches`` per check that
    passes."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the fit check queries a CUDA card, got {device}")
    tile = f"{tile_h}x{tile_w} tiles"
    pix = tile_h * tile_w
    reason = backward_pixels_error(pix)
    if reason:
        raise RuntimeError(f"the dense backward kernel cannot run {tile}: {reason}")
    fits = {}
    with torch.cuda.device(device):
        for instance in dict.fromkeys((need_dd, False)):
            for has_flow in (True, False):
                what = (f"dense backward instance need_dd={instance}, "
                        f"has_flow={has_flow} at {tile}")
                try:
                    occ = backward_occupancy(pix, instance, has_flow)
                except RuntimeError as e:
                    raise RuntimeError(f"{what}: {e}") from e
                if occ["blocks_per_sm"] < 1:
                    raise RuntimeError(
                        f"{what}: the card fits {occ['blocks_per_sm']} blocks "
                        f"of {pix} threads per SM ({occ['registers']} "
                        f"registers a thread, {occ['shared_bytes']} B of "
                        "shared memory a block), so it refuses the launch")
                fits[(instance, has_flow)] = occ
    check_backward_fits.launches += 1
    return fits


check_backward_fits.launches = 0


# CUDA's occupancy rules for sm_90 that the device properties do not carry
# (the CUDA toolkit's cuda_occupancy.h).
SM90_MAX_BLOCKS_PER_SM = 32
SM90_MAX_REGS_PER_THREAD = 255
SM90_REGS_PER_BLOCK = 65536
SM90_REG_UNIT = 256  # registers are allocated to a warp in units of 256
SM90_SUB_PARTITIONS = 4  # each holds a quarter of the SM's registers and warps
SM90_SMEM_UNIT = 128  # shared memory is allocated to a block in 128 B units
SM90_SMEM_RESERVED = 1024  # and 1 KB more of it is reserved in every block


def blocks_per_sm_plain(props, pix: int, registers: int,
                        shared_bytes: int) -> int:
    """Blocks of ``pix`` threads that one SM holds at once, by CUDA's
    occupancy rules for sm_90, for a kernel of ``registers`` a thread and
    ``shared_bytes`` of shared memory a block (the kernels have no static
    shared memory): the plain version of the card's own query in
    ``check_backward_fits``. ``props`` has the fields of
    ``torch.cuda.get_device_properties`` that it reads. 0 means the card
    refuses a launch."""
    if pix > props.max_threads_per_block:
        return 0
    warp = props.warp_size
    warps = -(-pix // warp)
    by_threads = props.max_threads_per_multi_processor // (warps * warp)
    per_warp = -(-registers * warp // SM90_REG_UNIT) * SM90_REG_UNIT
    # The card checks a launch with the block's warps rounded up to the
    # sub-partitions, as if it took registers in all of them.
    held = per_warp * (-(-warps // SM90_SUB_PARTITIONS) * SM90_SUB_PARTITIONS)
    if registers > SM90_MAX_REGS_PER_THREAD or held > SM90_REGS_PER_BLOCK:
        by_regs = 0
    elif per_warp == 0:
        by_regs = SM90_MAX_BLOCKS_PER_SM
    else:
        per_part = props.regs_per_multiprocessor // SM90_SUB_PARTITIONS
        by_regs = (per_part // per_warp) * SM90_SUB_PARTITIONS // warps
    if shared_bytes > props.shared_memory_per_block_optin:
        by_shared = 0
    else:
        block = -(-(shared_bytes + SM90_SMEM_RESERVED) // SM90_SMEM_UNIT) * SM90_SMEM_UNIT
        by_shared = props.shared_memory_per_multiprocessor // block
    return min(SM90_MAX_BLOCKS_PER_SM, by_threads, by_regs, by_shared)


class DenseComposite(torch.autograd.Function):
    """The compositor with its backward kernel (``_make_pallas_vjp`` and
    ``_run_pallas_vjp``, pallas_composite.py:725-779).

    ``DenseComposite.apply(feat_tl, bg_tiles, counts, origins, config,
    has_flow)`` returns ``(out (T, PIX, 32), contrib (T, L))``. Only
    ``feat_tl`` and ``bg_tiles`` get gradients; ``contrib`` and the output
    columns 13:20 and 26:32 are not differentiable (the JAX
    stop-gradients at :773-774). ``has_flow`` False makes the flow
    columns' gradient zero, as the JAX kernel's static flag does."""

    @staticmethod
    def forward(ctx, feat_tl, bg_tiles, counts, origins, config, has_flow):
        out, contrib = composite_forward(feat_tl, bg_tiles, counts, origins,
                                         config)
        ctx.save_for_backward(feat_tl, bg_tiles, counts, origins, out)
        ctx.config = config
        ctx.has_flow = bool(has_flow)
        ctx.mark_non_differentiable(contrib)
        return out, contrib

    @staticmethod
    def backward(ctx, g_out, _g_contrib):
        feat_tl, bg_tiles, counts, origins, out = ctx.saved_tensors
        g = stopped_cotangent(g_out)
        dfeat = dbg = None
        if ctx.needs_input_grad[0]:
            dfeat = composite_backward(feat_tl, bg_tiles, out, g, counts,
                                       origins, ctx.config, ctx.has_flow)
        if ctx.needs_input_grad[1]:
            dbg = bg_grad(out, g, bg_tiles)
        return dfeat, dbg, None, None, None, None


def stopped_cotangent(g_out: torch.Tensor) -> torch.Tensor:
    """The output block's cotangent with columns 13:20 and 26:32 zeroed:
    those columns are not differentiable (the JAX stop-gradients,
    pallas_composite.py:773-774, flat_stream.py:563-564)."""
    g = g_out.clone()
    g[..., 13:20] = 0.0
    g[..., 26:] = 0.0
    return g.contiguous()


def bg_grad(out: torch.Tensor, g: torch.Tensor, bg_tiles: torch.Tensor) -> torch.Tensor:
    """Gradient w.r.t. the (T, PIX, 12) bg blocks: bg enters the output
    times the frozen final T (column 13) on the color and phasor columns."""
    t_final = out[..., 13:14]
    dbg = torch.zeros_like(bg_tiles)
    dbg[..., 0:3] = t_final * g[..., 0:3]
    dbg[..., 4:11] = t_final * g[..., 4:11]
    return dbg
