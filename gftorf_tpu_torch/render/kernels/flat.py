"""Flat sorted-stream tile compositor: the Hopper kernels and their plain
versions.

Counterpart of ``gftorf_tpu/render/flat_stream.py``. The two TPU kernels
become CUDA C++ kernels for sm_90a bound with ctypes (their design and
bound are in the notes of those files):

 - ``_forward_kernel_flat`` (``composite_forward_flat``) ->
   ``csrc/flat_forward.cu``, wrapper ``composite_forward_flat_cuda``;
 - ``_backward_kernel_flat`` (``composite_backward_flat``) ->
   ``csrc/flat_backward.cu``, wrapper ``composite_backward_flat_cuda``.

The stream (K_pad, 24) holds each tile's depth-sorted instances as one
segment starting at a FLAT_ALIGN multiple (``binning.bin_gaussians_flat``);
every other row is padding. The kernels take the segments as
``tile_start`` / ``tile_count`` (T,) and each block walks its own tile's
rows, where the TPU kernels walk every stream chunk through a chunk->tile
map. So ``_flat_chunk`` and ``_chunk_tiles_for`` (the TPU grid's chunk
sizes and its scalar-prefetched map) have no counterpart here, and the
``GFTORF_FLAT_FWD_CHUNK`` / ``GFTORF_FLAT_BWD_CHUNK`` environment
variables, which size those chunks, are not read: FLAT_ALIGN is the JAX
package's default, 256.

``composite_forward_flat`` and ``composite_backward_flat`` dispatch on the
tensors' device like their dense counterparts (``dense.py``): a CUDA
tensor goes through the kernel (or the call raises), a CPU tensor through
the plain version. ``FlatComposite`` is the ``torch.autograd.Function`` in
place of ``_make_flat_vjp``; ``composite_packed_flat`` is
``flat_stream.py::composite_packed_flat``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gftorf_tpu_torch.render.kernels import dense
from gftorf_tpu_torch.render.kernels.dense import (
    BG_COLS,
    FEAT_COLS,
    OUT_COLS,
    TileOutputs,
    check_tensors,
)
from gftorf_tpu_torch.render.settings import RasterConfig
from gftorf_tpu_torch.utils import debug_nans

# Tile segments in the stream start at FLAT_ALIGN multiples
# (flat_stream.py:73-75 with its chunk variables unset).
FLAT_ALIGN = 256


def flat_stream_capacity(capacity: int, num_tiles: int) -> int:
    """Padded stream length K_pad: the aligned duplicate capacity plus one
    alignment block per tile (the per-tile round-up, and the block each
    empty tile still owns, fit in it)."""
    k_aligned = -(-capacity // FLAT_ALIGN) * FLAT_ALIGN
    return k_aligned + num_tiles * FLAT_ALIGN


def stream_slots(tile_start: torch.Tensor, tile_count: torch.Tensor):
    """(T, L) stream slot of each tile lane, L the deepest tile (at least
    1), and the (T, L) mask of lanes that hold an instance; the slot of an
    empty lane is 0. ``stream[slot]`` is the stream as a dense block."""
    L = max(1, int(tile_count.max())) if tile_count.numel() else 1
    lane = torch.arange(L, device=tile_count.device)
    present = lane < tile_count[:, None]
    slot = torch.where(present, tile_start[:, None].long() + lane, 0)
    return slot, present


# ---------------------------------------------------------------- forward


def composite_forward_flat(feat_fl, bg_tiles, tile_start, tile_count, origins,
                           config: RasterConfig):
    """Composite the aligned stream (K_pad, 24); returns (out (T, PIX, 32),
    contrib (K_pad,)). CUDA tensors run the Hopper kernel, CPU tensors the
    plain version."""
    if feat_fl.device.type == "cuda":
        return composite_forward_flat_cuda(feat_fl, bg_tiles, tile_start,
                                           tile_count, origins, config)
    if feat_fl.device.type == "cpu":
        return composite_forward_flat_plain(feat_fl, bg_tiles, tile_start,
                                            tile_count, origins, config)
    raise ValueError(f"no compositor for device {feat_fl.device}")


def composite_forward_flat_plain(feat_fl, bg_tiles, tile_start, tile_count,
                                 origins, config: RasterConfig):
    """The forward kernel's function in torch: each tile's segment cut
    into a (T, L, 24) block (L the deepest tile), composited by
    ``dense.composite_forward_plain``, and the per-lane counts put back in
    their stream slots; every other slot is 0."""
    slot, present = stream_slots(tile_start, tile_count)
    out, contrib_tl = dense.composite_forward_plain(
        feat_fl[slot], bg_tiles, tile_count, origins, config)
    contrib = feat_fl.new_zeros(feat_fl.shape[0])
    contrib[slot[present]] = contrib_tl[present]
    return out, contrib


@functools.cache
def _lib_forward() -> ctypes.CDLL:
    from gftorf_tpu_torch.render.kernels.build import library

    lib = library("flat_forward")
    fn = lib.gftorf_flat_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gftorf_flat_forward_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def forward_occupancy(pix: int, need_dd: bool, need_dist: bool) -> dict:
    """Blocks per SM, registers, local bytes per thread and shared bytes
    per block of csrc/flat_forward.cu's instance on the current card."""
    return dense.occupancy(_lib_forward().gftorf_flat_forward_occupancy, pix,
                           need_dd, need_dist)


def _check_stream(feat_fl, bg_tiles, tile_start, tile_count, origins, pix,
                  extra=()):
    """The checks both flat wrappers make before a launch."""
    K, C = feat_fl.shape
    T = bg_tiles.shape[0]
    dev = feat_fl.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if C != FEAT_COLS:
        raise ValueError(f"feat_fl has {C} columns, the kernel takes {FEAT_COLS}")
    if K % FLAT_ALIGN != 0:
        raise ValueError(f"stream length {K} is not a multiple of "
                         f"FLAT_ALIGN={FLAT_ALIGN}")
    expect = {
        "feat_fl": (feat_fl, torch.float32, (K, FEAT_COLS)),
        "bg_tiles": (bg_tiles, torch.float32, (T, pix, BG_COLS)),
        "tile_start": (tile_start, torch.int32, (T,)),
        "tile_count": (tile_count, torch.int32, (T,)),
        "origins": (origins, torch.int32, (T, 2)),
    }
    for name, x in extra:
        expect[name] = (x, torch.float32, (T, pix, OUT_COLS))
    check_tensors(expect, dev)
    return K, T, dev


def composite_forward_flat_cuda(feat_fl, bg_tiles, tile_start, tile_count,
                                origins, config: RasterConfig):
    """Launch csrc/flat_forward.cu on the tensors' card; adds one to
    ``composite_forward_flat_cuda.launches`` per launch. Each tile's
    segment must lie inside the stream (the kernel cuts a range that does
    not)."""
    pix = config.tile_pixels
    if torch.is_grad_enabled():
        for name, x in (("feat_fl", feat_fl), ("bg_tiles", bg_tiles)):
            if x.requires_grad:
                raise ValueError(
                    f"{name} requires grad: call FlatComposite.apply, whose "
                    "backward is the flat backward kernel"
                )
    if pix > 1024 or pix % 32 != 0:
        raise ValueError(f"tile_pixels={pix}: the kernel runs one thread per "
                         "pixel, so it must be a multiple of 32 up to 1024")
    K, T, dev = _check_stream(feat_fl, bg_tiles, tile_start, tile_count,
                              origins, pix)
    feat_fl = dense.aligned16(feat_fl)
    out = torch.empty((T, pix, OUT_COLS), dtype=torch.float32, device=dev)
    # Slots no tile walks (padding, the tail) stay 0.
    contrib = torch.zeros((K,), dtype=torch.float32, device=dev)
    if T == 0:
        return out, contrib
    lib = _lib_forward()
    with torch.cuda.device(dev):
        err = lib.gftorf_flat_forward(
            feat_fl.data_ptr(), bg_tiles.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), origins.data_ptr(), out.data_ptr(),
            contrib.data_ptr(), T, K, pix, config.tile_w, config.width,
            config.height, int(config.need_dd), int(config.need_distribution),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flat_forward kernel launch failed: cudaError {err}")
    composite_forward_flat_cuda.launches += 1
    debug_nans.check_output("the flat_forward kernel", out, contrib)
    return out, contrib


composite_forward_flat_cuda.launches = 0


# ---------------------------------------------------------------- backward


def composite_backward_flat(feat_fl, bg_tiles, out_res, g, tile_start,
                            tile_count, origins, config: RasterConfig,
                            has_flow: bool):
    """Gradient of the (T, PIX, 32) output block w.r.t. the stream
    (K_pad, 24), given the forward's output ``out_res`` and the cotangent
    ``g`` (its columns 13:20 and 26:32 are ignored). CUDA tensors run the
    Hopper kernel, CPU tensors the plain version."""
    if feat_fl.device.type == "cuda":
        return composite_backward_flat_cuda(feat_fl, bg_tiles, out_res, g,
                                            tile_start, tile_count, origins,
                                            config, has_flow)
    if feat_fl.device.type == "cpu":
        return composite_backward_flat_plain(feat_fl, bg_tiles, out_res, g,
                                             tile_start, tile_count, origins,
                                             config, has_flow)
    raise ValueError(f"no compositor for device {feat_fl.device}")


def composite_backward_flat_plain(feat_fl, bg_tiles, out_res, g, tile_start,
                                  tile_count, origins, config: RasterConfig,
                                  has_flow: bool):
    """The backward kernel's function in torch: ``dense.
    composite_backward_plain`` on the stream cut into a (T, L, 24) block,
    its rows put back in their stream slots; every other row is 0."""
    slot, present = stream_slots(tile_start, tile_count)
    dfeat_tl = dense.composite_backward_plain(
        feat_fl[slot], bg_tiles, out_res, g, tile_count, origins, config,
        has_flow)
    dfeat = feat_fl.new_zeros(feat_fl.shape)
    dfeat[slot[present]] = dfeat_tl[present]
    return dfeat


@functools.cache
def _lib_backward() -> ctypes.CDLL:
    from gftorf_tpu_torch.render.kernels.build import library

    lib = library("flat_backward")
    fn = lib.gftorf_flat_backward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.gftorf_flat_backward_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def backward_occupancy(pix: int, need_dd: bool, has_flow: bool) -> dict:
    """Blocks per SM, registers, local bytes per thread and shared bytes
    per block of csrc/flat_backward.cu's template on the current card."""
    return dense.occupancy(_lib_backward().gftorf_flat_backward_occupancy, pix,
                           need_dd, has_flow)


def composite_backward_flat_cuda(feat_fl, bg_tiles, out_res, g, tile_start,
                                 tile_count, origins, config: RasterConfig,
                                 has_flow: bool):
    """Launch csrc/flat_backward.cu on the tensors' card; adds one to
    ``composite_backward_flat_cuda.launches`` per launch. Tiles of more
    than 512 pixels are refused, as the TPU kernel refuses them
    (flat_stream.py:471-483)."""
    pix = config.tile_pixels
    reason = dense.backward_pixels_error(pix)
    if reason:
        raise ValueError(f"flat stream: {reason} (e.g. 16x32 tiles); "
                         "forward-only flat renders are unaffected")
    K, T, dev = _check_stream(feat_fl, bg_tiles, tile_start, tile_count,
                              origins, pix, (("out_res", out_res), ("g", g)))
    feat_fl = dense.aligned16(feat_fl)
    # Rows no tile walks (padding, the tail) stay 0.
    dfeat = torch.zeros((K, FEAT_COLS), dtype=torch.float32, device=dev)
    if T == 0:
        return dfeat
    lib = _lib_backward()
    with torch.cuda.device(dev):
        err = lib.gftorf_flat_backward(
            feat_fl.data_ptr(), bg_tiles.data_ptr(), out_res.data_ptr(),
            g.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            origins.data_ptr(), dfeat.data_ptr(), T, K, pix, config.tile_w,
            config.width, config.height, int(config.need_dd), int(has_flow),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flat_backward kernel launch failed: cudaError {err}")
    composite_backward_flat_cuda.launches += 1
    debug_nans.check_output("the flat_backward kernel", dfeat)
    return dfeat


composite_backward_flat_cuda.launches = 0


# ---------------------------------------------------------------- autograd


class FlatComposite(torch.autograd.Function):
    """The flat compositor with its backward kernel (``_make_flat_vjp``,
    flat_stream.py:515-546).

    ``FlatComposite.apply(feat_fl, bg_tiles, tile_start, tile_count,
    origins, config, has_flow)`` returns ``(out (T, PIX, 32), contrib
    (K_pad,))``. Only ``feat_fl`` and ``bg_tiles`` get gradients; contrib
    and the output columns 13:20 and 26:32 are not differentiable (the
    stop-gradients of ``composite_packed_flat``, :563-572). ``has_flow``
    False makes the flow columns' gradient zero."""

    @staticmethod
    def forward(ctx, feat_fl, bg_tiles, tile_start, tile_count, origins,
                config, has_flow):
        out, contrib = composite_forward_flat(feat_fl, bg_tiles, tile_start,
                                              tile_count, origins, config)
        ctx.save_for_backward(feat_fl, bg_tiles, tile_start, tile_count,
                              origins, out)
        ctx.config = config
        ctx.has_flow = bool(has_flow)
        ctx.mark_non_differentiable(contrib)
        return out, contrib

    @staticmethod
    def backward(ctx, g_out, _g_contrib):
        feat_fl, bg_tiles, tile_start, tile_count, origins, out = ctx.saved_tensors
        g = dense.stopped_cotangent(g_out)
        dfeat = dbg = None
        if ctx.needs_input_grad[0]:
            dfeat = composite_backward_flat(feat_fl, bg_tiles, out, g,
                                            tile_start, tile_count, origins,
                                            ctx.config, ctx.has_flow)
        if ctx.needs_input_grad[1]:
            dbg = dense.bg_grad(out, g, bg_tiles)
        return dfeat, dbg, None, None, None, None, None


def composite_packed_flat(feat_fl, tile_start, tile_count, bg_tiles, origins,
                          config: RasterConfig, has_flow: bool = True) -> TileOutputs:
    """Composite the aligned packed stream (flat_stream.py:549-574);
    returns TileOutputs with ``contrib_pixels`` in stream layout (K_pad,)."""
    out, contrib = FlatComposite.apply(feat_fl, bg_tiles, tile_start,
                                       tile_count, origins, config, has_flow)
    return dense.unpack_outputs(out, contrib)
