"""Tile binning: expand Gaussians into (gaussian, tile) instances, sort by
(tile, depth), and lay them out for the compositor: densely as
(num_tiles, max_per_tile), or as the aligned flat stream.

Port of ``gftorf_tpu/render/binning.py`` (``bin_gaussians`` and
``bin_gaussians_flat``). Its integer outputs equal the JAX package's
exactly: both sorts are stable, the scatter-max + cummax segment
propagation is the same, and the JAX scatters' ``mode="drop"``
(out-of-range indices are skipped) is done by scattering into a buffer
padded by one row that is sliced off. Indices are int64 inside; outputs
are int32, as in JAX. Everything here is integer bookkeeping: no
gradients flow through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gftorf_tpu_torch.render.kernels.flat import FLAT_ALIGN, flat_stream_capacity
from gftorf_tpu_torch.render.settings import RasterConfig


class Binning(NamedTuple):
    gauss_id: torch.Tensor  # (T, L) int32, index into Gaussians; -1 = empty
    tile_count: torch.Tensor  # (T,) int32 instances per tile (clipped to L)
    num_rendered: torch.Tensor  # () int32
    dup_overflow: torch.Tensor  # () bool
    tile_overflow: torch.Tensor  # () int32 max dropped in one tile
    tile_max: torch.Tensor  # () int32 deepest tile (pre-clip)


class FlatBinning(NamedTuple):
    """Aligned sorted-stream layout for the flat compositor: each tile's
    instances are one contiguous, depth-ordered segment starting at a
    FLAT_ALIGN multiple; every other slot is padding (-1). The first five
    fields are the JAX package's; ``tile_start`` and ``tile_count`` are the
    port's own, the row range each kernel block walks (the JAX kernel walks
    every chunk and finds its tile through ``chunk_tile`` instead)."""

    gauss_flat: torch.Tensor  # (K_pad,) int32 gaussian ids; -1 = padding
    chunk_tile: torch.Tensor  # (K_pad/FLAT_ALIGN,) int32 owning tile
    num_rendered: torch.Tensor  # () int32
    dup_overflow: torch.Tensor  # () bool
    tile_max: torch.Tensor  # () int32 deepest tile
    tile_start: torch.Tensor  # (T,) int32 first slot of each tile's segment
    tile_count: torch.Tensor  # (T,) int32 instances of each tile


class _Sorted(NamedTuple):
    """The (tile, depth)-sorted instance list both layouts are cut from."""

    tile_s: torch.Tensor  # (K,) int64 tile per slot; T past num_rendered
    g_s: torch.Tensor  # (K,) int64 gaussian per slot
    pos: torch.Tensor  # (K,) int64 position within its tile
    tile_start: torch.Tensor  # (T,) int64 first slot of each tile
    tile_end: torch.Tensor  # (T,) int64
    num_rendered: torch.Tensor  # () int64
    dup_overflow: torch.Tensor  # () bool


def _sort_instances(rect, depth_view, valid, config: RasterConfig,
                    capacity: int, T: int) -> _Sorted:
    """Expand each valid Gaussian over its tile rect into ``capacity``
    slots and sort the slots by (tile, depth) (binning.py:57-123)."""
    gw, gh = config.grid_w, config.grid_h
    # The per-slot rect fields are packed 8 bits each below.
    if gw >= 256 or gh >= 256:
        raise ValueError(
            f"tile grid {gw}x{gh}: binning packs rect fields into 8 bits, "
            "so each grid dimension must stay below 256"
        )
    dev = rect.device
    P = rect.shape[0]
    i64 = torch.int64

    # Depth pre-sort (stable): instances expanded in this order are
    # depth-ordered within every tile, so the big sort needs only the
    # tile key.
    depth_key = torch.where(valid, depth_view,
                            torch.full_like(depth_view, float("inf"))).float()
    _, order = torch.sort(depth_key, stable=True)
    rect = rect[order].to(i64)
    valid = valid[order]

    nx = rect[:, 2] - rect[:, 0]
    counts = torch.where(valid, nx * (rect[:, 3] - rect[:, 1]),
                         torch.zeros_like(nx))
    cum = torch.cumsum(counts, 0)
    num_rendered = cum[-1]
    offsets = cum - counts  # (P,) start slot of each gaussian's span

    slots = torch.arange(capacity, dtype=i64, device=dev)
    slot_valid = slots < num_rendered

    # Owner propagation: scatter-max each gaussian's index at its span
    # start, then cummax. Starts at or past the capacity are dropped (the
    # padding row).
    gids = torch.arange(P, dtype=i64, device=dev)
    seg = torch.zeros(capacity + 1, dtype=i64, device=dev)
    seg.scatter_reduce_(0, offsets.clamp(max=capacity), gids, reduce="amax")
    g = torch.cummax(seg[:capacity], 0).values

    within = slots - offsets[g]

    packed = rect[:, 0] | (rect[:, 1] << 8) | (nx.clamp(min=1) << 16)
    pk = packed[g]
    x0 = pk & 0xFF
    y0 = (pk >> 8) & 0xFF
    nxg = (pk >> 16) & 0xFF
    # Row-major walk over the rect (duplicateWithKeys,
    # rasterizer_impl.cu:72-113).
    tile_x = x0 + within % nxg
    tile_y = y0 + within // nxg
    tile = torch.where(slot_valid, tile_y * gw + tile_x,
                       torch.full_like(tile_x, T))  # sentinel sorts last

    tile_s, perm = torch.sort(tile, stable=True)
    g_s = order[g[perm]]

    tids = torch.arange(T, dtype=i64, device=dev)
    tile_start = torch.searchsorted(tile_s, tids, side="left")
    tile_end = torch.searchsorted(tile_s, tids, side="right")

    is_head = torch.ones_like(tile_s, dtype=torch.bool)
    is_head[1:] = tile_s[1:] != tile_s[:-1]
    seg_start = torch.cummax(torch.where(is_head, slots, torch.zeros_like(slots)), 0).values
    return _Sorted(tile_s=tile_s, g_s=g_s, pos=slots - seg_start,
                   tile_start=tile_start, tile_end=tile_end,
                   num_rendered=num_rendered,
                   dup_overflow=num_rendered > capacity)


def bin_gaussians(
    rect: torch.Tensor,
    depth_view: torch.Tensor,
    valid: torch.Tensor,
    config: RasterConfig,
    capacity: int,
) -> Binning:
    """Build the dense per-tile instance layout.

    Args:
        rect: (P, 4) int32 tile rects [x0, y0, x1, y1).
        depth_view: (P,) view-space z sort key (positive for valid).
        valid: (P,) bool.
        capacity: duplicate-list capacity K.
    """
    T = config.num_tiles
    L = config.max_per_tile
    s = _sort_instances(rect, depth_view, valid, config, capacity, T)
    keep = (s.tile_s < T) & (s.pos < L)
    gauss_id = torch.full((T + 1, L), -1, dtype=torch.int32, device=rect.device)
    gauss_id[torch.where(keep, s.tile_s, T), torch.where(keep, s.pos, 0)] = (
        s.g_s.to(torch.int32))
    gauss_id = gauss_id[:T]

    raw_count = s.tile_end - s.tile_start
    tile_count = raw_count.clamp(max=L)
    return Binning(
        gauss_id=gauss_id,
        tile_count=tile_count.to(torch.int32),
        num_rendered=s.num_rendered.to(torch.int32),
        dup_overflow=s.dup_overflow,
        tile_overflow=(raw_count - tile_count).max().to(torch.int32),
        tile_max=raw_count.max().to(torch.int32),
    )


def bin_gaussians_flat(
    rect: torch.Tensor,
    depth_view: torch.Tensor,
    valid: torch.Tensor,
    config: RasterConfig,
    capacity: int,
) -> FlatBinning:
    """Build the aligned flat-stream layout (binning.py:169-270): the same
    expansion and sort as ``bin_gaussians``, then each tile's instances go
    to a segment of whole FLAT_ALIGN blocks (at least one per tile, so an
    empty tile still owns a block), in (K_pad,) slots."""
    T = config.num_tiles
    A = FLAT_ALIGN
    K_pad = flat_stream_capacity(capacity, T)
    dev = rect.device
    s = _sort_instances(rect, depth_view, valid, config, capacity, T)

    raw_count = s.tile_end - s.tile_start
    blocks_per_tile = (-(-raw_count // A)).clamp(min=1)
    base_block = torch.cumsum(blocks_per_tile, 0) - blocks_per_tile  # (T,)
    n_blocks = K_pad // A

    keep = s.tile_s < T
    dest = torch.where(keep, base_block[s.tile_s.clamp(max=T - 1)] * A + s.pos,
                       K_pad).clamp(max=K_pad)
    gauss_flat = torch.full((K_pad + 1,), -1, dtype=torch.int32, device=dev)
    gauss_flat[dest] = s.g_s.to(torch.int32)

    # Block -> tile map: each tile's index at its base block, then cummax;
    # tail blocks inherit the last tile (their rows are padding).
    tids = torch.arange(T, dtype=torch.int64, device=dev)
    ct = torch.zeros(n_blocks + 1, dtype=torch.int64, device=dev)
    ct.scatter_reduce_(0, base_block.clamp(max=n_blocks), tids, reduce="amax")
    chunk_tile = torch.cummax(ct[:n_blocks], 0).values

    return FlatBinning(
        gauss_flat=gauss_flat[:K_pad],
        chunk_tile=chunk_tile.to(torch.int32),
        num_rendered=s.num_rendered.to(torch.int32),
        dup_overflow=s.dup_overflow,
        tile_max=raw_count.max().to(torch.int32),
        tile_start=(base_block * A).to(torch.int32),
        tile_count=raw_count.to(torch.int32),
    )
