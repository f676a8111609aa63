"""Tile binning: expand Gaussians into (gaussian, tile) instances, sort by
(tile, depth), and lay them out for the compositor: densely as
(num_tiles, max_per_tile), or as the aligned flat stream.

Port of ``gftorf_tpu/render/binning.py`` (``bin_gaussians`` and
``bin_gaussians_flat``). Its integer outputs equal the JAX package's
exactly: both sorts are stable, and the JAX scatters' ``mode="drop"``
(out-of-range indices are skipped) is done by scattering into a buffer
padded by one row that is sliced off. Where JAX propagates a segment's
value along the slots by scatter-max + cummax (each slot's Gaussian, each
slot's tile segment start, each flat block's tile), the port finds the
same value by a binary search over an array that binning already holds
sorted: no atomics meet on one slot and no scan walks the slot array.
Indices are int64 inside; outputs are int32, as in JAX. Everything here
is integer bookkeeping: no gradients flow through it.
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


def _slot_owner(cum: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The Gaussian whose span holds each slot, from the inclusive prefix
    sum ``cum`` of the span lengths: the number of spans that end at or
    before the slot. JAX's scatter-max of each index at its span start,
    then cummax, gives the same: a Gaussian with no tiles ends where it
    starts and owns no slot (the next one with tiles, a larger index,
    wins that start), and slots at or past ``cum[-1]`` take the last
    Gaussian, ``P - 1``."""
    return torch.searchsorted(cum, slots, side="right").clamp(max=cum.shape[0] - 1)


def _segment_starts(tile_s: torch.Tensor, T: int):
    """First slot of each tile's run in the sorted ``tile_s``: (T,) for the
    tiles, and (K,) for the run each slot lies in, the sentinel tile ``T``
    past ``num_rendered`` included (JAX: cummax over the runs' heads)."""
    tids = torch.arange(T + 1, dtype=tile_s.dtype, device=tile_s.device)
    start = torch.searchsorted(tile_s, tids, side="left")
    return start[:T], start[tile_s]


def _block_tile(base_block: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Tile of each of ``n_blocks`` flat blocks: the last tile whose first
    block is at or before it (``base_block`` rises strictly from 0, a block
    or more a tile), so tail blocks take the last tile, as JAX's scatter-max
    of tile indices at their base blocks, then cummax, gives."""
    blocks = torch.arange(n_blocks, dtype=base_block.dtype, device=base_block.device)
    return torch.searchsorted(base_block, blocks, side="right") - 1


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

    g = _slot_owner(cum, slots)
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

    tile_start, seg_start = _segment_starts(tile_s, T)
    tids = torch.arange(T, dtype=i64, device=dev)
    tile_end = torch.searchsorted(tile_s, tids, side="right")
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

    chunk_tile = _block_tile(base_block, n_blocks)

    return FlatBinning(
        gauss_flat=gauss_flat[:K_pad],
        chunk_tile=chunk_tile.to(torch.int32),
        num_rendered=s.num_rendered.to(torch.int32),
        dup_overflow=s.dup_overflow,
        tile_max=raw_count.max().to(torch.int32),
        tile_start=(base_block * A).to(torch.int32),
        tile_count=raw_count.to(torch.int32),
    )
