"""Tile binning: expand Gaussians into (gaussian, tile) instances, sort by
(tile, depth), and lay them out densely as (num_tiles, max_per_tile).

Port of ``gftorf_tpu/render/binning.py::bin_gaussians`` (dense layout).
Its integer outputs equal the JAX package's exactly: both sorts are
stable, the scatter-max + cummax segment propagation is the same, and the
JAX scatters' ``mode="drop"`` (out-of-range indices are skipped) is done
by scattering into a buffer padded by one row that is sliced off.
Indices are int64 inside; outputs are int32, as in JAX. Everything here
is integer bookkeeping: no gradients flow through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gftorf_tpu_torch.render.settings import RasterConfig


class Binning(NamedTuple):
    gauss_id: torch.Tensor  # (T, L) int32, index into Gaussians; -1 = empty
    tile_count: torch.Tensor  # (T,) int32 instances per tile (clipped to L)
    num_rendered: torch.Tensor  # () int32
    dup_overflow: torch.Tensor  # () bool
    tile_overflow: torch.Tensor  # () int32 max dropped in one tile
    tile_max: torch.Tensor  # () int32 deepest tile (pre-clip)


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
    gw, gh = config.grid_w, config.grid_h
    # The per-slot rect fields are packed 8 bits each below.
    if gw >= 256 or gh >= 256:
        raise ValueError(
            f"tile grid {gw}x{gh}: binning packs rect fields into 8 bits, "
            "so each grid dimension must stay below 256"
        )
    dev = rect.device
    P = rect.shape[0]
    T = config.num_tiles
    L = config.max_per_tile
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
    dup_overflow = num_rendered > capacity
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
    pos = slots - seg_start
    keep = (tile_s < T) & (pos < L)
    gauss_id = torch.full((T + 1, L), -1, dtype=torch.int32, device=dev)
    gauss_id[torch.where(keep, tile_s, T), torch.where(keep, pos, 0)] = (
        g_s.to(torch.int32))
    gauss_id = gauss_id[:T]

    raw_count = tile_end - tile_start
    tile_count = raw_count.clamp(max=L)
    return Binning(
        gauss_id=gauss_id,
        tile_count=tile_count.to(torch.int32),
        num_rendered=num_rendered.to(torch.int32),
        dup_overflow=dup_overflow,
        tile_overflow=(raw_count - tile_count).max().to(torch.int32),
        tile_max=raw_count.max().to(torch.int32),
    )
