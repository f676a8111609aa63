"""Binning's binary searches against the scatter-max + cummax they replace.

``render/binning.py`` finds each slot's Gaussian (``_slot_owner``), each
slot's tile segment start (``_segment_starts``) and each flat block's tile
(``_block_tile``) by a binary search over an array that binning holds
sorted. The JAX package propagates the same values by a scatter-max at the
segments' starts followed by cummax. This file keeps that formulation as
the plain version, patches it in for the three helpers, and requires the
sorted instance list (``_Sorted``) and both layouts (``Binning``,
``FlatBinning``) to be identical, field by field and dtype by dtype.

The CPU cases: Gaussians with no tiles at the start, the middle and the
end of the depth order; every Gaussian culled; a single Gaussian; a
duplicate list that overflows, with spans that start past its capacity;
empty trailing tiles, so that ``chunk_tile`` has tail blocks; a deep tile.
The ``gpu`` case runs at the binning scale of the ``garden`` benchmark
cell on the card (4,194,304 rows, 8,388,608 slots, over a million rows
culled, a 1297x840 frame of 16x16 tiles, the flat layout) and skips here.
This file imports no JAX.
"""

import dataclasses

import pytest
import torch

from gftorf_tpu_torch.render import binning
from gftorf_tpu_torch.render.kernels.flat import FLAT_ALIGN, flat_stream_capacity
from gftorf_tpu_torch.render.settings import RasterConfig

I64 = torch.int64


def scatter_cummax_owner(cum, slots):
    """Each slot's Gaussian: every index scatter-maxed at its span start
    (starts at or past the capacity dropped into a padding row), then
    cummax over the slots."""
    capacity, P = slots.shape[0], cum.shape[0]
    offsets = torch.cat([cum.new_zeros(1), cum[:-1]])
    gids = torch.arange(P, dtype=I64, device=cum.device)
    seg = torch.zeros(capacity + 1, dtype=I64, device=cum.device)
    seg.scatter_reduce_(0, offsets.clamp(max=capacity), gids, reduce="amax")
    return torch.cummax(seg[:capacity], 0).values


def scatter_cummax_segment_starts(tile_s, T):
    """Each tile's first slot by search, and each slot's run start as the
    cummax of the runs' head positions."""
    tids = torch.arange(T, dtype=I64, device=tile_s.device)
    tile_start = torch.searchsorted(tile_s, tids, side="left")
    slots = torch.arange(tile_s.shape[0], dtype=I64, device=tile_s.device)
    is_head = torch.ones_like(tile_s, dtype=torch.bool)
    is_head[1:] = tile_s[1:] != tile_s[:-1]
    heads = torch.where(is_head, slots, torch.zeros_like(slots))
    return tile_start, torch.cummax(heads, 0).values


def scatter_cummax_block_tile(base_block, n_blocks):
    """Each flat block's tile: every tile index scatter-maxed at its base
    block, then cummax over the blocks."""
    tids = torch.arange(base_block.shape[0], dtype=I64, device=base_block.device)
    ct = torch.zeros(n_blocks + 1, dtype=I64, device=base_block.device)
    ct.scatter_reduce_(0, base_block.clamp(max=n_blocks), tids, reduce="amax")
    return torch.cummax(ct[:n_blocks], 0).values


PLAIN = {
    "_slot_owner": scatter_cummax_owner,
    "_segment_starts": scatter_cummax_segment_starts,
    "_block_tile": scatter_cummax_block_tile,
}


def bin_all(rect, depth, valid, config, capacity):
    return (
        binning._sort_instances(rect, depth, valid, config, capacity,
                                config.num_tiles),
        binning.bin_gaussians(rect, depth, valid, config, capacity),
        binning.bin_gaussians_flat(rect, depth, valid, config, capacity),
    )


def searched_and_plain(monkeypatch, rect, depth, valid, config, capacity):
    searched = bin_all(rect, depth, valid, config, capacity)
    calls = []
    with monkeypatch.context() as m:
        for name, fn in PLAIN.items():
            def counted(*args, _fn=fn, _name=name):
                calls.append(_name)
                return _fn(*args)
            m.setattr(binning, name, counted)
        plain = bin_all(rect, depth, valid, config, capacity)
    assert sorted(set(calls)) == sorted(PLAIN)
    return searched, plain


def assert_identical(searched, plain):
    for got, want in zip(searched, plain):
        assert type(got) is type(want)
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, (type(want).__name__, name)
            assert a.shape == b.shape, (type(want).__name__, name)
            assert torch.equal(a, b), (type(want).__name__, name)


def random_rects(gen, n, gw, gh):
    """(n, 4) int32 rects [x0, y0, x1, y1) of 1 to 3 tiles a side inside a
    gw x gh grid."""
    nx = (1 + torch.randint(0, 3, (n,), generator=gen)).clamp(max=gw)
    ny = (1 + torch.randint(0, 3, (n,), generator=gen)).clamp(max=gh)
    x0 = (torch.rand(n, generator=gen) * (gw - nx + 1)).long()
    y0 = (torch.rand(n, generator=gen) * (gh - ny + 1)).long()
    return torch.stack([x0, y0, x0 + nx, y0 + ny], -1).int()


def quarter_depths(gen, n):
    """Depths in quarters from 0.25 to 10: many ties."""
    return torch.randint(1, 41, (n,), generator=gen).float() / 4.0


def small_case(case):
    """(rect, depth, valid, config, capacity) of one CPU case, on a 64x48
    frame of 16x16 tiles (a 4x3 grid)."""
    config = RasterConfig(height=48, width=64, flat_stream=True)
    gw, gh = config.grid_w, config.grid_h
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    n = {"single": 1, "all_culled": 20, "overflow": 200}.get(case, 60)
    rect = random_rects(gen, n, gw, gh)
    depth = quarter_depths(gen, n)
    valid = torch.rand(n, generator=gen) > 0.1
    capacity = config.capacity_for(n)
    if case == "no_tile_spans":
        # Valid with an empty rect: first, mid-way and last by depth;
        # then the culled ones, which sort after every valid one.
        for i, d in ((5, 0.0), (17, 5.0), (29, 11.0)):
            rect[i, 2] = rect[i, 0]
            depth[i], valid[i] = d, True
        valid[40:44] = False
    elif case == "all_culled":
        valid[:] = False
    elif case == "single":
        rect[0] = torch.tensor([1, 0, 3, 2])
        valid[0] = True
    elif case == "overflow":
        capacity = 100
    elif case == "empty_trailing_tiles":
        rect[:, 2] = rect[:, 2].clamp(max=gw - 2)
        rect[:, 0] = torch.minimum(rect[:, 0], rect[:, 2] - 1)
        rect[:, 3] = rect[:, 3].clamp(max=gh - 1)
        rect[:, 1] = torch.minimum(rect[:, 1], rect[:, 3] - 1)
    elif case == "deep_tile":
        config = dataclasses.replace(config, max_per_tile=512)
        deep = 700
        rect = torch.cat([rect, torch.tensor([[1, 1, 2, 2]] * deep,
                                             dtype=torch.int32)])
        depth = torch.cat([depth, quarter_depths(gen, deep)])
        valid = torch.cat([valid, torch.ones(deep, dtype=torch.bool)])
        capacity = config.capacity_for(n + deep)
    return rect, depth, valid, config, capacity


CASES = ("no_tile_spans", "all_culled", "single", "overflow",
         "empty_trailing_tiles", "deep_tile")


@pytest.mark.parametrize("case", CASES)
def test_searches_match_scatter_cummax(monkeypatch, case):
    rect, depth, valid, config, capacity = small_case(case)
    searched, plain = searched_and_plain(monkeypatch, rect, depth, valid,
                                         config, capacity)
    assert_identical(searched, plain)

    # Each case reaches what it is named for.
    s, dense, flat = searched
    counts = torch.where(valid, (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]), 0)
    num_rendered = int(counts.sum())
    assert int(s.num_rendered) == num_rendered
    T = config.num_tiles
    raw = s.tile_end - s.tile_start
    if case == "no_tile_spans":
        order = torch.sort(torch.where(valid, depth, float("inf")), stable=True).indices
        empty = (valid & (counts == 0))[order].nonzero().flatten().tolist()
        last = int(valid.sum()) - 1
        assert 0 in empty and last in empty
        assert any(0 < i < last for i in empty)
    if case == "all_culled":
        assert num_rendered == 0 and int(flat.tile_max) == 0
        assert (dense.gauss_id == -1).all() and (flat.gauss_flat == -1).all()
    if case == "single":
        assert num_rendered == 4 and dense.tile_count.tolist().count(1) == 4
    if case == "overflow":
        assert bool(s.dup_overflow) and num_rendered > capacity
        offsets = torch.cumsum(counts, 0) - counts
        assert int((offsets[valid] > capacity).sum()) > 10
        assert int(raw.sum()) == capacity
    if case == "empty_trailing_tiles":
        assert int(raw[-1]) == 0 and int(flat.tile_count[-1]) == 0
        n_blocks = flat_stream_capacity(capacity, T) // FLAT_ALIGN
        used = int(flat.tile_start[-1]) // FLAT_ALIGN + 1
        assert n_blocks > used  # tail blocks past the last tile's
        assert (flat.chunk_tile[used - 1:] == T - 1).all()
    if case == "deep_tile":
        assert int(flat.tile_max) > 2 * FLAT_ALIGN
        assert int(dense.tile_overflow) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 with -m gpu")
    return torch.device("cuda")


@pytest.mark.gpu
def test_searches_match_scatter_cummax_at_garden_scale_on_card(monkeypatch, cuda):
    """4,194,304 rows in 8,388,608 slots (``dup_factor`` 2), 1,194,304 of
    them culled, 5 % of the rest with no tiles, 30,000 on one tile, over
    garden's 1297x840 frame: the flat layout the cell runs, and the dense
    one at its default depth."""
    P, culled, deep = 4_194_304, 1_194_304, 30_000
    config = RasterConfig(height=840, width=1297, dup_factor=2, flat_stream=True)
    gw, gh = config.grid_w, config.grid_h
    gen = torch.Generator(device=cuda).manual_seed(2**31 + 7)

    def uniform():
        return torch.rand(P, generator=gen, device=cuda)

    # Sides of one tile, or of two at 12 %: about 3.6 million instances.
    nx, ny = 1 + (uniform() < 0.12).long(), 1 + (uniform() < 0.12).long()
    x0, y0 = (uniform() * (gw - nx + 1)).long(), (uniform() * (gh - ny + 1)).long()
    nx = torch.where(uniform() < 0.05, 0, nx)  # no tiles
    rect = torch.stack([x0, y0, x0 + nx, y0 + ny], -1).int()
    rect[:deep] = torch.tensor([40, 26, 41, 27], dtype=torch.int32, device=cuda)
    depth = torch.randint(1, 1 << 16, (P,), generator=gen, device=cuda).float() / 64
    valid = torch.ones(P, dtype=torch.bool, device=cuda)
    valid[torch.randperm(P - deep, generator=gen, device=cuda)[:culled] + deep] = False
    capacity = config.capacity_for(P)
    assert (gw, gh, capacity) == (82, 53, 8_388_608)

    searched, plain = searched_and_plain(monkeypatch, rect, depth, valid,
                                         config, capacity)
    torch.cuda.synchronize()
    assert_identical(searched, plain)
    s, _, flat = searched
    assert int((~valid).sum()) == culled
    assert 3_000_000 < int(s.num_rendered) < capacity
    assert deep <= int(flat.tile_max) < deep + 2_000
