"""The port's flat-stream binning against the JAX package.

Both packages bin the same rects, depths and validity flags into the
aligned sorted stream; every integer the JAX ``bin_gaussians_flat``
returns (``gauss_flat``, ``chunk_tile``, ``num_rendered``,
``dup_overflow``, ``tile_max``) must be exactly equal, with its dtype.
Cases: a preprocessed scene, synthetic rects with empty tiles, one tile
far deeper than the alignment block, and a duplicate list that overflows
its capacity (the ``mode="drop"`` scatters). The port's own
``tile_start`` / ``tile_count`` must describe the JAX layout: each tile's
instances are exactly rows [tile_start, tile_start + tile_count) of
``gauss_flat``, in the blocks ``chunk_tile`` gives that tile. The layout
invariants of tests/test_flat_stream.py::test_flat_binning_layout hold on
the port's stream. The JAX module reads its alignment from the
environment at import, so the test first checks that it is the default,
256, the port's FLAT_ALIGN.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.render import flat_stream as j_flat
from gftorf_tpu.render.binning import bin_gaussians_flat as j_bin_flat
from gftorf_tpu.render.preprocess import preprocess as j_pre
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu_torch.render.binning import bin_gaussians_flat as t_bin_flat
from gftorf_tpu_torch.render.kernels.flat import FLAT_ALIGN, flat_stream_capacity
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
from torch_port_util import cameras, scene_arrays

W, H = 64, 48
JAX_FIELDS = ("gauss_flat", "chunk_tile", "num_rendered", "dup_overflow",
              "tile_max")


def test_alignment_matches_jax():
    assert not {"GFTORF_FLAT_FWD_CHUNK", "GFTORF_FLAT_BWD_CHUNK"} & set(os.environ)
    assert j_flat.FLAT_ALIGN == 256 == FLAT_ALIGN
    for cap, T in ((1, 1), (2880, 12), (1_572_864, 150)):
        assert flat_stream_capacity(cap, T) == j_flat.flat_stream_capacity(cap, T)
    assert flat_stream_capacity(1_572_864, 150) == 1_611_264


def _preprocessed(seed, n, tile_w):
    """(rect, depth_view, valid) of a JAX-preprocessed scene, and its config
    kwargs; a few points culled (behind the camera, zero opacity)."""
    a = scene_arrays(seed, n)
    a["xyz"][:3, 2] = -1.0
    opac = 1.0 / (1.0 + np.exp(-a["opacity"][:, 0]))
    opac[3:5] = 0.0
    kw = dict(height=H, width=W, tile_h=16, tile_w=tile_w)
    jcam, _ = cameras(W, H, seed=seed, jitter=0.05)
    pre = j_pre(
        jnp.asarray(a["xyz"]), jnp.exp(jnp.asarray(a["scaling"])),
        jnp.asarray(a["rotation"]), jnp.asarray(opac.astype(np.float32)),
        jnp.asarray(a["sh_color"]),
        jnp.stack([jnp.asarray(a["sh_phase"]), jnp.asarray(a["sh_amp"])], -1),
        np.float32(0.05), np.float32(0.02), jnp.zeros((n, 2)), jcam,
        JConfig(**kw), 3)
    return (np.asarray(pre.rect), np.asarray(pre.depth_view),
            np.asarray(pre.valid)), kw


def _synthetic(seed, n, tile_w, deep=0, empty_cols=0):
    """Synthetic rects over the tile grid: rects of 1-3 tiles a side, depths
    with ties, a tenth invalid; the last ``empty_cols`` tile columns left
    empty; ``deep`` more Gaussians on tile (1, 1) alone."""
    kw = dict(height=H, width=W, tile_h=16, tile_w=tile_w)
    cfg = TConfig(**kw)
    gw, gh = cfg.grid_w - empty_cols, cfg.grid_h
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, gw, n)
    y0 = rng.integers(0, gh, n)
    x1 = np.minimum(x0 + rng.integers(1, 4, n), gw)
    y1 = np.minimum(y0 + rng.integers(1, 4, n), gh)
    rect = np.stack([x0, y0, x1, y1], -1)
    depth = rng.integers(1, 40, n).astype(np.float32) / 4.0  # many ties
    valid = rng.uniform(size=n) > 0.1
    if deep:
        rect = np.concatenate([rect, np.tile([[1, 1, 2, 2]], (deep, 1))])
        depth = np.concatenate([depth, rng.uniform(1, 9, deep).astype(np.float32)])
        valid = np.concatenate([valid, np.ones(deep, bool)])
    return (rect.astype(np.int32), depth, valid), kw


CASES = {
    # source, n, tile_w, capacity (0: dup_factor * P), extra
    "scene_16x16": ("scene", 300, 16, 0, {}),
    "scene_16x32": ("scene", 300, 32, 0, {}),
    "empty_tiles": ("synthetic", 80, 16, 0, dict(empty_cols=2)),
    "deep_tile": ("synthetic", 60, 32, 0, dict(deep=700)),
    "dup_overflow": ("scene", 300, 16, 400, {}),
}


def _bin_both(case):
    source, n, tile_w, capacity, extra = CASES[case]
    seed = sorted(CASES).index(case)
    if source == "scene":
        (rect, depth, valid), kw = _preprocessed(seed, n, tile_w)
    else:
        (rect, depth, valid), kw = _synthetic(seed, n, tile_w, **extra)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, flat_stream=True)
    capacity = capacity or jcfg.capacity_for(rect.shape[0])
    jb = j_bin_flat(jnp.asarray(rect), jnp.asarray(depth), jnp.asarray(valid),
                    jcfg, capacity)
    tb = t_bin_flat(torch.tensor(rect), torch.tensor(depth), torch.tensor(valid),
                    tcfg, capacity)
    return jb, tb, tcfg, (rect, depth, valid), capacity


@pytest.mark.parametrize("case", list(CASES))
def test_flat_binning_matches_jax_exactly(case):
    jb, tb, cfg, (rect, _, valid), capacity = _bin_both(case)
    for name in JAX_FIELDS:
        port, ref = getattr(tb, name), np.asarray(getattr(jb, name))
        np.testing.assert_array_equal(port.numpy(), ref, name)
        assert port.numpy().dtype == ref.dtype, name
    assert tb.tile_start.dtype == tb.tile_count.dtype == torch.int32

    # tile_start / tile_count describe the JAX layout.
    gf = np.asarray(jb.gauss_flat)
    ct = np.asarray(jb.chunk_tile)
    start, count = tb.tile_start.numpy(), tb.tile_count.numpy()
    assert (start % FLAT_ALIGN == 0).all()
    assert int(count.max()) == int(jb.tile_max)
    in_tile = np.zeros(gf.shape, bool)
    for t in range(cfg.num_tiles):
        rows = gf[start[t]:start[t] + count[t]]
        assert (rows >= 0).all(), t
        in_tile[start[t]:start[t] + count[t]] = True
        blocks = np.nonzero(ct == t)[0]
        n_blocks = max(1, -(-count[t] // FLAT_ALIGN))
        assert blocks[0] * FLAT_ALIGN == start[t], t
        if t < cfg.num_tiles - 1:  # tail blocks also map to the last tile
            assert len(blocks) == n_blocks, t
        assert len(np.unique(rows)) == count[t], t  # a Gaussian once per tile
    assert not (gf[~in_tile] >= 0).any()  # every other row is padding
    assert int(count.sum()) == min(int(jb.num_rendered), capacity)

    if case == "empty_tiles":
        empty = (count == 0).nonzero()[0]
        assert len(empty) >= cfg.grid_h * 2
        assert (ct[start[empty] // FLAT_ALIGN] == empty).all()
    if case == "deep_tile":
        assert int(count.max()) > 2 * FLAT_ALIGN
    if case == "dup_overflow":
        assert bool(tb.dup_overflow) and int(tb.num_rendered) > capacity


def test_flat_binning_layout():
    """test_flat_stream.py's structural invariants on the port's stream:
    segments start at FLAT_ALIGN multiples, every non-padding id is in a
    block of its own tile and belongs to that tile's rect, ids are
    depth-ordered within a tile, chunk_tile is monotone."""
    jb, tb, cfg, (rect, depth, _), capacity = _bin_both("scene_16x16")
    K_pad = flat_stream_capacity(capacity, cfg.num_tiles)
    gf, ct = tb.gauss_flat.numpy(), tb.chunk_tile.numpy()
    assert gf.shape == (K_pad,) and ct.shape == (K_pad // FLAT_ALIGN,)
    assert (np.diff(ct) >= 0).all()
    assert (gf >= 0).sum() == int(tb.num_rendered)
    for b in range(len(ct)):
        ids = gf[b * FLAT_ALIGN:(b + 1) * FLAT_ALIGN]
        ids = ids[ids >= 0]
        tx, ty = ct[b] % cfg.grid_w, ct[b] // cfg.grid_w
        for i in ids:
            x0, y0, x1, y1 = rect[i]
            assert x0 <= tx < x1 and y0 <= ty < y1, (b, i)
    for t in np.unique(ct):
        ids = np.concatenate([gf[b * FLAT_ALIGN:(b + 1) * FLAT_ALIGN]
                              for b in np.nonzero(ct == t)[0]])
        d = depth[ids[ids >= 0]]
        assert (np.diff(d) >= -1e-6).all(), t
