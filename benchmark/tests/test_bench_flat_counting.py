"""The flat compositing pair's work, counted as the dense pair's is: by
``traffic/peaks.py::flat_work_of`` over the stream's instances, kept and
counted by ``harness/trace.py::CompositeCalls``, and taken into the
traced window's ``*.mfu`` where the flat path runs."""

import time

import torch

from conftest import small_cell
from harness import train
from harness.trace import CompositeCalls
from traffic import peaks

C = 24
CPU = torch.device("cpu")


def _tiles(counts, L=8, seed=0):
    """Two 16x16 tiles side by side, ``counts`` Gaussians each, in a dense
    (2, L, 24) block and in a flat stream with each tile's segment at a
    multiple of 256 and padding between."""
    from gftorf_tpu_torch.render.settings import RasterConfig

    cfg = RasterConfig(height=16, width=32, tile_h=16, tile_w=16)
    g = torch.Generator().manual_seed(seed)
    T = len(counts)
    feat = torch.rand((T, L, C), generator=g)
    origins = torch.tensor([[16 * t, 0] for t in range(T)], dtype=torch.int32)
    feat[..., 0] = origins[:, None, 0] + 16 * feat[..., 0]
    feat[..., 1] = 16 * feat[..., 1]
    feat[..., 2] = 0.05 + 0.2 * feat[..., 2]  # conic a
    feat[..., 3] = 0.02 * (feat[..., 3] - 0.5)  # conic b
    feat[..., 4] = 0.05 + 0.2 * feat[..., 4]  # conic c
    counts = torch.tensor(counts, dtype=torch.int32)
    lane = torch.arange(L)
    feat[lane >= counts[:, None].long()] = 0.0
    start = torch.arange(T, dtype=torch.int32) * 256
    stream = torch.zeros((256 * (T + 1), C))
    for t in range(T):
        stream[int(start[t]):int(start[t]) + int(counts[t])] = feat[t, :counts[t]]
    bg = torch.zeros((T, cfg.tile_pixels, 12))
    return cfg, feat, counts, origins, stream, start, bg


def test_flat_work_counts_the_streams_instances():
    cfg, feat, counts, origins, stream, start, _ = _tiles([5, 3])
    contrib = torch.tensor([[7, 4, 2, 1, 1, 0, 0, 0], [3, 2, 1, 0, 0, 0, 0, 0]])
    flat_contrib = torch.zeros(stream.shape[0], dtype=torch.int64)
    flat_contrib[:5], flat_contrib[256:259] = contrib[0, :5], contrib[1, :3]
    T, L = feat.shape[:2]
    for backward in (False, True):
        d_bytes, d_ops = peaks.work_of(feat, counts, origins, cfg, contrib,
                                       backward=backward, has_flow=True)
        f_bytes, f_ops = peaks.flat_work_of(stream, start, counts, origins, cfg,
                                            flat_contrib, backward=backward,
                                            has_flow=True)
        assert f_ops == d_ops > 0
        # The dense call writes every lane of the (T, L) block, the flat one
        # its 8 instances, and reads tile_start beside the counts.
        per_row = C if backward else 1
        assert d_bytes - f_bytes == 4 * (per_row * (T * L - 8) - T)


def test_composite_calls_count_the_flat_pair():
    from gftorf_tpu_torch.render.kernels import dense, flat

    cfg, feat, counts, origins, stream, start, bg = _tiles([5, 3])
    calls = CompositeCalls(dense, flat)
    calls.install()
    try:
        for layout, block in (("dense", feat), ("flat", stream)):
            x = block.clone().requires_grad_(True)
            if layout == "dense":
                out, _ = dense.DenseComposite.apply(x, bg, counts, origins, cfg,
                                                    True)
            else:
                out, _ = flat.FlatComposite.apply(x, bg, start, counts, origins,
                                                  cfg, True)
            out.sum().backward()
    finally:
        calls.uninstall()
    assert calls.n == {"forward": 1, "backward": 1, "flat_forward": 1,
                       "flat_backward": 1}
    work = calls.work()
    for kind in ("forward", "backward"):
        (_, d_ops, d_kept), (_, f_ops, f_kept) = work[kind], work["flat_" + kind]
        assert d_kept == f_kept == 1 and f_ops == d_ops > 0


def test_traced_window_counts_the_flat_path(scene_cache):
    cell = small_cell("ftorf.train.densify")
    cell = cell._replace(config=dict(cell.config, flat_stream=True))
    r = train.run(cell, 2**31 + 91, 0.5, True, CPU, time.perf_counter(),
                  cache=scene_cache)
    reading = r["reading"]
    n = int(cell.traffic["trace_iterations"])
    assert reading.calls["forward"] == reading.calls["backward"] == 0
    assert reading.calls["flat_forward"] == reading.calls["flat_backward"] == n
    ops = reading.deform_ops
    for kind in ("flat_forward", "flat_backward"):
        _, o, kept = reading.composite[kind]
        assert kept == min(n, 4) and o > 0
        ops += o / kept * n
    assert reading.counted_ops() == ops > reading.deform_ops
    assert reading.roofline("forward") is None
