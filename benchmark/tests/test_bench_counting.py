"""The roofline and MFU counting functions on hand-worked tiny cases."""

from types import SimpleNamespace

import pytest
import torch

from traffic import peaks

C = 24


def _tile(opacity, l):
    """One 2x1-pixel tile, ``l`` instances centred on pixel 0 with a unit
    conic and opacity ``opacity``."""
    feat = torch.zeros(1, l, C)
    feat[0, :, 0] = 0.0  # x
    feat[0, :, 1] = 0.0  # y
    feat[0, :, 2] = 1.0  # conic a
    feat[0, :, 4] = 1.0  # conic c
    feat[0, :, 5] = opacity
    cfg = SimpleNamespace(tile_pixels=2, tile_w=2, width=2, height=1,
                          need_dd=False)
    counts = torch.tensor([l], dtype=torch.int32)
    origins = torch.zeros(1, 2, dtype=torch.int64)
    return feat, counts, origins, cfg


def test_forward_without_early_exit():
    # Pixel 0: alpha 0.5 twice; pixel 1 (dx = -1): 0.5 * exp(-0.5) twice.
    # No transmittance falls under 1e-4: 2 pairs a pixel, 4 in all.
    feat, counts, origins, cfg = _tile(0.5, 2)
    contrib = torch.tensor([[2, 2]])
    nbytes, ops = peaks.work_of(feat, counts, origins, cfg, contrib)
    assert ops == 16 * 4 + 41 * 4
    assert nbytes == 4 * (2 * C + 3 + 2 * (12 + 32) + 2)


def test_forward_stops_at_termination():
    # Pixel 0: alpha 0.95 five times; the transmittance (0.05, 2.5e-3,
    # 1.25e-4, 6.25e-6) passes 1e-4 at the fourth, so 4 pairs; pixel 1:
    # alpha 0.95 * exp(-0.5) = 0.576, 0.0137 after five, so 5. Rows: 5.
    feat, counts, origins, cfg = _tile(0.95, 5)
    contrib = torch.tensor([[2, 2, 2, 2, 1]])
    nbytes, ops = peaks.work_of(feat, counts, origins, cfg, contrib)
    assert ops == 16 * 9 + 41 * 9
    assert nbytes == 4 * (5 * C + 3 + 2 * (12 + 32) + 5)


def test_backward_counts_flow_and_gradient_rows():
    feat, counts, origins, cfg = _tile(0.5, 2)
    contrib = torch.tensor([[2, 2]])
    nbytes, ops = peaks.work_of(feat, counts, origins, cfg, contrib,
                                backward=True, has_flow=True)
    assert ops == 16 * 4 + (96 + 12) * 4
    assert nbytes == 4 * (2 * C + 3 + 2 * (12 + 32 + 32) + 2 * C)


def test_least_seconds_takes_the_binding_peak():
    assert peaks.least_seconds(3.35e12, 1) == pytest.approx(1.0)
    assert peaks.least_seconds(1, 67e12) == pytest.approx(1.0)


def test_deform_gemm_operations():
    ins, w, heads, rows = [84, 256], 256, [3, 16], 10
    fwd = 2 * rows * (84 * 256 + 256 * 256 + 256 * 3 + 256 * 16)
    assert peaks.deform_gemm_ops(ins, w, heads, rows, False) == fwd
    # Weight gradients of every layer, input gradients of all but the first.
    assert peaks.deform_gemm_ops(ins, w, heads, rows, True) == (
        3 * fwd - 2 * rows * 84 * 256)


def test_deform_widths_of_the_shipped_config():
    from harness import spec, state

    ins, heads = state.deform_widths(spec.load("ftorf.train.densify").config)
    assert ins == [84, 256, 256, 256, 256, 340, 256, 256]
    assert heads == {"xyz": 3, "rot": 4, "r": 16, "g": 16, "b": 16, "a": 16}
