"""The backward kernels' per-warp cull predicate (csrc/warp_cull.cuh).

``dense.warp_cull_plain`` is the predicate in PyTorch, formula for
formula; the kernels skip a row for a warp when it says the row is culled
for the warp's pixel rectangle (``dense.warp_rects``). Culling is exact
only if no culled (row, rectangle) pair has a pixel where the compositor's
alpha is valid: power <= 0 and min(0.99, o * exp(power)) >= 1/255
(gftorf_tpu/render/composite.py:94-98). The tests check that implication
by brute force over every pixel of every rectangle, with the alpha in
float32 in the kernels' order of operations and in float64; it has no
tolerance, since it is exact.

Rows come from chip_smoke.py's boundary cases (sigmas 0.3-300 px, rotated
conics, opacity from the float just above 1/255 to 0.99, rows whose 1/255
contour passes within 1e-3 px of a rectangle's edge pixel; tile_w 8, 16
and 32; ragged images) and from the JAX package's own preprocess of a
scene (tests/torch_port_util.py::packed_tile_inputs). A row whose cull
covers its whole tile is also shown to change no bit of the plain
backward when it is made invisible. The CUDA predicate runs on the card:
its test is marked ``gpu`` (chip_smoke.py runs the same checks at full
width).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gftorf_tpu_torch.render.kernels import dense
from torch_port_util import packed_tile_inputs

IMAGES = {
    # tile_w, width, height
    "tw8": (8, 64, 48),
    "tw16": (16, 64, 48),
    "tw32": (32, 96, 48),
    "ragged": (16, 60, 44),
}


def _cases(name, seed):
    tw, w, h = IMAGES[name]
    rows, rects, graze = cs.cull_cases(np.random.default_rng(seed), w, h, tw,
                                       n_random=300, n_graze=300)
    return torch.tensor(rows), torch.tensor(rects), torch.tensor(graze)


@pytest.mark.parametrize("name", list(IMAGES))
def test_culled_pairs_have_no_valid_pixel(name):
    rows, rects, _ = _cases(name, 1)
    cull = dense.warp_cull_plain(rows, rects)
    for exact in (False, True):
        valid = cs.any_valid(rows, rects, exact=exact)
        bad = torch.nonzero(cull & valid)
        assert bad.numel() == 0, (
            f"{len(bad)} culled pairs with a valid pixel (float64={exact}), "
            f"first {bad[:3].tolist()}")
    # The predicate is not vacuous: most random pairs are culled.
    assert float(cull[:300].float().mean()) > 0.5


@pytest.mark.parametrize("name", list(IMAGES))
def test_grazing_contours_are_kept(name):
    """A row whose exact 1/255 contour passes within 1e-3 px of an edge
    pixel of a rectangle is never culled for it (the box is widened by half
    a pixel), whether the pixel falls just inside or just outside."""
    rows, rects, graze = _cases(name, 2)
    cull = dense.warp_cull_plain(rows, rects)[graze[:, 0], graze[:, 1]]
    valid = cs.any_valid(rows, rects)[graze[:, 0], graze[:, 1]]
    assert not bool(cull.any())
    # Both sides of the contour are exercised.
    assert 0.2 < float(valid.float().mean()) < 0.8


def test_cases_span_the_stated_ranges():
    rows, rects, _ = _cases("tw16", 3)
    a, b, c, o = (rows[:, k].double() for k in (2, 3, 4, 5))
    det = a * c - b * b
    lam_max = (a + c) / 2 + torch.sqrt(((a - c) / 2) ** 2 + b * b)
    lam_min = det / lam_max
    sig = torch.cat([1 / torch.sqrt(lam_max), 1 / torch.sqrt(lam_min)])
    assert float(sig.min()) < 0.4 and float(sig.max()) > 200
    eps = np.float32(1.0 / 255.0)
    assert float(o.min()) == float(np.nextafter(eps, np.float32(1)))
    assert 0.9 < float(o.max()) <= 0.99
    assert float((b.abs() > 1e-3 * torch.sqrt(a * c)).float().mean()) > 0.9


@pytest.mark.parametrize("kind", ["nan_mean", "inf_conic", "nan_opacity",
                                  "a_not_positive", "det_not_positive",
                                  "too_elongated"])
def test_unsure_rows_are_never_culled(kind):
    """Rows with a non-finite mean, conic or opacity, a conic that is not
    positive definite, or one too elongated for the rounding bound, are
    kept for every rectangle (opacity above 1/255)."""
    _, rects, _ = _cases("tw16", 4)
    rows = torch.zeros((4, 24))
    rows[:, 0] = torch.tensor([-500.0, 10.0, 30.0, 2000.0])
    rows[:, 1] = torch.tensor([-500.0, 5.0, 20.0, 2000.0])
    rows[:, 2:6] = torch.tensor([4.0, 0.0, 4.0, 0.5])
    if kind == "nan_mean":
        rows[:, 0] = math.nan
    elif kind == "inf_conic":
        rows[:, 3] = math.inf
    elif kind == "nan_opacity":
        rows[:, 5] = math.nan
    elif kind == "a_not_positive":
        rows[:, 2] = torch.tensor([0.0, -1.0, -4.0, 0.0])
    elif kind == "det_not_positive":
        rows[:, 3] = torch.tensor([4.0, -4.0, 5.0, 100.0])  # det 0 or below
    else:  # sigmas 1e-3 and 1e3 px at 45 degrees: det' < 0
        i1, i2 = 1e6, 1e-6
        rows[:, 2:5] = torch.tensor([(i1 + i2) / 2, (i1 - i2) / 2, (i1 + i2) / 2])
    assert not bool(dense.warp_cull_plain(rows, rects).any())
    box = dense.warp_cull_boxes_plain(rows)
    assert torch.equal(box, box.new_tensor([[-math.inf, math.inf] * 2] * 4))


def test_faint_rows_are_culled_everywhere():
    _, rects, _ = _cases("tw16", 5)
    eps = np.float32(1.0 / 255.0)
    rows = torch.zeros((4, 24))
    rows[:, 0:2] = 20.0
    rows[:, 2:5] = torch.tensor([0.01, 0.0, 0.01])  # sigma 10 px
    rows[:, 5] = torch.tensor([float(np.nextafter(eps, np.float32(0))), 0.0,
                               -0.5, 1e-3])
    assert bool(dense.warp_cull_plain(rows, rects).all())
    assert not bool(cs.any_valid(rows, rects).any())


def test_far_rectangles_are_culled():
    """Small Gaussians (sigma <= 2 px) are culled for every rectangle whose
    nearest pixel is more than 30 px away: the 1/255 contour reaches at
    most 2 * sqrt(2 ln 255) = 6.7 px."""
    rng = np.random.default_rng(6)
    _, rects, _ = _cases("tw32", 6)
    a, b, c = cs.random_conics(rng, 500, 0.3, 2.0)
    rows = torch.zeros((500, 24))
    rows[:, 0] = torch.tensor(rng.uniform(-40, 140, 500))
    rows[:, 1] = torch.tensor(rng.uniform(-40, 90, 500))
    rows[:, 2:5] = torch.tensor(np.stack([a, b, c], -1))
    rows[:, 5] = 0.99
    r = rects[None]
    gap_x = torch.clamp(torch.maximum(r[..., 0] - rows[:, None, 0],
                                      rows[:, None, 0] - r[..., 1]), min=0)
    gap_y = torch.clamp(torch.maximum(r[..., 2] - rows[:, None, 1],
                                      rows[:, None, 1] - r[..., 3]), min=0)
    far = torch.maximum(gap_x, gap_y) > 30
    assert bool(far.any())
    assert bool(dense.warp_cull_plain(rows, rects)[far].all())


@pytest.mark.parametrize("tile_w,pix", [(8, 512), (16, 512), (32, 512),
                                        (16, 256), (24, 384)])
def test_warp_rects_hold_their_warps_pixels(tile_w, pix):
    """Each warp's rectangle holds its 32 pixels (pixel i of a tile at
    (i % tile_w, i // tile_w) from its corner, as the kernels map threads),
    and no more when tile_w divides 32 or 32 divides tile_w."""
    origins = torch.tensor([[0, 0], [48, 32], [96, 160]], dtype=torch.int32)
    rects = dense.warp_rects(origins, tile_w, pix)
    i = torch.arange(pix)
    px = origins[:, None, 0] + i % tile_w  # (T, pix)
    py = origins[:, None, 1] + i // tile_w
    w = i // 32
    r = rects[:, w]  # (T, pix, 4)
    assert bool(((px >= r[..., 0]) & (px <= r[..., 1])
                 & (py >= r[..., 2]) & (py <= r[..., 3])).all())
    area = (rects[..., 1] - rects[..., 0] + 1) * (rects[..., 3] - rects[..., 2] + 1)
    if 32 % tile_w == 0 or tile_w % 32 == 0:
        assert bool((area == 32).all())


@pytest.mark.parametrize("tile_w,pix", [(8, 512), (16, 512), (32, 512),
                                        (16, 256), (24, 384), (32, 1024),
                                        (12, 96)])
def test_forward_warps_hold_8x4_blocks(tile_w, pix):
    """The forward's map of threads to pixels (``warp_pixels(blocks=
    True)``, csrc/warp_cull.cuh::block_pixel) is a permutation of the
    tile's pixels; where both sides of the tile are multiples of 8 and 4,
    each warp's 32 pixels fill its 8x4 rectangle, else thread i holds
    pixel i."""
    p = dense.warp_pixels(tile_w, pix, blocks=True)
    assert torch.equal(torch.sort(p).values, torch.arange(pix))
    origins = torch.tensor([[0, 0], [48, 32]], dtype=torch.int32)
    rects = dense.warp_rects(origins, tile_w, pix, blocks=True)
    w = rects[..., 1] - rects[..., 0] + 1
    h = rects[..., 3] - rects[..., 2] + 1
    if tile_w % 8 == 0 and (pix // tile_w) % 4 == 0:
        assert bool(((w == 8) & (h == 4)).all())
    else:
        assert torch.equal(p, torch.arange(pix))
        assert torch.equal(rects, dense.warp_rects(origins, tile_w, pix))


def _tile_rows(case):
    w, h, tile_w = case
    d = packed_tile_inputs(3, n=240, tile_w=tile_w, width=w, height=h)
    feat = torch.tensor(d["feat_tl"])
    counts = torch.tensor(d["counts"])
    origins = torch.tensor(d["origins"])
    return d, feat, counts, origins


@pytest.mark.parametrize("case", [(64, 48, 16), (56, 40, 32)])
def test_culls_on_jax_preprocessed_rows(case):
    """Rows of a scene preprocessed and binned by the JAX package: every
    (row, warp) pair the predicate culls has no valid pixel in the warp's
    rectangle, and culling skips a good share of the pairs."""
    d, feat, counts, origins = _tile_rows(case)
    cfg = d["tcfg"]
    rects = dense.warp_rects(origins, cfg.tile_w, cfg.tile_pixels)
    culled = valid = 0
    for t in range(feat.shape[0]):
        rows = feat[t, : int(counts[t])]
        if rows.shape[0] == 0:
            continue
        cull = dense.warp_cull_plain(rows, rects[t])
        for exact in (False, True):
            hit = cs.any_valid(rows, rects[t], exact=exact)
            assert not bool((cull & hit).any()), (t, exact)
        culled += int(cull.sum())
        valid += cull.numel()
    assert culled > 0.2 * valid


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_whole_tile_cull_changes_no_bit_of_the_plain_backward(direction):
    """A row culled for every warp of its tile touches no pixel there: made
    invisible (opacity 0), the plain forward's output and contributing-pixel
    counts, or the plain backward's every other gradient row, keep their
    bits, and its own count or gradient row is zero either way."""
    d, feat, counts, origins = _tile_rows((64, 48, 16))
    cfg = d["tcfg"]
    bg = torch.tensor(d["bg_tiles"])
    rects = dense.warp_rects(origins, cfg.tile_w, cfg.tile_pixels)
    out, contrib = dense.composite_forward_plain(feat, bg, counts, origins, cfg)
    hidden = feat.clone()
    gone = torch.zeros(feat.shape[:2], dtype=torch.bool)
    for t in range(feat.shape[0]):
        n = int(counts[t])
        gone[t, :n] = dense.warp_cull_plain(feat[t, :n], rects[t]).all(-1)
    hidden[..., 5] = torch.where(gone, 0.0, feat[..., 5])
    assert int(gone.sum()) > 0
    if direction == "forward":
        got_out, got_contrib = dense.composite_forward_plain(hidden, bg, counts,
                                                             origins, cfg)
        assert torch.equal(got_out, out)
        assert torch.equal(got_contrib, contrib)
        assert not bool(contrib[gone].any())
        return
    g = torch.tensor(np.random.default_rng(9).uniform(
        -1, 1, out.shape).astype(np.float32))
    ref = dense.composite_backward_plain(feat, bg, out, g, counts, origins, cfg, True)
    got = dense.composite_backward_plain(hidden, bg, out, g, counts, origins, cfg, True)
    assert torch.equal(got, ref)
    assert not bool(ref[gone].any())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(IMAGES))
def test_cuda_predicate_matches_plain_on_card(cuda, name):
    rows, rects, _ = _cases(name, 7)
    rows, rects = rows.to(cuda), rects.to(cuda)
    got = dense.warp_cull_mask_cuda(rows, rects)
    assert torch.equal(got, dense.warp_cull_plain(rows, rects))
    assert not bool((got & cs.any_valid(rows, rects)).any())
