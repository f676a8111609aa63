"""``gftorf_tpu_torch/utils/resize.py`` against ``cv2.resize``.

The JAX package resizes captures with cv2 (``readers.scale_image``,
``scene._resize_to``); the port does it in numpy. INTER_AREA and
INTER_NEAREST on 1-4 channel float32 images (and (H, W), (H, W, 1) and
float64 ones), at even and odd sizes, at the scale factors 1/2 (the
shipped ``color_scale_factor``), 0.4, 0.75, 0.3, 1/4 and the upscales 2
and 1.5, and at explicit output sizes as ``_resize_to`` asks for them.

Where the input is exactly twice the output OpenCV takes its 2x2 fast
path, whose summation order depends on the channel count; there the
results must be bitwise equal (a one-ulp difference flips a pixel in the
readers' uint8 round trip). Everywhere else the contract is atol
``2e-7 * max|x|``; the module reproduces OpenCV's weights and summation
order, so these tests hold every case bitwise as well and report the
largest difference when one is not.
"""

import cv2
import numpy as np
import pytest

from gftorf_tpu_torch.utils.resize import output_size, resize

SCALES = [0.5, 0.4, 0.75, 0.3, 0.25, 2.0, 1.5]
CHANNELS = [None, 1, 2, 3, 4]  # None: an (H, W) image
SIZES = [(48, 64), (33, 41), (31, 18)]
ATOL_FRAC = 2e-7


def image(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * rng.choice([1.0, 37.5])).astype(dtype)


def shape_of(size, channels):
    return size if channels is None else size + (channels,)


def assert_matches_cv2(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    atol = ATOL_FRAC * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    diff = np.abs(got.astype(np.float64) - want).max()
    assert diff == 0, f"within tolerance but not bitwise: max diff {diff:.3g}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", CHANNELS, ids=lambda c: f"c{c}")
@pytest.mark.parametrize("scale", SCALES)
def test_area_matches_cv2(scale, channels, size):
    img = image(shape_of(size, channels),
                seed=int(scale * 100) * 1000 + (channels or 0) * 100 + size[0])
    want = cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
    got = resize(img, fx=scale, fy=scale)
    exact = scale == 0.5 and size[0] % 2 == 0 and size[1] % 2 == 0
    assert_matches_cv2(got, want, exact)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [None, 1, 3], ids=lambda c: f"c{c}")
@pytest.mark.parametrize("scale", SCALES)
def test_nearest_matches_cv2(scale, channels, size):
    img = image(shape_of(size, channels), seed=7)
    want = cv2.resize(img, None, fx=scale, fy=scale,
                      interpolation=cv2.INTER_NEAREST)
    assert_matches_cv2(resize(img, fx=scale, fy=scale, nearest=True), want,
                       exact=True)


@pytest.mark.parametrize("dsize", [(32, 24), (40, 30), (128, 96), (50, 40),
                                   (64, 100), (21, 17)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("channels", [None, 2, 3], ids=lambda c: f"c{c}")
def test_area_to_size_matches_cv2(dsize, channels):
    """``_resize_to``'s call: an explicit (width, height), both axes'
    factors from it (one may shrink while the other grows)."""
    img = image(shape_of((48, 64), channels), seed=11)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
    exact = dsize == (32, 24)
    assert_matches_cv2(resize(img, dsize), want, exact)


@pytest.mark.parametrize("scale", [0.5, 0.4, 2.0])
@pytest.mark.parametrize("channels", [None, 3, 4], ids=lambda c: f"c{c}")
def test_float64_matches_cv2(scale, channels):
    img = image(shape_of((40, 32), channels), seed=5, dtype=np.float64)
    want = cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
    assert_matches_cv2(resize(img, fx=scale, fy=scale), want, exact=True)


def test_fast_path_sum_orders():
    """The 2x2 means at the shipped 640x480 x 0.5: 1 and 4 channels add
    (a + b) + (c + d), 2 and 3 channels ((a + b) + c) + d, times 0.25f;
    the orders differ on some pixels, and cv2 follows them exactly."""
    for channels, pairs in ((1, True), (2, False), (3, False), (4, True)):
        img = image((480, 640, channels), seed=channels)
        a, b = img[0::2, 0::2], img[0::2, 1::2]
        c, d = img[1::2, 0::2], img[1::2, 1::2]
        paired = ((a + b) + (c + d)) * np.float32(0.25)
        serial = (((a + b) + c) + d) * np.float32(0.25)
        assert (paired != serial).any()
        want = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
        want = want.reshape(paired.shape)
        np.testing.assert_array_equal(want, paired if pairs else serial)
        got = resize(img, fx=0.5, fy=0.5).reshape(paired.shape)
        np.testing.assert_array_equal(got, want)


def test_one_channel_row_tail_takes_the_scalar_order():
    """One channel: the SIMD loop covers 4 output columns at a time; the
    columns past the last group of four take the scalar order."""
    img = image((400, 14), seed=3)  # 7 output columns: 4 paired, 3 serial
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    want = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(want[:, :4],
                                  (((a + b) + (c + d)) * np.float32(0.25))[:, :4])
    np.testing.assert_array_equal(want[:, 4:],
                                  ((((a + b) + c) + d) * np.float32(0.25))[:, 4:])
    np.testing.assert_array_equal(resize(img, fx=0.5, fy=0.5), want)


def test_sizes_shapes_and_refusals():
    # saturate_cast<int> rounds half to even: 33 * 0.5 -> 16, 31 * 0.5 -> 16
    assert [output_size(n, 0.5) for n in (33, 31, 35, 480)] == [16, 16, 18, 240]
    img = image((8, 10, 1), seed=0)
    for nearest, interp in ((False, cv2.INTER_AREA), (True, cv2.INTER_NEAREST)):
        want = cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=interp)
        got = resize(img, fx=0.5, fy=0.5, nearest=nearest)
        assert got.shape == want.shape == (4, 5)
    same = resize(img, (10, 8))
    assert same.shape == cv2.resize(img, (10, 8)).shape == (8, 10)
    labels = np.arange(80, dtype=np.int32).reshape(8, 10)
    np.testing.assert_array_equal(
        resize(labels, fx=0.4, fy=0.4, nearest=True),
        cv2.resize(labels, None, fx=0.4, fy=0.4, interpolation=cv2.INTER_NEAREST))
    with pytest.raises(TypeError, match="uint8"):
        resize(labels.astype(np.uint8), fx=0.5, fy=0.5)
    with pytest.raises(ValueError):
        resize(img)
