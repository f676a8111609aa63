"""``cv2.resize`` with ``INTER_AREA`` and ``INTER_NEAREST`` in numpy.

The readers shrink captures (``scale_image``) and ``build_frame`` brings
every map to the colour camera's size (``_resize_to``); the JAX package
calls OpenCV for both. This module gives the same numbers without it, by
following OpenCV's own rules (imgproc/src/resize.cpp), on float32 and
float64 images of any channel count (``INTER_NEAREST`` on any dtype):

- **Size.** With scale factors the output is ``saturate_cast<int>(n *
  scale)``, which rounds half to even; with ``dsize`` the factors are
  ``dsize / n``. An (H, W, 1) image comes back as (H, W), as from cv2.
- **Nearest.** Output pixel ``d`` takes input ``min(floor(d * (1 /
  scale)), n - 1)`` on each axis.
- **Area, integer factors** (``1 / scale`` within DBL_EPSILON of an
  integer on both axes, as at the shipped 640x480 x 0.5): the mean of
  each k x k block, summed in OpenCV's order: groups of four window
  samples (row-major) ``((a + b) + c) + d`` added to a running sum, then
  times ``float(1 / k^2)``. At k = 2 on float32 with 1 or 4 channels
  OpenCV's SIMD loop takes ``((a + b) + (c + d)) * 0.25f`` instead: for 4
  channels on every full block, for 1 channel on the first ``4 *
  floor(w / 4)`` output columns of a row (4 float lanes; the columns past
  them take the scalar order). Those orders were read off cv2 5.0.0 on
  x86-64 and are held bitwise by tests/test_torch_resize.py for 1-4
  channels. A window cut by the image's edge (an odd size rounded up) is
  the sum of its samples, row by row, as float32 over their count.
- **Area, other shrinking factors:** OpenCV's per-axis tables
  (``computeResizeAreaTab``: each output cell's overlap with the input
  pixels, slivers under 1e-3 dropped, float32 weights), summed along x
  tap by tap, then along y tap by tap, in the image's precision.
- **Area, enlarging** (a factor under 1 on either axis): OpenCV's linear
  branch with the area weights: ``sx = floor(d * scale)``, ``f = (d + 1) -
  (sx + 1) / scale`` (float32), ``f - floor(f)`` if positive else 0, the
  last column clamped with ``f = 0``, rows clamped at the edge; a row is
  ``s0 * (1 - f) + s1 * f`` along x, then the same along y.

No ``cv2`` is imported here.
"""

from __future__ import annotations

import numpy as np

_DBL_EPSILON = np.finfo(np.float64).eps
# The area tables drop an overlap thinner than this (computeResizeAreaTab).
_SLIVER = 1e-3
# float32 lanes of OpenCV's baseline SIMD width (128 bits) in the 2x loop.
_LANES = 4


def output_size(n: int, scale: float) -> int:
    """``saturate_cast<int>(n * scale)``: rounds half to even."""
    return int(np.rint(n * scale))


def resize(img, dsize=None, fx: float = 0.0, fy: float = 0.0,
           nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=INTER_NEAREST
    if nearest else INTER_AREA)``; ``dsize`` is (width, height)."""
    img = np.asarray(img)
    if img.ndim not in (2, 3):
        raise ValueError(f"resize: expected an (H, W) or (H, W, C) image, "
                         f"got shape {img.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    if dsize is None:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize: give dsize or positive fx and fy")
        out_w, out_h = output_size(w, fx), output_size(h, fy)
        inv_x, inv_y = float(fx), float(fy)
    else:
        out_w, out_h = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = out_w / w, out_h / h
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize: empty output size {out_w}x{out_h}")
    if (out_w, out_h) == (w, h):
        return img.copy()
    if nearest:
        return _nearest(img, inv_x, inv_y, out_w, out_h)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize: INTER_AREA is implemented for float32 and "
                        f"float64 images, not {img.dtype}")
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(np.rint(scale_x)), int(np.rint(scale_y))
        if (abs(scale_x - ix) < _DBL_EPSILON
                and abs(scale_y - iy) < _DBL_EPSILON):
            return _area_fast(img, ix, iy, out_w, out_h)
        return _area(img, scale_x, scale_y, out_w, out_h)
    return _area_linear(img, scale_x, scale_y, inv_x, inv_y, out_w, out_h)


def _nearest(img, inv_x, inv_y, out_w, out_h):
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / inv_x)), w - 1)
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / inv_y)), h - 1)
    return img[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


def _area_fast(img, ix, iy, out_w, out_h):
    """Integer factors: block means in OpenCV's summation order."""
    wt = img.dtype.type
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    cn = x.shape[2]
    out = np.empty((out_h, out_w, cn), img.dtype)
    full_h, full_w = min(h // iy, out_h), min(w // ix, out_w)

    # Full windows: samples k = (sy, sx), row-major, in groups of four.
    blocks = x[:full_h * iy, :full_w * ix].reshape(full_h, iy, full_w, ix, cn)
    samples = [blocks[:, sy, :, sx] for sy in range(iy) for sx in range(ix)]
    area = ix * iy
    total = np.zeros((full_h, full_w, cn), img.dtype)
    k = 0
    while k <= area - 4:
        total = total + (((samples[k] + samples[k + 1]) + samples[k + 2])
                         + samples[k + 3])
        k += 4
    for k in range(k, area):
        total = total + samples[k]
    mean = total * wt(np.float32(1.0 / area))
    if ix == 2 and iy == 2 and img.dtype == np.float32 and cn in (1, 4):
        a, b, c, d = samples
        simd = ((a + b) + (c + d)) * np.float32(0.25)
        cols = full_w if cn == 4 else (full_w // _LANES) * _LANES
        mean[:, :cols] = simd[:, :cols]
    out[:full_h, :full_w] = mean

    # Windows cut by the right or bottom edge: sample sums over counts.
    for dy in range(out_h):
        cols = range(full_w, out_w) if dy < full_h else range(out_w)
        for dx in cols:
            win = x[dy * iy:dy * iy + iy, dx * ix:dx * ix + ix]
            acc = np.zeros(cn, img.dtype)
            for row in win:
                for s in row:
                    acc = acc + s
            count = win.shape[0] * win.shape[1]
            out[dy, dx] = acc.astype(np.float32) / np.float32(count)
    return out.reshape(out.shape[:2] + img.shape[2:])


def _area_table(n_in, n_out, scale):
    """``computeResizeAreaTab``: (n_out, taps) source indices and float32
    weights, padded with weight 0 and marked in ``valid``."""
    rows = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > _SLIVER:
            taps.append((s1 - 1, np.float32((s1 - f1) / cell)))
        taps += [(s, np.float32(1.0 / cell)) for s in range(s1, s2)]
        if f2 - s2 > _SLIVER:
            taps.append((s2, np.float32(min(min(f2 - s2, 1.0), cell) / cell)))
        rows.append(taps)
    n_taps = max(len(t) for t in rows)
    index = np.zeros((n_out, n_taps), np.int64)
    weight = np.zeros((n_out, n_taps), np.float32)
    valid = np.zeros((n_out, n_taps), bool)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            index[d, k], weight[d, k], valid[d, k] = s, a, True
    return index, weight, valid


def _weighted_taps(x, axis, index, weight, valid):
    """Sum of ``x[..., index[d, k], ...] * weight[d, k]`` over taps k, one
    tap at a time, in x's precision (OpenCV's accumulation order)."""
    shape = [1] * x.ndim
    shape[axis] = index.shape[0]
    acc = np.zeros(x.shape[:axis] + (index.shape[0],) + x.shape[axis + 1:],
                   x.dtype)
    for k in range(index.shape[1]):
        term = np.take(x, index[:, k], axis=axis) * weight[:, k].astype(
            x.dtype).reshape(shape)
        acc = np.where(valid[:, k].reshape(shape), acc + term, acc)
    return acc


def _area(img, scale_x, scale_y, out_w, out_h):
    """Non-integer shrinking: OpenCV's area tables, x then y."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    rows = _weighted_taps(x, 1, *_area_table(w, out_w, scale_x))
    out = _weighted_taps(rows, 0, *_area_table(h, out_h, scale_y))
    return out.reshape(out.shape[:2] + img.shape[2:])


def _linear_axis(n_in, n_out, scale, inv_scale, clamp):
    """Source index and float32 weight of the area-mode linear branch."""
    src = np.zeros(n_out, np.int64)
    frac = np.zeros(n_out, np.float32)
    for d in range(n_out):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if clamp and s >= n_in - 1:
            s, f = n_in - 1, np.float32(0.0)
        src[d], frac[d] = s, f
    return src, frac


def _area_linear(img, scale_x, scale_y, inv_x, inv_y, out_w, out_h):
    """Enlarging with INTER_AREA: OpenCV's linear branch, area weights."""
    wt = img.dtype.type
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    sx, fx = _linear_axis(w, out_w, scale_x, inv_x, clamp=True)
    a0 = (np.float32(1.0) - fx).astype(img.dtype)[None, :, None]
    a1 = fx.astype(img.dtype)[None, :, None]
    # Columns from the first whose right neighbour is outside copy their
    # source pixel (HResizeLinear's tail past xmax).
    edge = np.nonzero(sx + 1 >= w)[0]
    xmax = int(edge[0]) if edge.size else out_w
    right = np.minimum(sx + 1, w - 1)
    rows = x[:, sx] * a0 + x[:, right] * a1
    rows[:, xmax:] = x[:, sx[xmax:]]
    sy, fy = _linear_axis(h, out_h, scale_y, inv_y, clamp=False)
    b0 = (np.float32(1.0) - fy).astype(img.dtype)[:, None, None]
    b1 = fy.astype(img.dtype)[:, None, None]
    top, below = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    out = (rows[top] * b0 + rows[below] * b1).astype(wt)
    return out.reshape(out.shape[:2] + img.shape[2:])
