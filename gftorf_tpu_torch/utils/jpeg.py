"""Baseline JPEG decoding in numpy, as ``np.asarray(PIL.Image.open(path))``.

The port reads COLMAP captures, which are mostly JPEG, on machines without
PIL. ``read_jpeg`` returns what PIL returns there: ``(H, W, 3)`` uint8 for
a YCbCr image and ``(H, W)`` for a greyscale one, bitwise, by following
libjpeg-turbo's default decode path (the library Pillow links):

- Huffman decoding (``jdhuff.c``) with byte stuffing, fill bytes and
  restart intervals (DRI, RSTn); sequential scans, interleaved or not;
- dequantisation and the accurate integer IDCT (``jidctint.c``,
  JDCT_ISLOW, the default), with its post-IDCT range limit, which wraps
  modulo 1024 as libjpeg's table does;
- "fancy" chroma upsampling (``jdsample.c``): the triangle filters h2v1
  (4:2:2) and h2v2 (4:2:0) on the component's own samples, the rows above
  the first and below the last real row replicated as ``jdmainct.c``
  does; a component 1 or 2 samples wide is replicated, as libjpeg does;
- the fixed-point YCbCr -> RGB of ``jdcolor.c`` (16 fraction bits).

Everything after the Huffman walk runs vectorised over all blocks at once;
only the walk is a Python loop (bit windows of 16 bits precomputed per
chunk of the entropy-coded data, Huffman codes looked up in 65,536-entry
tables).

Supported: SOF0 and SOF1 with 8-bit samples, greyscale or three YCbCr
components at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2), any APPn/COM segments
(JFIF, EXIF). Anything else (progressive SOF2, lossless, arithmetic
coding, 12-bit samples, CMYK, an Adobe RGB transform, other sampling)
raises a ``ValueError`` that names the file.
"""

from __future__ import annotations

import re

import numpy as np

# Zigzag position -> natural (row-major) index (jutils.c jpeg_natural_order).
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

SOF_NAMES = {
    0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
    0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}
SUPPORTED_SOF = (0xC0, 0xC1)
# Chroma sampling ratios (luma / chroma, horizontal and vertical) decoded.
RATIOS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}

# Bytes of entropy-coded data turned into 16-bit windows at a time, and the
# most bits one block can take (a 27-bit DC and 63 26-bit ACs), so a block
# never runs past the windows it starts in (63 AC symbols and an EOB).
CHUNK_BYTES = 1 << 15
MAX_BLOCK_BITS = 27 + 64 * 26

_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def is_jpeg(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\xff\xd8"


def read_jpeg(path: str) -> np.ndarray:
    """Decode the baseline JPEG at ``path``; raises a ValueError naming the
    file for anything outside the supported subset (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_jpeg(data)
    except (ValueError, IndexError) as e:
        raise ValueError(f"{path}: {e}") from e


class _Frame:
    """What the SOF, DQT, DHT and DRI segments set up."""

    def __init__(self):
        self.qt = {}          # table id -> (64,) int64, natural order
        self.dc, self.ac = {}, {}   # table id -> 65,536-entry lookup list
        self.restart = 0
        self.adobe_transform = None
        self.sof = None       # (height, width, [(id, h, v, tq)])
        self.mcus = None      # (rows, columns) of interleaved MCUs
        self.coefs = None     # per component, (by, bx, 64) int32, zigzag


def decode_jpeg(data: bytes) -> np.ndarray:
    """``read_jpeg`` on the bytes of a file."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    fr = _Frame()
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                      # garbage before a marker
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1                      # fill bytes
        if pos >= len(data):
            raise ValueError("truncated JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                      # stray RSTn / TEM: no length
        length = int.from_bytes(data[pos:pos + 2], "big")
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError("truncated JPEG segment")
        pos += length
        if marker == 0xDB:
            _read_dqt(fr, seg)
        elif marker == 0xC4:
            _read_dht(fr, seg)
        elif marker == 0xDD:
            fr.restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            fr.adobe_transform = seg[11]
        elif marker in SOF_NAMES:
            _read_sof(fr, marker, seg)
        elif marker == 0xDA:
            pos = _read_scan(fr, seg, data, pos)
        elif marker in (0xC8, 0xCC):
            raise ValueError("arithmetic coding is not supported")
        elif marker == 0xDC:
            raise ValueError("a DNL marker (height defined after the scan) is "
                             "not supported")
    if fr.coefs is None:
        raise ValueError("no scan in the JPEG")
    return _reconstruct(fr)


def _read_dqt(fr, seg):
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 128 if pq else 64
        vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else "u1")
        if vals.size != 64:
            raise ValueError("truncated quantisation table")
        q = np.zeros(64, np.int64)
        q[NATURAL_ORDER] = vals
        fr.qt[tq] = q
        i += 1 + n


def _huffman_lookup(counts, symbols):
    """A list indexed by the next 16 bits of the stream: (code length << 8)
    | symbol for the code those bits start with, 0 for no code."""
    lengths = np.repeat(np.arange(1, 17), counts)
    codes = np.zeros(len(symbols), np.int64)
    code = 0
    k = 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            codes[k] = code
            code += 1
            k += 1
        if code > (1 << n_bits):
            raise ValueError("bad Huffman table")
        code <<= 1
    table = np.zeros(1 << 16, np.int64)
    span = 1 << (16 - lengths)
    first = np.repeat(np.cumsum(span) - span, span)
    idx = np.repeat(codes << (16 - lengths), span) + np.arange(span.sum()) - first
    table[idx] = np.repeat((lengths << 8) | np.asarray(symbols, np.int64), span)
    return table.tolist()


def _read_dht(fr, seg):
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = list(seg[i + 1:i + 17])
        n = sum(counts)
        symbols = list(seg[i + 17:i + 17 + n])
        if len(counts) != 16 or len(symbols) != n:
            raise ValueError("truncated Huffman table")
        (fr.ac if tc else fr.dc)[th] = _huffman_lookup(counts, symbols)
        i += 17 + n


def _read_sof(fr, marker, seg):
    if marker not in SUPPORTED_SOF:
        raise ValueError(f"{SOF_NAMES[marker]} JPEG (SOF{marker - 0xC0}) is "
                         "not supported: only baseline and extended sequential "
                         "Huffman JPEG decode without PIL")
    if fr.sof is not None:
        raise ValueError("more than one frame")
    precision, height, width, nc = seg[0], *np.frombuffer(seg[1:5], ">u2"), seg[5]
    if precision != 8:
        raise ValueError(f"{precision}-bit samples are not supported")
    if height == 0:
        raise ValueError("a DNL marker (height defined after the scan) is not "
                         "supported")
    comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
              seg[8 + 3 * k]) for k in range(nc)]
    if nc not in (1, 3):
        raise ValueError(f"{nc} components (CMYK?) are not supported")
    fr.sof = (int(height), int(width), comps)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    fr.mcus = (-(-int(height) // (8 * vmax)), -(-int(width) // (8 * hmax)))
    fr.coefs = [np.zeros((fr.mcus[0] * v, fr.mcus[1] * h, 64), np.int32)
                for _, h, v, _ in comps]


def _read_scan(fr, seg, data, pos):
    """Decode one scan's entropy-coded data; returns the position of the
    marker that ends it."""
    if fr.sof is None:
        raise ValueError("scan before the frame header")
    height, width, comps = fr.sof
    ns = seg[0]
    ids = [c[0] for c in comps]
    sel = [(ids.index(seg[1 + 2 * k]), seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15)
           for k in range(ns)]
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError("a progressive scan is not supported")
    end = _SCAN_END.search(data, pos)
    end = end.start() if end else len(data)
    segments = [s.replace(b"\xff\x00", b"\xff")
                for s in _RST.split(data[pos:end])]

    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    # The blocks of one MCU: (component, block row, block col) offsets, and
    # the grid of MCUs.
    if ns == 1:
        ci = sel[0][0]
        _, h, v, _ = comps[ci]
        cw = -(-width * h // hmax)
        ch = -(-height * v // vmax)
        grid = (-(-ch // 8), -(-cw // 8))
        layout = [(0, 0, 0)]
    else:
        grid = fr.mcus
        layout = [(k, r, c) for k, (ci, _, _) in enumerate(sel)
                  for r in range(comps[ci][2]) for c in range(comps[ci][1])]
    my, mx = np.divmod(np.arange(grid[0] * grid[1]), grid[1])
    # Flat offsets into each component's coefficient array, per block slot.
    bases = []
    for k, r, c in layout:
        ci = sel[k][0]
        _, h, v, _ = comps[ci]
        if ns == 1:
            h = v = 1
        bx = fr.coefs[ci].shape[1]
        bases.append(((my * v + r) * bx + mx * h + c) * 64)
    bases = np.stack(bases, 1).tolist() if bases else []
    tables = [(sel[k][0], fr.dc[sel[k][1]], fr.ac[sel[k][2]])
              for k, _, _ in layout]
    flat = [[0] * c.size for c in fr.coefs]
    ri = fr.restart or len(bases)
    for s_i, m0 in enumerate(range(0, len(bases), ri)):
        if s_i >= len(segments):
            raise ValueError("the scan ends before its last restart interval")
        _decode_interval(segments[s_i], bases[m0:m0 + ri], tables, flat,
                         len(comps))
    for ci, f in enumerate(flat):
        f = np.array(f, np.int32).reshape(fr.coefs[ci].shape)
        fr.coefs[ci] = np.where(f != 0, f, fr.coefs[ci])
    return end


def _windows(seg: bytes, byte0: int) -> list:
    """For every bit position p from byte ``byte0`` on (CHUNK_BYTES bytes),
    the 16 bits of the stream starting there (zeros past the end)."""
    b = np.frombuffer(seg[byte0:byte0 + CHUNK_BYTES + 4], np.uint8).astype(np.int64)
    b = np.concatenate([b, np.zeros(4, np.int64)])
    x24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return ((x24[:, None] >> (8 - np.arange(8))) & 0xFFFF).reshape(-1).tolist()


def _decode_interval(seg, bases, tables, flat, ncomp):
    """Huffman-decode the MCUs of one restart interval (``bases``: each
    MCU's block offsets) into ``flat`` (each component's coefficients in
    zigzag order per block)."""
    pred = [0] * ncomp
    byte0 = 0
    w = _windows(seg, 0)
    lim = 8 * CHUNK_BYTES - MAX_BLOCK_BITS
    p = 0
    half = [0] + [1 << (s - 1) for s in range(1, 17)]
    full = [0] + [(1 << s) - 1 for s in range(1, 17)]
    for mcu in bases:
        for base, (ci, dct, act) in zip(mcu, tables):
            if p > lim:
                byte0 += p >> 3
                p &= 7
                w = _windows(seg, byte0)
            out = flat[ci]
            e = dct[w[p]]
            if not e:
                raise ValueError("corrupt entropy-coded data (bad DC code)")
            p += e >> 8
            s = e & 15
            if s:
                v = w[p] >> (16 - s)
                p += s
                if v < half[s]:
                    v -= full[s]
                pred[ci] += v
            out[base] = pred[ci]
            k = 1
            while k < 64:
                e = act[w[p]]
                if not e:
                    raise ValueError("corrupt entropy-coded data (bad AC code)")
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = w[p] >> (16 - s)
                    p += s
                    if v < half[s]:
                        v -= full[s]
                    out[base + k] = v
                    k += 1
                elif (e >> 4) & 15 == 15:
                    k += 16
                else:
                    break
            if k > 64:
                raise ValueError("corrupt entropy-coded data (run past the "
                                 "block)")
    if (byte0 << 3) + p > 8 * len(seg):
        raise ValueError("truncated entropy-coded data")


# ------------------------------------------------------------ jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
       "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
       "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
       "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x):
    """The islow butterflies on the 8 inputs ``x[0..7]`` (each an array);
    returns the 8 outputs before descaling."""
    f = FIX
    z1 = (x[2] + x[6]) * f["0_541196100"]
    tmp2 = z1 - x[6] * f["1_847759065"]
    tmp3 = z1 + x[2] * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * f["1_175875602"]
    tmp0 = tmp0 * f["0_298631336"]
    tmp1 = tmp1 * f["2_053119869"]
    tmp2 = tmp2 * f["3_072711026"]
    tmp3 = tmp3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (jdmaster.c prepare_range_limit_table),
    indexed by the centred sample & 1023."""
    v = np.arange(1024)
    x = np.where(v < 512, v, v - 1024)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _idct_range_table()


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` over (N, 64) natural-order coefficients with the
    (64,) quantisation table; returns (N, 8, 8) uint8 samples."""
    dq = (coefs.astype(np.int64) * qt).reshape(-1, 8, 8)
    # Pass 1: columns (rows of dq are vertical frequencies).
    ws = _idct_1d([dq[:, k, :] for k in range(8)])
    ws = np.stack([_descale(t, CONST_BITS - PASS1_BITS) for t in ws], 1)
    # Pass 2: rows.
    out = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(t, CONST_BITS + PASS1_BITS + 3) for t in out], 2)
    return _RANGE[out & 1023]


# ------------------------------------------------------------ jdsample.c
def _fancy_h2v1(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample on a (h, w) plane, w > 2: (h, 2w)."""
    x = x.astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample on a (h, w) plane, w > 2: (2h, 2w); the rows
    above the first and below the last are copies of them."""
    x = x.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for r, other in ((0, up), (1, down)):
        col = 3 * x + other
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
    return out.astype(np.uint8)


def upsample(x: np.ndarray, ratio: tuple) -> np.ndarray:
    """A chroma plane at its own (downsampled) size to the luma grid, as
    libjpeg's default (fancy) upsampler does."""
    if ratio == (1, 1):
        return x
    if x.shape[1] <= 2:       # jdsample.c: fancy needs more than 2 columns
        return np.repeat(np.repeat(x, ratio[1], 0), ratio[0], 1)
    return _fancy_h2v1(x) if ratio == (2, 1) else _fancy_h2v2(x)


# ------------------------------------------------------------- jdcolor.c
def _ycc_tables():
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """ycc_rgb_convert on uint8 planes: (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _reconstruct(fr) -> np.ndarray:
    height, width, comps = fr.sof
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for (cid, h, v, tq), coefs in zip(comps, fr.coefs):
        if tq not in fr.qt:
            raise ValueError(f"component {cid}: no quantisation table {tq}")
        by, bx, _ = coefs.shape
        nat = np.empty_like(coefs)
        nat[..., NATURAL_ORDER] = coefs
        blocks = idct_islow(nat.reshape(-1, 64), fr.qt[tq])
        plane = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
            8 * by, 8 * bx)
        planes.append(plane[:-(-height * v // vmax), :-(-width * h // hmax)])
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    if fr.adobe_transform == 0:
        raise ValueError("an Adobe RGB (untransformed) JPEG is not supported")
    if (comps[0][1], comps[0][2]) != (hmax, vmax):
        raise ValueError("luma is not the most finely sampled component")
    chroma = []
    for (_, h, v, _), plane in zip(comps[1:], planes[1:]):
        ratio = (hmax // h, vmax // v)
        if ratio not in RATIOS or (hmax % h, vmax % v) != (0, 0):
            raise ValueError(f"chroma sampling {h}x{v} of luma {hmax}x{vmax} "
                             f"is not supported (only "
                             f"{', '.join(RATIOS.values())})")
        chroma.append(upsample(plane, ratio)[:height, :width])
    return ycc_to_rgb(planes[0], *chroma)
