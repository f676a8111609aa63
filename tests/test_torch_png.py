"""``gftorf_tpu_torch/utils/image_io.py::read_png`` against PIL.

The COLMAP and Blender readers of the JAX package open their images with
PIL (``np.asarray(Image.open(p))``, and ``.convert("RGBA")`` for
Blender); the port decodes PNGs itself. Every 8-bit non-interlaced kind
is held bitwise against PIL: grey, RGB, palette, grey+alpha and RGBA,
with and without a ``tRNS`` chunk, each row filter alone and all five
mixed (files encoded here, so every filter is certain to occur), and the
PNGs PIL itself writes. Other PNGs raise a ValueError naming the file and
what it lacks.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gftorf_tpu_torch.utils import image_io

H, W = 11, 13
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(px, color, filters, palette=None, trns=None, depth=8,
               interlace=0):
    """A PNG of (H, W, C) uint8 samples, row r filtered with
    ``filters[r % len(filters)]``, its data split over two IDAT chunks
    after a tEXt chunk."""
    h, w, bpp = px.shape
    rows = px.reshape(h, w * bpp).astype(int)
    out = []
    for r in range(h):
        kind = filters[r % len(filters)]
        row, prev = rows[r], (rows[r - 1] if r else np.zeros_like(rows[r]))
        enc = []
        for i in range(w * bpp):
            a = row[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2, _paeth(a, prev[i], c))[kind]
            enc.append((row[i] - pred) & 0xFF)
        out.append(bytes([kind]) + bytes(enc))
    return assemble(b"".join(out), w, h, color, palette, trns, depth, interlace)


def assemble(raw, w, h, color, palette=None, trns=None, depth=8, interlace=0):
    comp = zlib.compress(raw)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                          interlace))
            + _chunk(b"tEXt", b"Comment\x00test"))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    half = len(comp) // 2
    return (data + _chunk(b"IDAT", comp[:half]) + _chunk(b"IDAT", comp[half:])
            + _chunk(b"IEND", b""))


def samples(color, with_trns, seed):
    """Pixels, palette and tRNS body of one PNG kind."""
    rng = np.random.default_rng(seed)
    if color == 3:
        palette = rng.integers(0, 256, (20, 3), dtype=np.uint8)
        px = rng.integers(0, 20, (H, W, 1), dtype=np.uint8)
        trns = bytes(rng.integers(0, 256, 12, dtype=np.uint8)) if with_trns else None
        return px, palette, trns
    px = rng.integers(0, 256, (H, W, CHANNELS[color]), dtype=np.uint8)
    trns = None
    if with_trns:  # one transparent grey level or colour, present in a corner
        key = rng.integers(0, 256, CHANNELS[color])
        px[:3, :4] = key
        trns = struct.pack(f">{len(key)}H", *key)
    return px, None, trns


KINDS = [(0, False), (0, True), (2, False), (2, True), (3, False), (3, True),
         (4, False), (6, False)]
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4]}


@pytest.mark.parametrize("filters", list(FILTERS), ids=str)
@pytest.mark.parametrize("color,with_trns", KINDS,
                         ids=[f"type{c}{'_trns' if t else ''}" for c, t in KINDS])
def test_decoder_matches_pil(tmp_path, color, with_trns, filters):
    px, palette, trns = samples(color, with_trns, seed=color * 10 + with_trns)
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(encode_png(px, color, FILTERS[filters], palette, trns))
    im = Image.open(path)
    want, want_rgba = np.asarray(im), np.asarray(im.convert("RGBA"))
    got = image_io.read_png(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.read_png(path, mode="RGBA"), want_rgba)
    if with_trns:
        assert (want_rgba[..., 3] < 255).any()


@pytest.mark.parametrize("mode,shape", [("L", (40, 52)), ("LA", (40, 52, 2)),
                                        ("RGB", (120, 160, 3)),
                                        ("RGBA", (64, 48, 4))])
def test_decoder_reads_pils_own_pngs(tmp_path, mode, shape):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] = np.linspace(0, 255, shape[1]).astype(np.uint8)[
        (None, slice(None)) + (None,) * (len(shape) - 2)]  # smooth rows
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode).save(path)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    np.testing.assert_array_equal(image_io.read_png(path, mode="RGBA"),
                                  np.asarray(Image.open(path).convert("RGBA")))


@pytest.mark.parametrize("colors,depth", [(2, 1), (4, 2), (16, 4), (256, 8)])
def test_decoder_reads_a_pil_palette_png_with_transparency(tmp_path, colors,
                                                          depth):
    """PIL packs a palette of 2, 4 or 16 colours into 1, 2 or 4 bits."""
    rng = np.random.default_rng(2)
    im = Image.fromarray(rng.integers(0, 256, (30, 37, 3), dtype=np.uint8))
    im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=colors)
    path = str(tmp_path / "p.png")
    im.save(path, transparency=1)
    with open(path, "rb") as f:
        assert f.read(25)[24] == depth  # the IHDR bit depth
    pil = Image.open(path)
    np.testing.assert_array_equal(image_io.read_png(path), np.asarray(pil))
    np.testing.assert_array_equal(image_io.read_png(path, mode="RGBA"),
                                  np.asarray(pil.convert("RGBA")))


def test_decoder_refuses_what_it_does_not_read(tmp_path):
    px = np.zeros((4, 4, 3), np.uint8)
    cases = {"wide.png": (encode_png(px, 2, [0], depth=16), "16-bit"),
             "grey4.png": (encode_png(px[..., :1], 0, [0], depth=4), "4-bit"),
             "adam7.png": (encode_png(px, 2, [0], interlace=1), "Adam7"),
             "type5.png": (encode_png(px, 5, [0]), "colour type 5"),
             "filter9.png": (assemble((b"\x09" + bytes(12)) * 4, 4, 4, 2),
                             "filter 9")}
    for name, (data, what) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=what) as err:
            image_io.read_png(path)
        assert name in str(err.value)
    corrupt = bytearray(encode_png(px, 2, [0]))
    corrupt[45] ^= 0xFF  # inside the tEXt chunk's data
    path = str(tmp_path / "corrupt.png")
    with open(path, "wb") as f:
        f.write(bytes(corrupt))
    with pytest.raises(ValueError, match="corrupt"):
        image_io.read_png(path)
    Image.fromarray(px).save(str(tmp_path / "a.jpg"))
    assert not image_io.is_png(str(tmp_path / "a.jpg"))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(str(tmp_path / "a.jpg"))
