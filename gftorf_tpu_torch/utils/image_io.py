"""PNG and GIF files in numpy and the standard library.

The port writes its images here in place of imageio and reads PNGs here
in place of PIL (the video panels re-read the render tree; the COLMAP and
Blender readers load their captures), so it runs where imageio, PIL, cv2
and matplotlib are not installed.

- PNG out: 8-bit grey (H, W) or RGB (H, W, 3), one zlib stream, every
  row with filter 0.
- PNG in: ``read_png`` decodes 8-bit, non-interlaced PNGs of every colour
  type (grey, RGB, palette with ``tRNS``, grey with alpha, RGBA; palettes
  also at 1, 2 and 4 bits, as PIL writes small ones) and all five row
  filters with the standard library's zlib, into the array
  ``np.asarray(PIL.Image.open(path))`` gives, or with ``mode="RGBA"`` the
  one ``Image.open(path).convert("RGBA")`` gives. Any other PNG (16-bit or
  under 8-bit samples, Adam7 interlacing) raises a ValueError that names
  the file and the feature.
- GIF: a fixed 6x7x6 colour cube (252 colours) and the nearest colour for
  each pixel, so no palette is fitted; the LZW stream holds one 9-bit
  literal code a pixel with a clear code every ``_GIF_RUN`` codes, before
  the decoder's table would need 10-bit codes. That is no compression
  (9/8 of the pixels), but it is encoded in a few array operations.
- Video: ``write_video`` keeps the JAX package's probe
  (video_panel.py:20-33): an mp4 where imageio and an ffmpeg backend
  import, else a GIF, written here.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {2: 0, 3: 2}  # ndim -> grey / RGB
# Samples a pixel per colour type: grey, RGB, palette, grey+alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_LEVEL = 6

# The GIF palette: 6 levels of red and blue, 7 of green.
_CUBE = (6, 7, 6)
_GIF_CLEAR, _GIF_EOI = 256, 257
# Literal codes between clear codes: after a clear the decoder's next
# table entry is 258, and it widens its codes at 512.
_GIF_RUN = 250


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _as_uint8_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected a uint8 (H, W) or (H, W, 3) image, got "
                         f"{img.dtype} {img.shape}")
    return img


def write_png(path: str, img) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as a PNG."""
    img = _as_uint8_image(img)
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[img.ndim], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), _PNG_LEVEL))
                + _chunk(b"IEND", b""))


def _png_chunks(path: str, data: bytes):
    """(kind, body) of each chunk up to IEND, CRCs checked."""
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIG)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: {kind!r} chunk is truncated or corrupt")
        pos += 12 + length
        yield kind, body
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(path: str, raw: np.ndarray, h: int, w: int, bpp: int):
    """Undo the five PNG row filters of (h, 1 + w * bpp) filtered rows.

    A pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal r + i = d decode together: h + w - 1
    vector steps. The image is kept skewed and diagonal-major, pixel
    (r, i) at [r + i + 2, r + 1], so a diagonal and its three neighbours
    are contiguous slices, and the cells never written are the zeros the
    filters assume beyond the image.
    """
    kinds = raw[:, 0]
    if kinds.max() > 4:
        raise ValueError(f"{path}: row filter {int(kinds.max())} is not a "
                         f"PNG filter")
    x = raw[:, 1:].reshape(h, w, bpp)
    if not kinds.any():
        return x.copy()
    rows = np.arange(h)[:, None]
    diags = rows + np.arange(w)[None, :]
    skew_x = np.zeros((h + w - 1, h, bpp), np.int16)
    skew_x[diags, rows] = x
    z = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    k = kinds[:, None]
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a, b, c = z[d + 1, r0 + 1:r1 + 1], z[d + 1, r0:r1], z[d, r0:r1]
        kd = k[r0:r1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(kd == 1, a, np.where(kd == 2, b, np.where(
            kd == 3, (a + b) >> 1, np.where(kd == 4, paeth, 0))))
        z[d + 2, r0 + 1:r1 + 1] = (skew_x[d, r0:r1] + pred) & 0xFF
    return z[diags + 2, rows + 1].astype(np.uint8)


def is_png(path: str) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(len(_PNG_SIG)) == _PNG_SIG


def read_png(path: str, mode: str = None) -> np.ndarray:
    """The pixels of an 8-bit (or 1-4 bit palette) non-interlaced PNG as
    uint8: as ``np.asarray(PIL.Image.open(path))`` (grey (H, W), grey+alpha
    (H, W, 2), RGB (H, W, 3), RGBA (H, W, 4), palette indices (H, W)), or
    with ``mode="RGBA"`` as ``Image.open(path).convert("RGBA")`` (a
    ``tRNS`` colour or palette alphas become the alpha channel)."""
    if mode not in (None, "RGBA"):
        raise ValueError(f"read_png: mode {mode!r} (None or 'RGBA')")
    with open(path, "rb") as f:
        data = f.read()
    header, palette, trns, idat = None, None, None, []
    for kind, body in _png_chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = _PNG_CHANNELS.get(color)
    if channels is None:
        raise ValueError(f"{path}: colour type {color} is not a PNG colour type")
    packed = color == 3 and depth in (1, 2, 4)  # palette indices < 8 bits
    if depth != 8 and not packed:
        raise ValueError(f"{path}: {depth}-bit samples are not decoded (only "
                         f"8-bit PNGs, and palettes of 1-4 bits, are read)")
    if interlace != 0:
        raise ValueError(f"{path}: Adam7 interlacing is not decoded (only "
                         f"non-interlaced PNGs are read)")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    # Filters work on bytes: a packed row is one byte a "pixel".
    row_px, bpp = (-(-w * depth // 8), 1) if packed else (w, channels)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + row_px * bpp):
        raise ValueError(f"{path}: image data of {raw.size} bytes for {w}x{h}")
    px = _unfilter(path, raw.reshape(h, 1 + row_px * bpp), h, row_px, bpp)
    if packed:
        bits = np.unpackbits(px[..., 0], axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        px = (bits * weights).sum(-1, dtype=np.uint8)[:, :w, None]
    if mode is None:
        return px[..., 0] if channels == 1 else px
    return _to_rgba(px, color, palette, trns)


def _to_rgba(px, color, palette, trns):
    """PIL's ``convert("RGBA")`` of decoded samples."""
    h, w = px.shape[:2]
    if color == 3:
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = alpha
        lut[:len(palette), :3] = palette[:256]
        return lut[px[..., 0]]
    rgb = px[..., :3] if color in (2, 6) else np.repeat(px[..., :1], 3, -1)
    if color in (4, 6):
        alpha = px[..., -1]
    elif trns is not None:  # one transparent grey level or colour
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns))
        alpha = np.where((px == key).all(-1), 0, 255).astype(np.uint8)
    else:
        alpha = np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], -1)


def _palette() -> np.ndarray:
    """(256, 3) uint8: the colour cube, red slowest, then black padding."""
    levels = [np.round(np.arange(n) * 255.0 / (n - 1)) for n in _CUBE]
    r, g, b = np.meshgrid(*levels, indexing="ij")
    cube = np.stack([r, g, b], -1).reshape(-1, 3)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(cube)] = cube
    return pal


def _palette_index(img: np.ndarray) -> np.ndarray:
    """The nearest cube colour of each pixel of a uint8 (H, W[, 3]) image."""
    img = _as_uint8_image(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    steps = np.array(_CUBE) - 1
    q = np.rint(img.astype(np.float32) * (steps / 255.0)).astype(np.int32)
    return (q[..., 0] * _CUBE[1] + q[..., 1]) * _CUBE[2] + q[..., 2]


def _lzw_literals(index: np.ndarray) -> bytes:
    """The LZW stream (min code size 8) of palette indices as 9-bit
    literal codes, packed least significant bit first, in sub-blocks."""
    px = index.reshape(-1).astype(np.uint16)
    runs = -(-px.size // _GIF_RUN)
    pad = runs * _GIF_RUN - px.size
    body = np.concatenate([np.full((runs, 1), _GIF_CLEAR, np.uint16),
                           np.pad(px, (0, pad)).reshape(runs, _GIF_RUN)], 1)
    codes = np.append(body.reshape(-1)[:body.size - pad], np.uint16(_GIF_EOI))
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    stream = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = [bytes([len(stream[i:i + 255])]) + stream[i:i + 255]
              for i in range(0, len(stream), 255)]
    return b"\x08" + b"".join(blocks) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], duration: float) -> None:
    """An endlessly looping GIF of uint8 (H, W[, 3]) frames of one size,
    ``duration`` seconds each, in the fixed colour cube."""
    frames = [_as_uint8_image(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("write_gif: frames of different sizes")
    delay = int(round(duration * 100))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           _palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_lzw_literals(_palette_index(f)))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def write_video(path_base: str, frames: List[np.ndarray], fps: float) -> str:
    """Write frames as mp4 where imageio and an ffmpeg backend import,
    else as a GIF; returns the written path."""
    try:
        import imageio.v2 as imageio

        writer = imageio.get_writer(path_base + ".mp4", fps=fps)
    except (ImportError, ValueError, RuntimeError, OSError):
        write_gif(path_base + ".gif", frames, 1.0 / fps)
        return path_base + ".gif"
    with writer:
        for f in frames:
            writer.append_data(f)
    return path_base + ".mp4"
