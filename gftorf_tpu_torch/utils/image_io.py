"""PNG and GIF files in numpy and the standard library.

The port's render path writes its images here in place of imageio, and
reads back only what it wrote (the video panels re-read the render tree),
so it runs where imageio, PIL, cv2 and matplotlib are not installed.

- PNG: 8-bit grey (H, W) or RGB (H, W, 3), one zlib stream, every row
  with filter 0. ``read_png`` decodes exactly those files and raises on
  any other PNG.
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


def read_png(path: str) -> np.ndarray:
    """Read a PNG that ``write_png`` wrote; raise ValueError on any other."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIG), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit grey or RGB PNGs without "
                         f"interlacing are read (bit depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * channels):
        raise ValueError(f"{path}: image data of {raw.size} bytes for {w}x{h}")
    raw = raw.reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with PNG filters other than 0")
    img = raw[:, 1:].reshape((h, w, channels) if channels == 3 else (h, w))
    return img.copy()


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
