"""A COLMAP capture as the plain reference reads it, in the way 3D Gaussian
Splatting's loader takes it (``readColmapSceneInfo``, with ``--eval``):
the views of ``sparse/0/images.bin`` sorted by image name, every
``llffhold``-th (from the first) held out for testing, the rest training
in that order; each view's world-to-camera rotation from its quaternion
and its translation; the one camera's ``PINHOLE`` focal lengths from
``sparse/0/cameras.bin``, its principal point at the image centre; near
and far planes at 0.01 and 100; the image from ``<images>/<name>``, an
8-bit RGB PNG, divided by 255; the scene's extent 1.1 times the largest
distance of a training camera's centre from their mean.

The PNGs are those the ``colmap`` layout writes: 8-bit RGB, not
interlaced, every row with filter 0. Any other PNG raises."""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, NamedTuple

import numpy as np
import torch

from reference.scene import Camera

ZNEAR, ZFAR = 0.01, 100.0
LLFFHOLD = 8


class Frame(NamedTuple):
    fid: int
    color: Camera
    image: torch.Tensor  # (3, H, W) in [0, 1]


class ColmapScene(NamedTuple):
    kind: str  # "colmap"
    frames: List[Frame]  # the training views, in the loader's order
    extent: float
    depth_range: float


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG whose rows all take filter 0."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = head
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlacing")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row takes a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def _rotation(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _views(path: str):
    """(name, rotation, translation) of each image of ``images.bin``."""
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            fields = struct.unpack("<i4d3di", f.read(64))
            name = b""
            while (c := f.read(1)) != b"\0":
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * npts)
            out.append((name.decode(), _rotation(fields[1:5]),
                        np.array(fields[5:8])))
    return sorted(out, key=lambda v: v[0])


def _camera(path: str):
    """(width, height, fx, fy) of the one PINHOLE camera of ``cameras.bin``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        _, model, w, h = struct.unpack("<iiQQ", f.read(24))
        if n != 1 or model != 1:
            raise ValueError(f"{path}: not one PINHOLE camera")
        fx, fy, _, _ = struct.unpack("<4d", f.read(32))
    return int(w), int(h), fx, fy


def read(path: str, cfg: dict, device) -> ColmapScene:
    """The training views of the capture under ``path``."""
    sparse = os.path.join(path, "sparse", "0")
    w, h, fx, fy = _camera(os.path.join(sparse, "cameras.bin"))
    views = _views(os.path.join(sparse, "images.bin"))
    train = [v for i, v in enumerate(views) if i % LLFFHOLD != 0]
    centres = np.stack([-R.T @ t for _, R, t in train])
    extent = 1.1 * float(np.linalg.norm(centres - centres.mean(0), axis=1).max())
    frames = []
    for fid, (name, R, t) in enumerate(train):
        view = np.eye(4)
        view[:3, :3], view[:3, 3] = R, t
        img = read_png(os.path.join(path, cfg["images"], name))
        frames.append(Frame(
            fid=fid,
            color=Camera(view=torch.as_tensor(view.astype(np.float32),
                                              device=device),
                         fx=fx, fy=fy, cx=w / 2.0, cy=h / 2.0, width=w,
                         height=h, znear=ZNEAR, zfar=ZFAR),
            image=torch.as_tensor(np.moveaxis(img, -1, 0).astype(np.float32)
                                  / 255.0, device=device)))
    return ColmapScene("colmap", frames, extent,
                       float(cfg.get("depth_range", 10.0)))
