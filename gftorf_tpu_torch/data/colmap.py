"""COLMAP sparse-reconstruction parsers (scene/colmap_loader.py port).

The port's own copy of ``gftorf_tpu/data/colmap.py`` (numpy only).

Reads cameras.bin/txt, images.bin/txt, points3D.bin/txt in the COLMAP
format (https://colmap.github.io/format.html). Only PINHOLE and
SIMPLE_PINHOLE camera models are supported downstream, like the
reference (dataset_readers.py:169-179).
"""

from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"]
)
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys",
                    "point3D_ids"]
)

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            out[cam_id] = ColmapCamera(cam_id, name, w, h, params)
    return out


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]),
            )
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = _read(f, "<" + "ddq" * npts)
            xys = np.array(data).reshape(npts, 3)[:, :2] if npts else np.zeros((0, 2))
            ids = np.array(data[2::3], dtype=np.int64) if npts else np.zeros(0, np.int64)
            out[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode(), xys, ids
            )
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for meta, pts in zip(lines[::2], lines[1::2]):
        el = meta.split()
        img_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        p = pts.split()
        xys = (np.array([float(x) for x in p]).reshape(-1, 3)[:, :2]
               if p else np.zeros((0, 2)))
        ids = (np.array([int(x) for x in p[2::3]], np.int64)
               if p else np.zeros(0, np.int64))
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_points3d_binary(path):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty((n, 1))
        for i in range(n):
            data = _read(f, "<QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) for x in el[4:7]])
            err.append([float(el[7])])
    return np.array(xyz), np.array(rgb), np.array(err)
