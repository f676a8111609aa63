"""The cells' scenes as the plain reference reads them: the files that the
benchmark's writer (``traffic/analytic.py``) put under the scene's
directory, taken as the published F-ToRF and ToRF loaders take them.

A camera is its world-to-camera matrix, its pinhole intrinsics in pixels,
its size and its depth bounds. A frame is a camera (two in the ToRF
layout: the ToF camera and the colour camera, offset by
``relative_pose.npy``) and the observations the loss reads:

- F-ToRF (``quad``): the raw quad image captured at slot ``fid % 4``
  (``tofType{fid % 4}/{fid}.npy``), and on integration frames the 2D
  forward and backward flows to the frames 4 away, where they exist;
- ToRF (``real``): the phasor ``tof/{fid}.npy`` divided by the largest
  value of all frames, and the colour image area-averaged to the colour
  scale, divided by the largest value of all frames and quantised to
  8 bits.

The depth bounds are ``min_depth_fac * 0.9`` and ``max_depth_fac * 1.1``
of the depth range; the scene's extent is ``0.55`` of it."""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch


class Camera(NamedTuple):
    view: torch.Tensor  # (4, 4) world to camera
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float
    zfar: float


class Frame(NamedTuple):
    fid: int
    tof: Camera
    color: Camera
    quad: Optional[torch.Tensor]  # (1, H, W): the quad of slot fid % 4
    phasor: Optional[torch.Tensor]  # (3, H, W)
    image: Optional[torch.Tensor]  # (3, Hc, Wc)
    forward_flow: Optional[torch.Tensor]  # (2, H, W)
    backward_flow: Optional[torch.Tensor]  # (2, H, W)


class PlainScene(NamedTuple):
    kind: str  # "ftorf" | "torf"
    frames: List[Frame]
    depth_range: float
    phase_offset: float
    dc_offset: float
    extent: float
    same_camera: bool  # one camera serves ToF and colour


def _scalar(path: str, fallback: float) -> float:
    return float(np.load(path)) if os.path.exists(path) else float(fallback)


def _intrinsics(cams: str, name: str) -> np.ndarray:
    mat = os.path.join(cams, f"{name}.mat")
    if os.path.exists(mat):
        import scipy.io

        return np.asarray(scipy.io.loadmat(mat)["K"], np.float64)
    return np.asarray(np.load(os.path.join(cams, f"{name}.npy")), np.float64)


def _camera(view: np.ndarray, K: np.ndarray, scale: float, width: int,
            height: int, znear: float, zfar: float, device) -> Camera:
    return Camera(view=torch.as_tensor(np.asarray(view, np.float32),
                                       device=device),
                  fx=float(K[0, 0] * scale), fy=float(K[1, 1] * scale),
                  cx=float(K[0, 2] * scale), cy=float(K[1, 2] * scale),
                  width=int(width * scale), height=int(height * scale),
                  znear=znear, zfar=zfar)


def _area_down(img: np.ndarray, factor: int) -> np.ndarray:
    """The mean of each ``factor`` x ``factor`` block of an (H, W, C)
    image."""
    h, w = img.shape[0] // factor, img.shape[1] // factor
    blocks = img[:h * factor, :w * factor].reshape(h, factor, w, factor, -1)
    return blocks.astype(np.float64).mean(axis=(1, 3)).astype(np.float32)


def read(path: str, cfg: dict, device) -> PlainScene:
    """The scene under ``path`` as the configuration ``cfg`` reads it."""
    cams = os.path.join(path, "cams")
    n = int(cfg["total_num_views"])
    dr = _scalar(os.path.join(cams, "depth_range.npy"), cfg["depth_range"])
    znear = cfg.get("min_depth_fac", 0.05) * dr * 0.9
    zfar = cfg.get("max_depth_fac", 0.55) * dr * 1.1
    phase_offset = _scalar(os.path.join(cams, "phase_offset.npy"), 0.0)
    K_tof = _intrinsics(cams, "tof_intrinsics")
    K_col = _intrinsics(cams, "color_intrinsics")
    tw, th = cfg["tof_image_width"], cfg["tof_image_height"]
    cw, ch = cfg["color_image_width"], cfg["color_image_height"]
    ts, cs = float(cfg["tof_scale_factor"]), float(cfg["color_scale_factor"])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    frames = []
    if cfg["dataset_type"] == "quad":
        # A fixed camera: identity extrinsics for every frame.
        eye = np.eye(4)
        dc_offset = _scalar(os.path.join(cams, "dc_offset.npy"), 0.0)
        scale = _scalar(os.path.join(cams, "quad_values_scale_factor.npy"), 1.0)
        perm = os.path.join(path, "tof_permutation.npy")
        if os.path.exists(perm):
            raise ValueError("a permuted quad order is not read here")
        for fid in range(n):
            quad = np.load(os.path.join(path, f"tofType{fid % 4}",
                                        f"{fid:04d}.npy")) * scale
            flows = []
            for name in ("forward_flow_2", "backward_flow_2"):
                p = os.path.join(path, name, f"flow_{fid:04d}.npy")
                flows.append(t(np.load(p)) if os.path.exists(p) else None)
            tof = _camera(eye, K_tof, ts, tw, th, znear, zfar, device)
            frames.append(Frame(fid=fid, tof=tof,
                                color=_camera(eye, K_col, cs, cw, ch, znear,
                                              zfar, device),
                                quad=t(quad[None]), phasor=None, image=None,
                                forward_flow=flows[0], backward_flow=flows[1]))
        same = (ts, tw, th) == (cs, cw, ch) and np.array_equal(K_tof, K_col)
        return PlainScene("ftorf", frames, dr, phase_offset, dc_offset,
                          0.55 * dr, same)

    tof_E = np.load(os.path.join(cams, "tof_extrinsics.npy")).astype(np.float64)
    rel = os.path.join(cams, "relative_pose.npy")
    if os.path.exists(rel):
        col_E = np.linalg.inv(np.load(rel).astype(np.float64)) @ tof_E
    else:
        col_E = np.load(os.path.join(cams, "color_extrinsics.npy"))
    phasors = np.stack([np.load(os.path.join(path, "tof", f"{f:04d}.npy"))
                        for f in range(n)]).astype(np.float32)
    phasors = phasors / phasors.max()
    factor = int(round(1.0 / cs))
    images = np.stack([_area_down(np.load(os.path.join(path, "color",
                                                       f"{f:04d}.npy")), factor)
                       for f in range(n)])
    images = images / images.max()
    images = (images * 255.0).astype(np.uint8).astype(np.float32) / 255.0
    for fid in range(n):
        frames.append(Frame(
            fid=fid,
            tof=_camera(tof_E[fid], K_tof, ts, tw, th, znear, zfar, device),
            color=_camera(col_E[fid], K_col, cs, cw, ch, znear, zfar, device),
            quad=None, phasor=t(np.moveaxis(phasors[fid], -1, 0)[:3]),
            image=t(np.moveaxis(images[fid], -1, 0)[:3]),
            forward_flow=None, backward_flow=None))
    # The ToRF loader gives its frames no DC offset.
    return PlainScene("torf", frames, dr, phase_offset, 0.0, 0.55 * dr, False)
