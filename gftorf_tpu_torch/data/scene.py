"""Scene orchestration: load a dataset, stack its frames onto the device,
and initialize the Gaussian model.

Port of ``gftorf_tpu/data/scene.py`` (the reference Scene,
scene/__init__.py:21-145, and ToFCamera, scene/cameras.py). All frames are
stacked into one ``FrameData`` with a leading frame axis on the device;
the training step takes a frame by index (``take_frame``).

GT handling matches loadCam (utils/camera_utils.py:21-78): everything is
resized to the color image size (``utils/resize.py``, OpenCV's INTER_AREA
in numpy) and the color image is quantized through uint8.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.readers import CameraRecord, SceneData, read_scene
from gftorf_tpu_torch.models.gaussians import GaussianModelState, init_from_pcd
from gftorf_tpu_torch.ops.transforms import projection_matrix_shift, world_to_view
from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig
from gftorf_tpu_torch.train.step import FrameData, _take_frame
from gftorf_tpu_torch.utils.resize import resize
from gftorf_tpu_torch.utils.runtime import resolve_device


def _resize_to(img, width, height):
    if img is None:
        return None
    if img.shape[1] == width and img.shape[0] == height:
        return img
    return resize(img, (width, height))


def camera_spec(R, T, fx, fy, cx, cy, width, height, fov_x, fov_y,
                znear, zfar, depth_range, device="cpu") -> CameraSpec:
    view_t = world_to_view(R, T)
    proj_t = projection_matrix_shift(znear, zfar, fx, fy, cx, cy,
                                     width, height, fov_x, fov_y)
    return CameraSpec.create(view_t, proj_t, width, height, fov_x, fov_y,
                             znear, zfar, depth_range, device=device)


def build_frame(cam: CameraRecord) -> FrameData:
    """One frame's observations as FrameData of CPU tensors."""
    wc, hc = cam.width, cam.height
    spec_color = camera_spec(cam.R, cam.T, cam.fx, cam.fy, cam.cx, cam.cy,
                             wc, hc, cam.fov_x, cam.fov_y,
                             cam.znear, cam.zfar, cam.depth_range)
    spec_tof = camera_spec(cam.R_tof, cam.T_tof, cam.fx_tof, cam.fy_tof,
                           cam.cx_tof, cam.cy_tof, cam.tof_width,
                           cam.tof_height, cam.fov_x_tof, cam.fov_y_tof,
                           cam.znear, cam.zfar, cam.depth_range)

    def chw(img, channels):
        if img is None:
            return np.zeros((channels, hc, wc), np.float32)
        img = _resize_to(img, wc, hc)
        if img.ndim == 2:
            img = img[..., None]
        return np.moveaxis(img, -1, 0)[:channels].astype(np.float32)

    if cam.image is not None:
        # uint8 quantization roundtrip (dataset_readers.py:360 + PILtoTorch)
        img_q = (cam.image * 255.0).astype(np.uint8).astype(np.float32) / 255.0
        gt_image = chw(img_q, 3)
    else:
        gt_image = np.zeros((3, hc, wc), np.float32)
    if cam.quads is not None:
        quads = np.stack([_resize_to(cam.quads[i], wc, hc) for i in range(4)],
                         0).astype(np.float32)
    else:
        quads = np.zeros((4, hc, wc), np.float32)
    k_tof = np.array([[cam.fx_tof, 0, cam.cx_tof], [0, cam.fy_tof, cam.cy_tof],
                      [0, 0, 1]], np.float32)
    k_color = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                       np.float32)
    t = torch.from_numpy
    return FrameData(
        frame_id=torch.tensor(cam.frame_id, dtype=torch.int32),
        cam_color=spec_color,
        cam_tof=spec_tof,
        gt_image=t(np.ascontiguousarray(gt_image)),
        gt_phasor=t(np.ascontiguousarray(chw(cam.tof_image, 3))),
        gt_quad=t(quads),
        gt_distance=t(np.ascontiguousarray(chw(cam.distance_image, 1))),
        forward_flow=t(np.ascontiguousarray(chw(cam.forward_flow, 2))),
        backward_flow=t(np.ascontiguousarray(chw(cam.backward_flow, 2))),
        has_forward_flow=torch.tensor(cam.forward_flow is not None),
        has_backward_flow=torch.tensor(cam.backward_flow is not None),
        phase_offset=torch.tensor(cam.phase_offset, dtype=torch.float32),
        dc_offset=torch.tensor(cam.dc_offset, dtype=torch.float32),
        intrinsics_tof=t(k_tof),
        intrinsics_color=t(k_color),
    )


def stack_frames(cams: List[CameraRecord], device=None) -> FrameData:
    """Every frame's FrameData stacked along a leading axis, on ``device``
    (None = the CUDA card)."""
    dev = resolve_device(device)

    def stack(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(stack(*col) for col in zip(*xs)))
        return torch.stack(xs).to(dev)

    return stack(*[build_frame(c) for c in cams])


def take_frame(frameset: FrameData, idx) -> FrameData:
    """Frame ``idx`` of a stacked FrameData."""
    return _take_frame(frameset, idx)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Scene:
    """Loaded scene: frames stacked on the device and the initialized
    Gaussian model. ``device=None`` means the CUDA card."""

    def __init__(self, cfg: Config, load_data: Optional[SceneData] = None,
                 init_model: bool = True, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        m = cfg.model
        self.data = load_data or read_scene(m.source_path, m, m.eval)
        self.scene_type = self.data.scene_type
        self.scene_extent = float(self.data.scene_extent)
        self.cameras_extent = float(self.data.cameras_extent)
        self.tof_permutation = tuple(int(i) for i in self.data.tof_permutation)
        self.tof_inverse_permutation = tuple(
            int(i) for i in self.data.tof_inverse_permutation)

        self.train_frames = stack_frames(self.data.train_cameras, self.device)
        if self.data.test_cameras is self.data.train_cameras:
            self.test_frames = self.train_frames
        else:
            self.test_frames = stack_frames(self.data.test_cameras, self.device)
        self.num_train = len(self.data.train_cameras)
        self.num_spiral = len(self.data.spiral_cameras)
        self._spiral_frames: Optional[FrameData] = None

        c0 = self.data.train_cameras[0]
        self.color_size = (c0.height, c0.width)
        self.tof_size = (c0.tof_height, c0.tof_width)
        # Identical color/ToF cameras (F-ToRF): one rasterization per step
        # serves both outputs.
        self.cameras_identical = all(
            np.allclose(c.R, c.R_tof) and np.allclose(c.T, c.T_tof)
            and (c.fx, c.fy, c.cx, c.cy) == (c.fx_tof, c.fy_tof, c.cx_tof,
                                             c.cy_tof)
            and (c.width, c.height) == (c.tof_width, c.tof_height)
            for c in self.data.train_cameras
        )

        self.model_state: Optional[GaussianModelState] = None
        if init_model:
            d = self.data
            n = d.points.shape[0]
            cap = cfg.tpu.capacity or _next_pow2(max(2 * n, n + 1024))
            self.model_state = init_from_pcd(
                d.points, d.colors,
                d.phases[:, 0] if d.phases is not None else None,
                d.amplitudes[:, 0] if d.amplitudes is not None else None,
                d.seg_colors, capacity=cap, sh_degree=m.sh_degree,
                initial_opacity=m.initial_opacity,
                isotropic=m.isotropic_gaussians,
                init_static_first=m.init_static_first, device=self.device,
            )

    @property
    def spiral_frames(self) -> Optional[FrameData]:
        """Stacked spiral render-path cameras (torf scenes), built on first
        use: training never touches them."""
        if not self.num_spiral:
            return None
        if self._spiral_frames is None:
            self._spiral_frames = stack_frames(self.data.spiral_cameras,
                                               self.device)
        return self._spiral_frames

    def raster_config(self, tof: bool, sh_degree: int) -> RasterConfig:
        h, w = self.tof_size if tof else self.color_size
        t = self.cfg.tpu
        return RasterConfig(
            height=h, width=w, tile_h=t.tile_h, tile_w=t.tile_w,
            max_per_tile=t.max_per_tile, dup_factor=t.dup_factor,
            sh_degree=sh_degree,
            use_view_dependent_phase=self.cfg.model.use_view_dependent_phase,
            tile_chunk=t.tile_chunk, flat_stream=t.flat_stream,
        )


def camera_to_json(idx: int, cam: CameraRecord, full: bool = False) -> dict:
    """Serialized camera entry (utils/camera_utils.py:87-154)."""
    w2c = np.zeros((4, 4))
    w2c[:3, :3] = cam.R.T
    w2c[:3, 3] = cam.T
    w2c[3, 3] = 1.0
    c2w = np.linalg.inv(w2c)
    entry = {
        "id": idx,
        "img_name": f"{cam.frame_id:04d}",
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fx": float(cam.fx),
        "fy": float(cam.fy),
    }
    if full:
        w2c_t = np.zeros((4, 4))
        w2c_t[:3, :3] = cam.R_tof.T
        w2c_t[:3, 3] = cam.T_tof
        w2c_t[3, 3] = 1.0
        c2w_t = np.linalg.inv(w2c_t)
        entry.update({
            "frame_id": cam.frame_id,
            "cx": float(cam.cx), "cy": float(cam.cy),
            "tof_width": cam.tof_width, "tof_height": cam.tof_height,
            "position_tof": c2w_t[:3, 3].tolist(),
            "rotation_tof": [r.tolist() for r in c2w_t[:3, :3]],
            "fx_tof": float(cam.fx_tof), "fy_tof": float(cam.fy_tof),
            "cx_tof": float(cam.cx_tof), "cy_tof": float(cam.cy_tof),
            "znear": float(cam.znear), "zfar": float(cam.zfar),
            "depth_range": float(cam.depth_range),
            "phase_offset": float(cam.phase_offset),
            "dc_offset": float(cam.dc_offset),
        })
    return entry


# scene_bounds.png: three orthographic views, each a square panel.
_PANEL, _PAD, _TITLE_H = 300, 24, 18
_AXES = ((0, 1), (0, 2), (1, 2))
_GREEN, _RED, _BLUE, _GREY = (0, 128, 0), (220, 0, 0), (0, 0, 255), (110, 110, 110)


def _camera_geometry(cams):
    """Positions, unit view directions and frustum corners of the ToF
    cameras (torf_utils.py:437-466)."""
    pos = np.array([-(c.R_tof @ c.T_tof) for c in cams])
    dirs = np.array([c.R_tof[:, 2] for c in cams])
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
    corners = []
    for c in cams:
        right, up, fwd = c.R_tof[:, 0], c.R_tof[:, 1], c.R_tof[:, 2]
        center = -(c.R_tof @ c.T_tof)
        for z in (c.znear, c.zfar):
            h = 2.0 * np.tan(c.fov_y_tof / 2.0) * z
            w = 2.0 * np.tan(c.fov_x_tof / 2.0) * z
            for sy in (1, -1):
                for sx in (-1, 1):
                    corners.append(center + fwd * z + up * (sy * h / 2)
                                   + right * (sx * w / 2))
    return pos, dirs, np.array(corners)


def _draw_segments(img, p0, p1, color):
    """Lines between pixel points p0[k] and p1[k] (x, y), clipped."""
    for a, b in zip(p0, p1):
        n = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        _draw_dots(img, a + (b - a) * t, color, 0)


def _draw_dots(img, pts, color, radius):
    """Squares of side 2 * radius + 1 at pixel points (x, y), clipped."""
    h, w = img.shape[:2]
    xy = np.rint(pts).astype(np.int64)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            x, y = xy[:, 0] + dx, xy[:, 1] + dy
            keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            img[y[keep], x[keep]] = color


def write_scene_bounds_png(scene: "Scene", model_path: str) -> None:
    """The reference's init-time sanity plot (torf_utils.py:437-466):
    camera positions (green), view directions 3 units long (red) and
    frustum corners (blue), drawn as three orthographic views (x-y, x-z,
    y-z) with the bitmap font and PNG writer of the render path, so no
    plotting library is needed. The JAX package draws the same points as
    a matplotlib 3D scatter."""
    from gftorf_tpu_torch.utils.image_io import write_png
    from gftorf_tpu_torch.video_panel import put_text, text_size

    pos, dirs, corners = _camera_geometry(scene.data.train_cameras)
    tips = pos + 3.0 * dirs
    every = np.concatenate([pos, tips, corners], 0)
    lo, hi = every.min(0), every.max(0)
    side = _PANEL + 2 * _PAD
    img = np.full((_TITLE_H + side, 3 * side, 3), 255, np.uint8)
    title = "Camera Poses"
    put_text(img, title, ((img.shape[1] - text_size(title)[0]) // 2, 12),
             (0, 0, 0))
    for k, (u, v) in enumerate(_AXES):
        x0, y0 = k * side + _PAD, _TITLE_H + _PAD
        # One scale on both axes, so the view keeps its proportions.
        span = max(hi[u] - lo[u], hi[v] - lo[v], 1e-9)
        mid = (lo[[u, v]] + hi[[u, v]]) / 2.0

        def px(p):
            q = (p[:, [u, v]] - mid) / span * (_PANEL - 1)
            return np.stack([x0 + (_PANEL - 1) / 2.0 + q[:, 0],
                             y0 + (_PANEL - 1) / 2.0 - q[:, 1]], 1)

        img[y0, x0:x0 + _PANEL] = img[y0 + _PANEL - 1, x0:x0 + _PANEL] = _GREY
        img[y0:y0 + _PANEL, x0] = img[y0:y0 + _PANEL, x0 + _PANEL - 1] = _GREY
        _draw_dots(img, px(corners), _BLUE, 1)
        _draw_segments(img, px(pos), px(tips), _RED)
        _draw_dots(img, px(pos), _GREEN, 2)
        names = "xyz"
        put_text(img, f"{names[u]} (right) / {names[v]} (up)",
                 (x0, y0 - 4), (0, 0, 0))
        lo_txt = f"{names[u]} {mid[0] - span / 2:.3g}..{mid[0] + span / 2:.3g}"
        hi_txt = f"{names[v]} {mid[1] - span / 2:.3g}..{mid[1] + span / 2:.3g}"
        put_text(img, lo_txt, (x0, y0 + _PANEL + 10), _GREY)
        put_text(img, hi_txt, (x0, y0 + _PANEL + 19), _GREY)
    write_png(os.path.join(model_path, "scene_bounds.png"), img)


def write_scene_metadata(scene: "Scene", model_path: str) -> None:
    """cameras.json / cameras_full.json / nerf_normalization.json, the
    SIBR-style cfg_args line (scene/__init__.py:63-83, train.py:496-498)
    and input.ply, the initialization point cloud."""
    from gftorf_tpu_torch.utils.ply import write_ply

    os.makedirs(model_path, exist_ok=True)
    cams = scene.data.train_cameras
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)
    with open(os.path.join(model_path, "cameras_full.json"), "w") as f:
        json.dump([camera_to_json(i, c, full=True) for i, c in enumerate(cams)],
                  f)
    centers = np.stack([-(c.R @ c.T) for c in cams], 0)
    center = centers.mean(0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=-1))) * 1.1
    with open(os.path.join(model_path, "nerf_normalization.json"), "w") as f:
        json.dump({
            "translate": (-center).tolist(),
            "radius": radius if radius > 0 else 1.0,
            "scene_scale": scene.scene_extent,
            "tof_permutation": list(scene.tof_permutation),
            "tof_inverse_permutation": list(scene.tof_inverse_permutation),
        }, f)
    m = scene.cfg.model
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write("Namespace(" + ", ".join(
            f"{k}={v!r}" for k, v in sorted(vars(m).items())) + ")")
    pts = np.asarray(scene.data.points, np.float32)
    rgb = np.clip(np.asarray(scene.data.colors) * 255.0, 0, 255)
    zeros = np.zeros_like(pts[:, 0])
    write_ply(os.path.join(model_path, "input.ply"), {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    })
