"""Dataset readers for ToRF and F-ToRF scenes.

The port's own copy of ``gftorf_tpu/data/readers.py``, numpy only:
images are resized by ``utils/resize.py`` (OpenCV's INTER_AREA and
INTER_NEAREST, where the JAX package calls cv2) and PNGs decoded by
``utils/image_io.py`` (where it calls PIL); scipy.io is imported for
``.mat`` intrinsics, and PIL only for a COLMAP image that is not a PNG
(``_read_colmap_image``). Numpy
ports of the reference readers
(scene/dataset_readers.py:343-606 readToRFSceneInfo, :716-1003
readFToRFSceneInfo), producing plain-array records the Scene layer stacks
onto the device. Directory layouts, normalization (global max over the
full stack), camera conventions (w2c extrinsics, FoV from arctan2), and
point-cloud initialization (random-in-frustum-bounds or ToF-phase
backprojection with two-hypothesis unwrapping) all match the reference.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np

from gftorf_tpu_torch.config import ModelParams
from gftorf_tpu_torch.utils.image_io import is_png, read_png
from gftorf_tpu_torch.utils.resize import resize


def normalize_im_max(im):
    return im / np.max(im)


def scale_image(image, scale=1.0, nearest=False):
    """``cv2.resize(image, None, fx=scale, fy=scale)``, INTER_AREA or
    INTER_NEAREST, without cv2."""
    if scale == 1.0:
        return image
    return resize(image, fx=scale, fy=scale, nearest=nearest)


def get_camera_params(intrinsics_file, extrinsics_file, total_num_views,
                      ftorf=False):
    """(torf_utils.py:314-325): per-frame K copies; identity extrinsics
    for F-ToRF (fixed camera)."""
    if intrinsics_file.endswith(".mat"):
        import scipy.io

        K = scipy.io.loadmat(intrinsics_file)["K"]
    else:
        K = np.load(intrinsics_file)
    Ks = [np.copy(K) for _ in range(total_num_views)]
    if ftorf:
        exts = np.repeat(np.eye(4, dtype=np.float32)[None], total_num_views, 0)
    else:
        exts = np.load(extrinsics_file)
    return Ks, exts


@dataclasses.dataclass
class CameraRecord:
    """Host-side per-frame record (subset of the reference CameraInfo)."""

    uid: int
    frame_id: int
    # color camera
    R: np.ndarray
    T: np.ndarray
    fov_x: float
    fov_y: float
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    image: Optional[np.ndarray]  # (H, W, 3) in [0,1]
    # tof camera
    R_tof: np.ndarray
    T_tof: np.ndarray
    fov_x_tof: float
    fov_y_tof: float
    fx_tof: float
    fy_tof: float
    cx_tof: float
    cy_tof: float
    tof_width: int
    tof_height: int
    tof_image: Optional[np.ndarray]  # (Ht, Wt, 3) real/imag/amp
    distance_image: Optional[np.ndarray]  # (Ht, Wt) or (Ht, Wt, 1)
    quads: Optional[np.ndarray] = None  # (4, Ht, Wt)
    forward_flow: Optional[np.ndarray] = None  # (Ht, Wt, 2)
    backward_flow: Optional[np.ndarray] = None
    znear: float = 0.01
    zfar: float = 100.0
    depth_range: float = 15.0
    phase_offset: float = 0.0
    dc_offset: float = 0.0


@dataclasses.dataclass
class SceneData:
    scene_type: str  # 'torf' | 'ftorf'
    train_cameras: List[CameraRecord]
    test_cameras: List[CameraRecord]
    spiral_cameras: List[CameraRecord]
    # point-cloud init
    points: np.ndarray
    colors: np.ndarray
    phases: Optional[np.ndarray]
    amplitudes: Optional[np.ndarray]
    seg_colors: Optional[np.ndarray]
    scene_extent: float
    cameras_extent: float
    tof_permutation: np.ndarray
    tof_inverse_permutation: np.ndarray
    depth_range: float
    phase_offset: float
    dc_offset: float
    znear: float
    zfar: float


def detect_scene_type(path: str) -> str:
    """Directory probing (scene/__init__.py:45-61)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    if os.path.exists(os.path.join(path, "tofType0")):
        return "ftorf"
    if os.path.exists(os.path.join(path, "tof")):
        return "torf"
    raise ValueError(f"Could not recognize scene type at {path}")


def _fov(size, focal):
    return 2.0 * np.arctan2(size, 2.0 * focal)


def _camera_centers_extent(cams: List[CameraRecord]) -> float:
    """getNerfppNorm radius (dataset_readers.py:88-107)."""
    centers = []
    for c in cams:
        # C2W translation: -R @ T for w2c (R stored transposed like ref)
        c2w_t = -(c.R @ c.T)
        centers.append(c2w_t)
    centers = np.stack(centers, 0)
    center = centers.mean(0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=-1))) * 1.1
    return radius if radius > 0 else 1.0


def _frustum_bounds(cams: List[CameraRecord]):
    """Union of tof-frustum corners (torf_utils.py:405-472)."""
    corners = []
    for c in cams:
        aspect = c.tof_width / c.tof_height
        hnear = 2 * np.tan(c.fov_y_tof / 2) * c.znear
        wnear = hnear * aspect
        hfar = 2 * np.tan(c.fov_x_tof / 2) * c.zfar
        wfar = hfar * aspect
        rinv = np.linalg.inv(c.R_tof.T)
        fwd = rinv[:, 2] / np.linalg.norm(rinv[:, 2])
        right = rinv[:, 0] / np.linalg.norm(rinv[:, 0])
        up = -rinv[:, 1] / np.linalg.norm(rinv[:, 1])
        pos = -rinv @ c.T_tof
        for dist, hh, ww in ((c.znear, hnear, wnear), (c.zfar, hfar, wfar)):
            for su in (1, -1):
                for sr in (1, -1):
                    corners.append(
                        pos + fwd * dist + up * su * (hh / 2) + right * sr * (ww / 2)
                    )
    corners = np.stack(corners, 0)
    return corners.min(0), corners.max(0)


def _load_scalar(path, fallback):
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    return np.array(fallback, np.float32)


def _phase_backproject(cam: CameraRecord, depth_range, phase_offset, stride,
                       hardcoded_unwrap: bool):
    """ToF-phase point init (dataset_readers.py:530-586 torf, :904-962 ftorf).

    Backprojects each strided ToF pixel along its ray to the phase depth;
    torf duplicates every point at +depth_range/2 (two-hypothesis
    unwrapping), ftorf picks one hypothesis by a hardcoded amplitude rule.
    """
    h = math.ceil(cam.tof_height / stride)
    w = math.ceil(cam.tof_width / stride)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.int32) * stride
    tof = cam.tof_image
    phase = np.arctan2(tof[xy[:, 1], xy[:, 0], 1], tof[xy[:, 1], xy[:, 0], 0])
    phase = phase - phase_offset
    phase = np.where(phase < 0, phase + 2 * np.pi, phase)
    z = (phase * depth_range / (4 * np.pi)).reshape(-1, 1)

    if hardcoded_unwrap:
        z2 = z + depth_range / 2.0
        amp = tof[xy[:, 1], xy[:, 0], 2].reshape(-1, 1)
        zn = cam.znear
        z_sel = np.where(
            (zn < z) & (z <= 10.5), z,
            np.where((zn < z2) & (z2 <= 10.5), z2, z),
        )
        # prefer the far hypothesis for low-amplitude pixels when both fit
        both = (zn < z) & (z <= 10.5) & (zn < z2) & (z2 <= 10.5)
        z_sel = np.where(both & (amp < 0.04), z2, z_sel)
        z = z_sel
        xy_full = xy
    else:
        xy_full = np.concatenate([xy, xy], 0)
        z = np.concatenate([z, z + depth_range / 2.0], 0)

    n = xy_full.shape[0]
    w_m = cam.znear * np.tan(cam.fov_x_tof / 2.0) * 2.0
    h_m = cam.znear * np.tan(cam.fov_y_tof / 2.0) * 2.0
    x_m = (xy_full[:, 0] * 2.0 / cam.tof_width - 1.0) * w_m / 2.0
    y_m = (xy_full[:, 1] * 2.0 / cam.tof_height - 1.0) * h_m / 2.0
    d = np.sqrt(x_m**2 + y_m**2 + cam.znear**2)
    xc = (x_m / d)[:, None] * z
    yc = (y_m / d)[:, None] * z
    zc = np.sqrt(np.maximum(z**2 - xc**2 - yc**2, 0.0))

    w2v = np.zeros((4, 4))
    w2v[:3, :3] = cam.R_tof.T
    w2v[:3, 3] = cam.T_tof
    w2v[3, 3] = 1.0
    pts_h = np.concatenate([xc, yc, zc, np.ones((n, 1))], -1)
    xyz = (np.linalg.inv(w2v) @ pts_h.T).T[:, :3]

    amp_px = tof[xy_full[:, 1], xy_full[:, 0], 2].reshape(-1, 1)
    colors = np.repeat(amp_px, 3, axis=1)
    amplitudes = amp_px * np.square(z)
    return xyz, colors, amplitudes


def read_torf_scene(path: str, args: ModelParams, eval_split: bool,
                    llffhold: int = 8) -> SceneData:
    """readToRFSceneInfo (dataset_readers.py:434-606)."""
    ext = "mat" if args.dataset_type == "real" else "npy"
    tof_K, tof_E = get_camera_params(
        os.path.join(path, "cams", f"tof_intrinsics.{ext}"),
        os.path.join(path, "cams", "tof_extrinsics.npy"), args.total_num_views)
    col_K, col_E = get_camera_params(
        os.path.join(path, "cams", f"color_intrinsics.{ext}"),
        os.path.join(path, "cams", "color_extrinsics.npy"), args.total_num_views)
    rel = os.path.join(path, "cams", "relative_pose.npy")
    if os.path.exists(rel):
        col_E = np.linalg.inv(np.load(rel)) @ tof_E

    if args.phase_offset != -99.0:
        phase_offset = float(args.phase_offset)
    else:
        phase_offset = float(
            _load_scalar(os.path.join(path, "cams", "phase_offset.npy"), 0.0)
        )
    depth_range = float(
        _load_scalar(os.path.join(path, "cams", "depth_range.npy"),
                     args.depth_range)
    )
    znear = args.min_depth_fac * depth_range * 0.9
    zfar = args.max_depth_fac * depth_range * 1.1

    color_stack, tof_stack = [], []
    for fid in range(args.total_num_views):
        color_stack.append(scale_image(
            np.load(os.path.join(path, "color", f"{fid:04d}.npy")),
            args.color_scale_factor))
        tof_stack.append(scale_image(
            np.load(os.path.join(path, "tof", f"{fid:04d}.npy")),
            args.tof_scale_factor))
    color_stack = normalize_im_max(np.stack(color_stack)).astype(np.float32)
    tof_stack = normalize_im_max(np.stack(tof_stack)).astype(np.float32)

    cams = []
    for fid in range(args.total_num_views):
        K, Kt = col_K[fid], tof_K[fid]
        dist_path = os.path.join(path, "distance", f"{fid:04d}.npy")
        dist = (
            scale_image(np.load(dist_path), args.tof_scale_factor, nearest=True)
            if os.path.exists(dist_path)
            else None
        )
        cams.append(CameraRecord(
            uid=fid, frame_id=fid if "dino" not in path else fid % 61,
            R=np.transpose(col_E[fid, :3, :3]), T=col_E[fid, :3, 3],
            fov_x=_fov(args.color_image_width, K[0, 0]),
            fov_y=_fov(args.color_image_height, K[1, 1]),
            fx=K[0, 0] * args.color_scale_factor,
            fy=K[1, 1] * args.color_scale_factor,
            cx=K[0, 2] * args.color_scale_factor,
            cy=K[1, 2] * args.color_scale_factor,
            width=int(args.color_image_width * args.color_scale_factor),
            height=int(args.color_image_height * args.color_scale_factor),
            image=color_stack[fid],
            R_tof=np.transpose(tof_E[fid, :3, :3]), T_tof=tof_E[fid, :3, 3],
            fov_x_tof=_fov(args.tof_image_width, Kt[0, 0]),
            fov_y_tof=_fov(args.tof_image_height, Kt[1, 1]),
            fx_tof=Kt[0, 0] * args.tof_scale_factor,
            fy_tof=Kt[1, 1] * args.tof_scale_factor,
            cx_tof=Kt[0, 2] * args.tof_scale_factor,
            cy_tof=Kt[1, 2] * args.tof_scale_factor,
            tof_width=int(args.tof_image_width * args.tof_scale_factor),
            tof_height=int(args.tof_image_height * args.tof_scale_factor),
            tof_image=tof_stack[fid],
            distance_image=dist,
            znear=float(znear), zfar=float(zfar),
            depth_range=depth_range, phase_offset=phase_offset,
        ))

    if not args.dynamic and eval_split:
        if args.train_views:
            idx_train = [int(i) for i in args.train_views.split(",")]
            train = [c for i, c in enumerate(cams) if i in idx_train]
            test = [c for i, c in enumerate(cams) if i not in idx_train]
        else:
            train = [c for i, c in enumerate(cams) if i % llffhold != 0]
            test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    elif "dino" in path and eval_split:
        train = cams[:30]
        test = cams[len(cams) // 2 : len(cams) // 2 + 30]
    else:
        train, test = cams, cams

    pcd = _init_pcd_torf(path, train, args, depth_range, phase_offset)
    return SceneData(
        scene_type="torf", train_cameras=train, test_cameras=test,
        spiral_cameras=_spiral_cameras(tof_E, col_K, args, depth_range,
                                       phase_offset, znear, zfar, path),
        scene_extent=depth_range * 0.55,
        cameras_extent=_camera_centers_extent(train),
        tof_permutation=np.arange(4), tof_inverse_permutation=np.arange(4),
        depth_range=depth_range, phase_offset=phase_offset, dc_offset=0.0,
        znear=float(znear), zfar=float(zfar), **pcd,
    )


def _init_pcd_torf(path, train, args, depth_range, phase_offset):
    if args.init_method == "random":
        mn, mx = _frustum_bounds(train)
        n = args.num_points
        rng = np.random  # global seeding like the reference (safe_state)
        xyz = rng.uniform(mn, mx, (n, 3))
        colors = np.full((n, 3), 0.5, np.float32)
        phases = rng.random((n, 1)).astype(np.float32) * 2.0 * np.pi
        amplitudes = np.full((n, 1), args.initial_amplitude, np.float32)
    else:  # phase
        fids = ([args.total_num_views // 2] if args.dynamic
                else list(range(len(train))))
        parts = [
            _phase_backproject(train[f], depth_range, phase_offset,
                               args.phase_resolution_stride, False)
            for f in fids
        ]
        xyz = np.concatenate([p[0] for p in parts], 0)
        colors = np.concatenate([p[1] for p in parts], 0)
        amplitudes = np.concatenate([p[2] for p in parts], 0)
        phases = np.zeros((xyz.shape[0], 1), np.float32)
    seg = np.repeat(np.array([[1.0, 0.0, 0.0]]), xyz.shape[0], 0)  # all dynamic
    return dict(points=xyz.astype(np.float32), colors=colors.astype(np.float32),
                phases=phases.astype(np.float32),
                amplitudes=amplitudes.astype(np.float32),
                seg_colors=seg.astype(np.float32))


def _spiral_cameras(tof_E, col_K, args, depth_range, phase_offset, znear,
                    zfar, path=None):
    from gftorf_tpu_torch.data.spiral import get_render_poses_spiral, recenter_poses

    test_poses = os.path.join(path, "test_poses.npy") if path else None
    if test_poses and os.path.exists(test_poses):
        # Author-provided eval path (dataset_readers.py:493-501): stored
        # as world-to-camera rows, pushed 10% further out and recentred
        # on the rig's average pose.
        w2c = np.load(test_poses)
        c2w = np.tile(np.eye(4)[None], (w2c.shape[0], 1, 1))
        c2w[:, :3, :] = w2c[:, :3, :4]
        c2w = np.linalg.inv(c2w)
        c2w[:, :3, -1] *= 1.1
        c2w, _ = recenter_poses(c2w)
        spiral = c2w[::-1]
    else:
        poses = [np.linalg.inv(e) for e in tof_E]
        n_rots = 1 if not args.dynamic else 2
        spiral = get_render_poses_spiral(
            -1.0, np.array([znear, zfar]), poses,
            n_views=args.total_num_spiral_views, n_rots=n_rots)
        if not args.dynamic:
            spiral = spiral[::-1]
    out = []
    for fid, pose in enumerate(spiral):
        e = np.linalg.inv(pose)
        K = col_K[0]
        out.append(CameraRecord(
            uid=fid, frame_id=fid,
            R=np.transpose(e[:3, :3]), T=e[:3, 3],
            fov_x=_fov(args.color_image_width, K[0, 0]),
            fov_y=_fov(args.color_image_height, K[1, 1]),
            fx=K[0, 0] * args.color_scale_factor,
            fy=K[1, 1] * args.color_scale_factor,
            cx=K[0, 2] * args.color_scale_factor,
            cy=K[1, 2] * args.color_scale_factor,
            width=int(args.color_image_width * args.color_scale_factor),
            height=int(args.color_image_height * args.color_scale_factor),
            image=None,
            R_tof=np.transpose(e[:3, :3]), T_tof=e[:3, 3],
            # spiral ToF fovs == color fovs (the reference reuses FovX/
            # FovY computed from the color dims for both cameras,
            # dataset_readers.py:418-425)
            fov_x_tof=_fov(args.color_image_width, K[0, 0]),
            fov_y_tof=_fov(args.color_image_height, K[1, 1]),
            fx_tof=K[0, 0] * args.tof_scale_factor,
            fy_tof=K[1, 1] * args.tof_scale_factor,
            cx_tof=K[0, 2] * args.tof_scale_factor,
            cy_tof=K[1, 2] * args.tof_scale_factor,
            tof_width=int(args.tof_image_width * args.tof_scale_factor),
            tof_height=int(args.tof_image_height * args.tof_scale_factor),
            tof_image=None, distance_image=None,
            znear=float(znear), zfar=float(zfar),
            depth_range=float(depth_range), phase_offset=float(phase_offset),
        ))
    return out


def read_ftorf_scene(path: str, args: ModelParams) -> SceneData:
    """readFToRFSceneInfo (dataset_readers.py:831-1003)."""
    tof_K, tof_E = get_camera_params(
        os.path.join(path, "cams", "tof_intrinsics.npy"),
        os.path.join(path, "cams", "tof_extrinsics.npy"),
        args.total_num_views, ftorf=True)
    col_K, col_E = get_camera_params(
        os.path.join(path, "cams", "color_intrinsics.npy"),
        os.path.join(path, "cams", "color_extrinsics.npy"),
        args.total_num_views, ftorf=True)

    if args.phase_offset != -99.0:
        phase_offset = float(args.phase_offset)
    else:
        phase_offset = float(
            _load_scalar(os.path.join(path, "cams", "phase_offset.npy"), 0.0))
    depth_range = float(_load_scalar(
        os.path.join(path, "cams", "depth_range.npy"), args.depth_range))
    dc_offset = float(_load_scalar(
        os.path.join(path, "cams", "dc_offset.npy"), args.dc_offset))
    if args.quad_scale != -1.0:
        quad_scale = float(args.quad_scale)
    else:
        quad_scale = float(_load_scalar(
            os.path.join(path, "cams", "quad_values_scale_factor.npy"), 1.0))
    znear = args.min_depth_fac * depth_range * 0.9
    zfar = args.max_depth_fac * depth_range * 1.1

    if args.tof_permutation:
        perm = np.array([int(i) for i in args.tof_permutation.split(",")])
    elif os.path.exists(os.path.join(path, "tof_permutation.npy")):
        perm = np.load(os.path.join(path, "tof_permutation.npy"))
    else:
        perm = np.arange(4)

    color_shape = np.load(os.path.join(path, "color", "0000.npy")).shape
    quad_shape = np.load(os.path.join(path, "tofType0", "0000.npy")).shape

    color_stack, tof_stack = [], []
    for fid in range(args.total_num_views):
        cp = os.path.join(path, "color", f"{fid:04d}.npy")
        c = np.load(cp) if os.path.exists(cp) else np.zeros(color_shape, np.float32)
        color_stack.append(scale_image(c, args.color_scale_factor))
        tp = os.path.join(path, "synthetic_tof", f"{fid:04d}.npy")
        t = (np.load(tp) if os.path.exists(tp)
             else np.zeros((quad_shape[0], quad_shape[1], 3), np.float32))
        tof_stack.append(scale_image(t, args.tof_scale_factor))
    color_stack = normalize_im_max(np.stack(color_stack)).astype(np.float32)
    tof_stack = normalize_im_max(np.stack(tof_stack)).astype(np.float32)

    cams = []
    for fid in range(args.total_num_views):
        K, Kt = col_K[fid], tof_K[fid]
        quads = []
        last_int = (fid // 4) * 4
        for t in range(4):
            q = np.load(os.path.join(path, f"tofType{t}",
                                     f"{last_int + t:04d}.npy")) * quad_scale
            quads.append(scale_image(q, args.tof_scale_factor))
        quads = np.stack(quads, 0).astype(np.float32)

        def _flow(name):
            p = os.path.join(path, name, f"flow_{fid:04d}.npy")
            if os.path.exists(p):
                f = np.load(p).transpose(1, 2, 0)
                return scale_image(f, args.color_scale_factor).astype(np.float32)
            return None

        dp = os.path.join(path, "synthetic_depth", f"{fid:04d}.npy")
        dist = (scale_image(np.load(dp), args.tof_scale_factor, nearest=True)
                if os.path.exists(dp) else None)

        cams.append(CameraRecord(
            uid=fid, frame_id=fid,
            R=np.transpose(col_E[fid, :3, :3]), T=col_E[fid, :3, 3],
            fov_x=_fov(args.color_image_width, K[0, 0]),
            fov_y=_fov(args.color_image_height, K[1, 1]),
            fx=K[0, 0] * args.color_scale_factor,
            fy=K[1, 1] * args.color_scale_factor,
            cx=K[0, 2] * args.color_scale_factor,
            cy=K[1, 2] * args.color_scale_factor,
            width=int(args.color_image_width * args.color_scale_factor),
            height=int(args.color_image_height * args.color_scale_factor),
            image=color_stack[fid],
            R_tof=np.transpose(tof_E[fid, :3, :3]), T_tof=tof_E[fid, :3, 3],
            fov_x_tof=_fov(args.tof_image_width, Kt[0, 0]),
            fov_y_tof=_fov(args.tof_image_height, Kt[1, 1]),
            fx_tof=Kt[0, 0] * args.tof_scale_factor,
            fy_tof=Kt[1, 1] * args.tof_scale_factor,
            cx_tof=Kt[0, 2] * args.tof_scale_factor,
            cy_tof=Kt[1, 2] * args.tof_scale_factor,
            tof_width=int(args.tof_image_width * args.tof_scale_factor),
            tof_height=int(args.tof_image_height * args.tof_scale_factor),
            tof_image=tof_stack[fid],
            distance_image=dist,
            quads=quads,
            forward_flow=_flow("forward_flow_2"),
            backward_flow=_flow("backward_flow_2"),
            znear=float(znear), zfar=float(zfar),
            depth_range=depth_range, phase_offset=phase_offset,
            dc_offset=dc_offset,
        ))

    pcd = _init_pcd_ftorf(path, cams, args, depth_range, phase_offset)
    return SceneData(
        scene_type="ftorf", train_cameras=cams, test_cameras=cams,
        spiral_cameras=[],
        scene_extent=depth_range * 0.55,
        cameras_extent=_camera_centers_extent(cams),
        tof_permutation=perm, tof_inverse_permutation=np.argsort(perm),
        depth_range=depth_range, phase_offset=phase_offset,
        dc_offset=dc_offset, znear=float(znear), zfar=float(zfar), **pcd,
    )


def _init_pcd_ftorf(path, cams, args, depth_range, phase_offset):
    mn, mx = _frustum_bounds(cams)
    if args.init_method == "random":
        n = args.num_points
        xyz = np.random.uniform(mn, mx, (n, 3))
        phases = np.random.random((n, 1)).astype(np.float32) * 2.0 * np.pi
        amplitudes = np.full((n, 1), args.initial_amplitude, np.float32)
    else:  # phase: canonical (first) integration frame, hardcoded unwrap
        xyz, _, amplitudes = _phase_backproject(
            cams[0], depth_range, phase_offset,
            args.phase_resolution_stride, True)
        phases = np.zeros((xyz.shape[0], 1), np.float32)

    n = xyz.shape[0]
    if args.init_static_dynamic_separation:
        xyz = np.concatenate([xyz, np.random.uniform(mn, mx, (n, 3))], 0)
        phases = np.concatenate([phases, phases], 0)
        amplitudes = np.concatenate([amplitudes, amplitudes], 0)
        seg = np.concatenate([
            np.repeat(np.array([[0.0, 0.0, 1.0]]), n, 0),  # static
            np.repeat(np.array([[1.0, 0.0, 0.0]]), n, 0),  # dynamic
        ], 0)
    else:
        seg = np.repeat(np.array([[1.0, 0.0, 0.0]]), n, 0)

    # F-ToRF initializes colors to the seg colors (dataset_readers.py:996)
    colors = seg.copy()
    return dict(points=xyz.astype(np.float32), colors=colors.astype(np.float32),
                phases=phases.astype(np.float32),
                amplitudes=amplitudes.astype(np.float32),
                seg_colors=seg.astype(np.float32))


def _color_only_record(uid, R, T, fov_x, fov_y, width, height, image,
                       distance=None, znear=0.01, zfar=100.0):
    """Camera with no separate ToF sensor: tof camera mirrors color
    (gaussian_renderer/__init__.py:78-79 falls back the same way)."""
    from gftorf_tpu_torch.ops.transforms import fov2focal

    fx, fy = fov2focal(fov_x, width), fov2focal(fov_y, height)
    return CameraRecord(
        uid=uid, frame_id=uid,
        R=R, T=T, fov_x=fov_x, fov_y=fov_y, fx=fx, fy=fy,
        cx=width / 2.0, cy=height / 2.0, width=width, height=height,
        image=image,
        R_tof=R, T_tof=T, fov_x_tof=fov_x, fov_y_tof=fov_y,
        fx_tof=fx, fy_tof=fy, cx_tof=width / 2.0, cy_tof=height / 2.0,
        tof_width=width, tof_height=height, tof_image=None,
        distance_image=distance, znear=znear, zfar=zfar,
    )


def _read_colmap_image(path: str) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))``: a PNG decoded by
    ``utils/image_io.py``; any other format (a JPEG) by PIL, the one image
    library the port imports, and only here. Without PIL such an image
    raises an ImportError that names it."""
    if is_png(path):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: not a PNG. The port decodes PNG itself and any other "
            f"image format (JPEG) only through PIL, which is not installed; "
            f"convert the images to PNG or install Pillow") from e
    return np.asarray(Image.open(path))


def read_colmap_scene(path: str, args: ModelParams, eval_split: bool,
                      llffhold: int = 8) -> SceneData:
    """readColmapSceneInfo (dataset_readers.py:191-238)."""
    from gftorf_tpu_torch.data.colmap import (
        qvec2rotmat,
        read_cameras_binary,
        read_cameras_text,
        read_images_binary,
        read_images_text,
        read_points3d_binary,
        read_points3d_text,
    )
    from gftorf_tpu_torch.ops.transforms import focal2fov

    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = read_images_binary(os.path.join(sparse, "images.bin"))
        intr = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = read_images_text(os.path.join(sparse, "images.txt"))
        intr = read_cameras_text(os.path.join(sparse, "cameras.txt"))

    img_dir = os.path.join(path, args.images or "images")
    cams = []
    for key in sorted(extr, key=lambda k: extr[k].name):
        e = extr[key]
        c = intr[e.camera_id]
        if c.model == "SIMPLE_PINHOLE":
            fov_x = focal2fov(c.params[0], c.width)
            fov_y = focal2fov(c.params[0], c.height)
        elif c.model == "PINHOLE":
            fov_x = focal2fov(c.params[0], c.width)
            fov_y = focal2fov(c.params[1], c.height)
        else:
            raise ValueError(f"unsupported colmap model {c.model}")
        img = np.asarray(
            _read_colmap_image(os.path.join(img_dir, os.path.basename(e.name))),
            np.float32,
        )[..., :3] / 255.0
        cams.append(_color_only_record(
            uid=len(cams), R=np.transpose(qvec2rotmat(e.qvec)),
            T=np.array(e.tvec), fov_x=fov_x, fov_y=fov_y,
            width=int(c.width), height=int(c.height), image=img,
        ))

    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, cams

    try:
        xyz, rgb, _ = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    except FileNotFoundError:
        xyz, rgb, _ = read_points3d_text(os.path.join(sparse, "points3D.txt"))

    extent = _camera_centers_extent(train)
    n = xyz.shape[0]
    return SceneData(
        scene_type="colmap", train_cameras=train, test_cameras=test,
        spiral_cameras=[],
        points=xyz.astype(np.float32), colors=(rgb / 255.0).astype(np.float32),
        phases=np.zeros((n, 1), np.float32),
        amplitudes=np.full((n, 1), args.initial_amplitude, np.float32),
        seg_colors=np.zeros((n, 3), np.float32),  # all static
        scene_extent=extent, cameras_extent=extent,
        tof_permutation=np.arange(4), tof_inverse_permutation=np.arange(4),
        depth_range=args.depth_range, phase_offset=0.0, dc_offset=0.0,
        znear=0.01, zfar=100.0,
    )


def read_blender_scene(path: str, args: ModelParams, eval_split: bool,
                       extension: str = ".png") -> SceneData:
    """readNerfSyntheticInfo (dataset_readers.py:241-340)."""
    import json

    from gftorf_tpu_torch.ops.transforms import focal2fov, fov2focal

    def load_split(transforms):
        cams = []
        with open(os.path.join(path, transforms)) as f:
            contents = json.load(f)
        fov_x = contents["camera_angle_x"]
        bg = args.bg_color[0] if args.bg_color else 0.0
        for idx, fr in enumerate(contents["frames"]):
            c2w = np.array(fr["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            # PIL's Image.open(...).convert("RGBA")
            img = read_png(os.path.join(path, fr["file_path"] + extension),
                           mode="RGBA").astype(np.float32) / 255.0
            rgb = img[..., :3] * img[..., 3:] + bg * (1 - img[..., 3:])
            h, w = rgb.shape[:2]
            fov_y = focal2fov(fov2focal(fov_x, w), h)
            cams.append(_color_only_record(
                uid=len(cams), R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
                fov_x=fov_x, fov_y=fov_y, width=w, height=h,
                image=rgb.astype(np.float32),
            ))
        return cams

    train = load_split("transforms_train.json")
    test = load_split("transforms_test.json")
    if not eval_split:
        train = train + test
        test = train

    n = args.num_points
    xyz = np.random.random((n, 3)) * 2.6 - 1.3
    extent = _camera_centers_extent(train)
    return SceneData(
        scene_type="blender", train_cameras=train, test_cameras=test,
        spiral_cameras=[],
        points=xyz.astype(np.float32),
        colors=np.full((n, 3), 0.5, np.float32),
        phases=(np.random.random((n, 1)) * 2 * np.pi).astype(np.float32),
        amplitudes=np.full((n, 1), 0.5, np.float32),
        seg_colors=np.zeros((n, 3), np.float32),
        scene_extent=extent, cameras_extent=extent,
        tof_permutation=np.arange(4), tof_inverse_permutation=np.arange(4),
        depth_range=args.depth_range, phase_offset=0.0, dc_offset=0.0,
        znear=0.01, zfar=100.0,
    )


def read_scene(path: str, args: ModelParams, eval_split: bool) -> SceneData:
    t = detect_scene_type(path)
    if t == "torf":
        return read_torf_scene(path, args, eval_split)
    if t == "ftorf":
        return read_ftorf_scene(path, args)
    if t == "colmap":
        return read_colmap_scene(path, args, eval_split)
    if t == "blender":
        return read_blender_scene(path, args, eval_split)
    raise NotImplementedError(f"scene type {t} not yet supported")
