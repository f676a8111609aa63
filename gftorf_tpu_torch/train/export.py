"""Inference artifacts: PLYs, offsets and deform weights, written and
loaded.

Port of ``gftorf_tpu/train/export.py`` (Scene.save, scene/__init__.py:
127-136): ``point_cloud.ply`` (the SIBR-compatible subset),
``point_cloud_full.ply`` (adds the phase/amp SH and seg colors),
``phase_offset.npy`` / ``dc_offset.npy`` and the ``deform_model.npz``
pytree of the deform MLP, in the JAX package's layout. PLY attribute names
are those of the reference's GaussianModel.save_ply
(gaussian_model.py:315-367), so either package and the reference's
tooling open the other's models.
"""

from __future__ import annotations

import os

import numpy as np

from gftorf_tpu_torch.models.deform import DeformConfig, DeformNetwork
from gftorf_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from gftorf_tpu_torch.utils.ply import read_ply, write_ply
from gftorf_tpu_torch.weights import (
    deform_dict_to_numpy,
    deform_params_from_numpy,
    gaussian_params_from_numpy,
    gaussian_params_to_numpy,
)

# jax.tree.flatten orders a dict's leaves by sorted key.
_HEADS_SORTED = tuple(sorted(("xyz", "rot", "r", "g", "b", "a")))


def gaussian_ply_props(params, alive, full: bool) -> dict:
    """Ordered property dict of the alive rows, for a PLY."""
    idx = np.where(alive.cpu().numpy())[0]
    p = {k: v[idx] for k, v in gaussian_params_to_numpy(params).items()
         if k not in ("phase_offset", "dc_offset")}
    n = len(idx)
    props = {}
    props["x"], props["y"], props["z"] = p["xyz"].T.astype(np.float32)
    for name in ("nx", "ny", "nz"):
        props[name] = np.zeros(n, np.float32)
    # colors: (N, M, 3) -> dc (3) + rest (3*(M-1)), channel-major like the
    # reference's transpose(1, 2).flatten (gaussian_model.py:345-346)
    sh = p["sh_color"]
    m = sh.shape[1]
    for i in range(3):
        props[f"f_dc_{i}"] = sh[:, 0, i].astype(np.float32)
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i].astype(np.float32)
    props["opacity"] = p["opacity"][:, 0].astype(np.float32)
    for i in range(p["scaling"].shape[1]):
        props[f"scale_{i}"] = p["scaling"][:, i].astype(np.float32)
    for i in range(4):
        props[f"rot_{i}"] = p["rotation"][:, i].astype(np.float32)
    if full:
        for name in ("phase", "amp"):
            sh_pa = p[f"sh_{name}"]
            props[f"{name}_f_dc_0"] = sh_pa[:, 0].astype(np.float32)
            for i in range(m - 1):
                props[f"{name}_f_rest_{i}"] = sh_pa[:, 1 + i].astype(np.float32)
        for i in range(3):
            props[f"f_seg_color_{i}"] = p["seg_color"][:, i].astype(np.float32)
    return props


def save_scene_artifacts(trainer, iteration: int) -> str:
    """Write point_cloud/iteration_N/ under the model path; returns it."""
    out = os.path.join(trainer.cfg.model.model_path,
                       f"point_cloud/iteration_{iteration}")
    os.makedirs(out, exist_ok=True)
    params, alive = trainer.model.params, trainer.model.aux.alive
    write_ply(os.path.join(out, "point_cloud.ply"),
              gaussian_ply_props(params, alive, full=False))
    write_ply(os.path.join(out, "point_cloud_full.ply"),
              gaussian_ply_props(params, alive, full=True))
    np.save(os.path.join(out, "phase_offset.npy"),
            params.phase_offset.cpu().numpy())
    np.save(os.path.join(out, "dc_offset.npy"), params.dc_offset.cpu().numpy())
    save_pytree(os.path.join(out, "deform_model.npz"),
                deform_dict_to_numpy(trainer.deform))
    return out


def write_proxy_pcds(trainer, iteration: int, max_frames: int = 0) -> str:
    """Per-frame proxy point clouds: the GT ToF depth (red) and the
    rendered depth (blue) back-projected to world space, written as
    model_path/proxy_pcd/frame_N/input.ply beside cameras.json and a copy
    of the trained point cloud (the reference's depth-map proxy export,
    dataset_readers.py:608-713, 1005-1120 and scene/__init__.py:150-166).
    Frames render through ``render_sets.render_frame`` (one transfer a
    frame, no tile truncation); the back-projection runs on the host."""
    import json
    import shutil

    import torch

    from gftorf_tpu_torch.data.scene import camera_to_json, take_frame
    from gftorf_tpu_torch.ops.flow import distance_to_points3d
    from gftorf_tpu_torch.ops.tof import depth_from_tof
    from gftorf_tpu_torch.render_sets import render_frame

    model_path = trainer.cfg.model.model_path
    static = trainer._static_for(max(trainer.iteration, 1))
    frames = trainer.scene.train_frames
    cams = trainer.scene.data.train_cameras
    json_cams = [camera_to_json(i, c) for i, c in enumerate(cams)]
    trained_ply = os.path.join(model_path, "point_cloud",
                               f"iteration_{iteration}", "point_cloud.ply")

    count = len(cams) if not max_frames else min(len(cams), max_frames)
    # The split's GT depth, intrinsics and view matrices in one read each.
    gt_depth = depth_from_tof(
        torch.movedim(frames.gt_phasor[:count], 1, -1),
        frames.cam_tof.depth_range[:count, None, None],
        frames.phase_offset[:count, None, None]).cpu()
    ks = frames.intrinsics_tof[:count].cpu().tolist()
    views = frames.cam_tof.viewmatrix[:count].cpu()
    root = os.path.join(model_path, "proxy_pcd")
    for fid in range(count):
        frame = take_frame(frames, fid)._replace(
            frame_id=torch.tensor(cams[fid].frame_id, dtype=torch.int32))
        static, out, _ = render_frame(trainer, static, frame)
        (fx, _, cx), (_, fy, cy), _ = ks[fid]
        xyz = torch.cat([
            distance_to_points3d(d[None], views[fid], fx, fy, cx, cy)
            .reshape(3, -1).T
            for d in (gt_depth[fid], torch.from_numpy(out["depth"]))]).numpy()
        n_half = xyz.shape[0] // 2
        colors = np.zeros((2 * n_half, 3), np.uint8)
        colors[:n_half, 0] = 255  # input depth: red
        colors[n_half:, 2] = 255  # rendered depth: blue

        frame_dir = os.path.join(root, f"frame_{fid}")
        pc_dir = os.path.join(frame_dir, "point_cloud", f"iteration_{iteration}")
        os.makedirs(pc_dir, exist_ok=True)
        props = {}
        props["x"], props["y"], props["z"] = xyz.T.astype(np.float32)
        for name in ("nx", "ny", "nz"):
            props[name] = np.zeros(2 * n_half, np.float32)
        props["red"], props["green"], props["blue"] = colors.T
        props["phase"] = np.zeros(2 * n_half, np.float32)
        props["amplitude"] = np.zeros(2 * n_half, np.float32)
        for name in ("seg_red", "seg_green", "seg_blue"):
            props[name] = np.zeros(2 * n_half, np.uint8)
        write_ply(os.path.join(frame_dir, "input.ply"), props)
        with open(os.path.join(frame_dir, "cameras.json"), "w") as f:
            json.dump(json_cams, f, indent=4)
        if os.path.exists(trained_ply):
            shutil.copy(trained_ply, os.path.join(pc_dir, "point_cloud.ply"))
    return root


def load_gaussians_from_ply(path: str, sh_degree: int = 3, device=None):
    """Load a point_cloud_full.ply into GaussianParams, like
    GaussianModel.load_ply (gaussian_model.py:378-454). ``device=None``
    means the CUDA card."""
    props = read_ply(path)
    n = len(props["x"])
    m = (sh_degree + 1) ** 2
    xyz = np.stack([props["x"], props["y"], props["z"]], -1)

    sh_color = np.zeros((n, m, 3), np.float32)
    for i in range(3):
        sh_color[:, 0, i] = props[f"f_dc_{i}"]
    rest = np.stack(
        [props[f"f_rest_{i}"] for i in range(3 * (m - 1))], -1
    ).reshape(n, 3, m - 1)
    sh_color[:, 1:, :] = rest.transpose(0, 2, 1)

    def seq(prefix, count):
        return np.stack([props[f"{prefix}_{i}"] for i in range(count)], -1)

    sh_phase = np.concatenate(
        [props["phase_f_dc_0"][:, None], seq("phase_f_rest", m - 1)], -1
    )
    sh_amp = np.concatenate(
        [props["amp_f_dc_0"][:, None], seq("amp_f_rest", m - 1)], -1
    )
    n_scale = len([k for k in props if k.startswith("scale_")])
    seg = (seq("f_seg_color", 3) if "f_seg_color_0" in props
           else np.zeros((n, 3), np.float32))
    return gaussian_params_from_numpy(
        dict(
            xyz=xyz, sh_color=sh_color, sh_phase=sh_phase, sh_amp=sh_amp,
            scaling=seq("scale", n_scale), rotation=seq("rot", 4),
            opacity=props["opacity"][:, None], seg_color=seg,
            phase_offset=np.zeros((1,)), dc_offset=np.zeros((1,)),
        ),
        device=device,
    )


def load_deform_model(path: str, config: DeformConfig,
                      device=None) -> DeformNetwork:
    """Load ``deform_model.npz`` (``save_pytree`` of the JAX
    ``DeformParams``). Its leaves are in ``jax.tree.flatten`` order: the
    ``hidden_w`` tuple, then ``hidden_b``, then ``head_w`` and ``head_b``,
    each dict in sorted key order."""
    leaves, _ = load_pytree(path)
    d = config.depth
    if len(leaves) != 2 * d + 2 * len(_HEADS_SORTED):
        raise ValueError(f"{path}: {len(leaves)} leaves do not fit a deform "
                         f"MLP of depth {d}")
    heads = 2 * d
    nh = len(_HEADS_SORTED)
    head_w = dict(zip(_HEADS_SORTED, leaves[heads:heads + nh]))
    head_b = dict(zip(_HEADS_SORTED, leaves[heads + nh:]))
    return deform_params_from_numpy(leaves[:d], leaves[d:heads], head_w,
                                    head_b, config, device=device)
