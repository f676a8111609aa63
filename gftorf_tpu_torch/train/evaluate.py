"""Evaluation: port of ``gftorf_tpu/train/evaluate.py``, the
training_report metrics (train.py:508-603): ``eval_frame`` renders one
frame, ``evaluate_split`` averages a split's frames and
``evaluate_and_report`` reports the test and train splits."""

from __future__ import annotations

import functools

import torch

from gftorf_tpu_torch.models.deform import apply_deform
from gftorf_tpu_torch.ops.tof import depth_from_tof
from gftorf_tpu_torch.render.rasterize import rasterize
from gftorf_tpu_torch.train import losses as L
from gftorf_tpu_torch.train.step import (
    FrameData,
    StepStatic,
    _compose,
    _query_deform,
    _take_frame,
)
from gftorf_tpu_torch.utils.runtime import check_on


@torch.no_grad()
def eval_frame(static: StepStatic, params, deform, alive, frame: FrameData,
               device=None):
    """Render one frame (constant zero bg) and compute report metrics.

    Returns (metrics: name -> 0-d tensor, out_color, out_tof). The inputs
    must lie on ``device`` (None = the CUDA card).
    """
    dev = check_on(device, params.xyz, alive, frame.gt_image)
    n = params.xyz.shape[0]
    if static.dynamic_on:
        d_xyz, d_rot, d_sh, _, _, _ = _query_deform(
            static, deform, params, frame.frame_id, alive=alive)
    else:
        m = (static.deform.sh_degree + 1) ** 2
        d_xyz = torch.zeros((n, 3), device=dev)
        d_rot = torch.zeros((n, 4), device=dev)
        d_sh = torch.zeros((n, m, 3), device=dev)

    means3d, scales, rots, opac, shs, shs_p, include = _compose(
        static, params, d_xyz, d_rot, d_sh, alive)
    opac_inc = torch.where(include, opac, 0.0)
    zeros2d = torch.zeros((n, 2), device=dev)

    cc, ct = static.config_color, static.config_tof
    phase_offset = (params.phase_offset[0] if static.optimize_phase_offset
                    else frame.phase_offset)
    dc_offset = (params.dc_offset[0] if static.optimize_dc_offset
                 else frame.dc_offset)

    out_tof = rasterize(
        means3d, scales, rots, opac_inc, shs, shs_p, phase_offset, dc_offset,
        zeros2d, torch.zeros((7, ct.height, ct.width), device=dev),
        camera=frame.cam_tof, config=ct,
        active_sh_degree=static.active_sh_degree,
    )
    if static.single_camera:
        out_color = out_tof
    else:
        out_color = rasterize(
            means3d, scales, rots, opac_inc, shs, shs_p, phase_offset,
            dc_offset, zeros2d,
            torch.zeros((7, cc.height, cc.width), device=dev),
            camera=frame.cam_color, config=cc,
            active_sh_degree=static.active_sh_degree,
        )

    metrics = {
        "l1_color": L.l1_loss(out_color.color, frame.gt_image),
        "psnr_color": L.psnr(out_color.color, frame.gt_image),
    }
    if static.scene_type in ("torf", "ftorf"):
        phasor = out_tof.phasor
        if static.use_quad:
            k = int(frame.frame_id) % 4
            inv = list(static.tof_inverse_permutation)
            tof_gt = frame.gt_quad[k][None]
            tof_r = phasor[3:][inv][k][None]
        else:
            nph = static.num_phasor_channels
            tof_gt = frame.gt_phasor[:nph]
            tof_r = phasor[:nph]
        metrics["l1_p"] = L.l1_loss(tof_r, tof_gt)
        metrics["l2_p"] = L.l2_loss(tof_r, tof_gt)
        metrics["psnr_p"] = L.psnr(tof_r, tof_gt)

        depth_tof = depth_from_tof(
            torch.movedim(phasor[:3], 0, -1), frame.cam_tof.depth_range,
            phase_offset=phase_offset,
        )[None]
        metrics["l1_d"] = L.l1_loss(out_tof.depth, frame.gt_distance)
        metrics["l2_d"] = L.l2_loss(out_tof.depth, frame.gt_distance)
        metrics["l2_d_tof"] = L.l2_loss(depth_tof, frame.gt_distance)
        metrics["mae_d_tof"] = L.l1_loss(depth_tof, frame.gt_distance)
    return metrics, out_color, out_tof


def evaluate_split(trainer, frames: FrameData, n_frames: int,
                   max_frames: int = 0) -> dict:
    """Mean of ``eval_frame``'s metrics (and LPIPS when its weights are
    there, else ``lpips: None``) over the first frames of a split."""
    from gftorf_tpu_torch.utils.metrics import lpips, lpips_available

    static = trainer._static_for(trainer.iteration or 1)
    deform = functools.partial(apply_deform, trainer.deform, trainer.deform_cfg)
    params, alive = trainer.model.params, trainer.model.aux.alive
    use_lpips = lpips_available()
    totals, count = None, 0
    for i in range(n_frames if not max_frames else min(n_frames, max_frames)):
        frame = _take_frame(frames, i)
        metrics, out_color, _ = eval_frame(static, params, deform, alive, frame,
                                           device=trainer.device)
        # One host read a frame, in sorted key order as the JAX package's
        # jitted dict returns them.
        names = sorted(metrics)
        metrics = dict(zip(names, torch.stack([metrics[k] for k in names]).tolist()))
        if use_lpips:
            metrics["lpips"] = float(lpips(out_color.color, frame.gt_image))
        if totals is None:
            totals = dict(metrics)
        else:
            for k, v in metrics.items():
                totals[k] += v
        count += 1
    out = {k: v / count for k, v in totals.items()}
    if not use_lpips:
        out["lpips"] = None
    return out


def evaluate_and_report(trainer, max_frames: int = 0) -> dict:
    scene = trainer.scene
    out = {"test": evaluate_split(trainer, scene.test_frames,
                                  len(scene.data.test_cameras), max_frames)}
    if scene.test_frames is not scene.train_frames:
        out["train"] = evaluate_split(trainer, scene.train_frames,
                                      scene.num_train, max_frames)
    else:
        out["train"] = out["test"]
    return out
