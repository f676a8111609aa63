"""Training-time visual debugging: predicted/GT/error channel dumps and
parameter histograms.

Port of ``gftorf_tpu/train/debug.py``: the reference's tmp_debug_* image
dumps (train.py:57-98, 287-398), written as PNGs by ``utils/image_io.py``
under model_path/tmp_debug_<channel>/ as {iteration:06d}_{frame:04d}.png,
and the TensorBoard histograms (train.py:595-601) as plain dicts for
train_log.jsonl.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from gftorf_tpu_torch.data.scene import take_frame
from gftorf_tpu_torch.models.deform import apply_deform
from gftorf_tpu_torch.models.gaussians import get_opacity, get_scaling
from gftorf_tpu_torch.ops.sh import sh2pa
from gftorf_tpu_torch.ops.tof import depth_from_tof
from gftorf_tpu_torch.train.evaluate import eval_frame
from gftorf_tpu_torch.utils.image_io import write_png
from gftorf_tpu_torch.utils.viz import (
    depth_to_disp_viz,
    normalize_im,
    phasor2real_img_amp,
    to8b,
)


def _err(pred, gt):
    return to8b(normalize_im(np.abs(pred - gt)))


def dump_debug_images(trainer, idx: int, iteration: int) -> None:
    """Render training camera ``idx`` and write predicted / GT / error
    images per channel under model_path/tmp_debug_*. The render and the
    frame's GT reach the host in one transfer."""
    model_path = trainer.cfg.model.model_path
    if not model_path:
        return
    static = trainer._static_for(max(iteration, 1))
    # The training step gates need_dd on the dd-loss schedule; the dump
    # always shows the real depth-distortion channel (the reference's
    # tmp_debug dumps are unconditional, train.py:287-398).
    if not static.config_tof.need_dd:
        static = dataclasses.replace(
            static,
            config_tof=dataclasses.replace(static.config_tof, need_dd=True))
    fid = trainer.scene.data.train_cameras[idx].frame_id
    frame = take_frame(trainer.scene.train_frames, idx)._replace(
        frame_id=torch.tensor(fid, dtype=torch.int32))
    deform = functools.partial(apply_deform, trainer.deform, trainer.deform_cfg)
    _, out_color, out_tof = eval_frame(
        static, trainer.model.params, deform, trainer.model.aux.alive, frame,
        device=trainer.device)
    use_quad = trainer.cfg.opt.use_quad
    parts = {"phasor": out_tof.phasor, "color": out_color.color,
             "depth": out_tof.depth[0], "dd": out_tof.depth_distortion[0],
             "gt_phasor": frame.gt_phasor, "gt_image": frame.gt_image,
             "gt_quad": frame.gt_quad[fid % 4],
             "phase_offset": frame.phase_offset.reshape(1)}
    host = torch.cat([t.reshape(-1) for t in parts.values()]).cpu().numpy()
    arr, pos = {}, 0
    for name, t in parts.items():
        arr[name] = host[pos:pos + t.numel()].reshape(t.shape)
        pos += t.numel()
    phasor, gt_phasor = arr["phasor"], arr["gt_phasor"]
    phase_offset = float(arr["phase_offset"][0])
    depth_range = trainer.scene.data.depth_range

    def tof_depth(ph):
        return depth_from_tof(torch.from_numpy(np.moveaxis(ph[:3], 0, -1)),
                              depth_range, phase_offset).numpy()

    # signed red/blue visualizations for pred+gt, errors on raw channels
    real_v, imag_v, amp = phasor2real_img_amp(np.moveaxis(phasor[:3], 0, -1))
    g_real_v, g_imag_v, g_amp = phasor2real_img_amp(np.moveaxis(gt_phasor, 0, -1))
    color = np.moveaxis(arr["color"], 0, -1)
    g_color = np.moveaxis(arr["gt_image"], 0, -1)
    depth = arr["depth"]
    phase_depth = tof_depth(phasor)
    # Scattering-phase diagnostics (train.py:63-66,196-198): amplitude
    # with the 1/d^2 falloff undone — amp * depth^2 — from the composited
    # depth and from the ToF phase depth, against GT.
    g_scat = g_amp * tof_depth(gt_phasor) ** 2
    scat = amp * depth**2
    scat_tof = amp * phase_depth**2

    imgs = {
        "real": (to8b(real_v), to8b(g_real_v), _err(phasor[0], gt_phasor[0])),
        "imag": (to8b(imag_v), to8b(g_imag_v), _err(phasor[1], gt_phasor[1])),
        "amp": (to8b(normalize_im(amp)), to8b(normalize_im(g_amp)),
                _err(amp, g_amp)),
        "color": (to8b(color), to8b(g_color), _err(color, g_color)),
        "depth": (depth_to_disp_viz(depth, depth_range), None, None),
        "dd": (to8b(normalize_im(arr["dd"])), None, None),
        "phase_depth": (depth_to_disp_viz(phase_depth, depth_range), None, None),
        "scattering_phase": (to8b(normalize_im(scat)), to8b(normalize_im(g_scat)),
                             _err(scat, g_scat)),
        "scattering_phase_tof_depth": (to8b(normalize_im(scat_tof)), None,
                                       _err(scat_tof, g_scat)),
    }
    if use_quad:
        inv = list(trainer.scene.tof_inverse_permutation)
        pred_q = phasor[3:][inv][fid % 4]
        gt_q = arr["gt_quad"]
        imgs["quad"] = (to8b(np.abs(pred_q)), to8b(np.abs(gt_q)),
                        _err(pred_q, gt_q))

    for ch, triple in imgs.items():
        for suffix, img in zip(("", "_gt", "_error"), triple):
            if img is None:
                continue
            d = os.path.join(model_path, f"tmp_debug_{ch}{suffix}")
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{iteration:06d}_{fid:04d}.png"), img)


def param_series(model) -> dict:
    """Per-live-Gaussian opacity, center distance, amplitude and mean
    scale as {name: 1-D np.ndarray}."""
    alive = model.aux.alive.cpu().numpy()
    params = model.params
    return {
        "opacity": get_opacity(params)[:, 0].cpu().numpy()[alive],
        "dist": np.linalg.norm(params.xyz.cpu().numpy()[alive], axis=-1),
        "amplitude": sh2pa(params.sh_amp[:, 0]).cpu().numpy()[alive],
        "scale": get_scaling(params).mean(-1).cpu().numpy()[alive],
    }


def param_histograms(model, bins: int = 32) -> dict:
    """{name: {"edges": [...], "counts": [...]}} of ``param_series``."""
    out = {}
    for name, vals in param_series(model).items():
        if vals.size == 0:
            out[name] = {"edges": [], "counts": []}
            continue
        counts, edges = np.histogram(vals, bins=bins)
        out[name] = {"edges": [round(float(e), 6) for e in edges],
                     "counts": [int(c) for c in counts]}
    return out
