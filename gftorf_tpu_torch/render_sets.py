"""Render trained models to per-channel image sequences.

Port of ``gftorf_tpu/render_sets.py`` (the reference's render.py:36-209):
for each split, query the deformation at the frame time, render colour
and phasor through the ToF and colour cameras, and write the real, imag,
amp, depth, depth_norm, depth_tof, color, dd and quad channels as PNGs,
the depth and depth_tof maps as ``.npy``, and a GIF of each channel; for
ToRF scenes also the spiral and freeze-frame spiral paths; then the GT
``input/`` split and the comparison panel.

Where the port differs from the JAX package:

- Images are written by ``utils/image_io.py`` and coloured by
  ``utils/viz.py``: no imageio, PIL, cv2 or matplotlib on this path.
- Each frame's outputs come to the host in one transfer after the frame;
  frame ids and phase offsets are read once a split.
- A frame whose deepest tile overflows the loaded Trainer's
  ``max_per_tile`` (``cfg.tpu.max_per_tile``, not the cap the training
  run grew to) is rendered again at a cap that holds it, by the
  Trainer's own rule (``train/occupancy.py``: 1.35x the deepest tile,
  then the flat stream on CUDA past ``max_per_tile_limit``), and later
  frames keep the grown cap. The JAX package renders such a frame with
  the tile's excess instances dropped (ROADMAP, Queue 3).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.scene import Scene, take_frame
from gftorf_tpu_torch.models.deform import apply_deform, deform_params
from gftorf_tpu_torch.models.gaussians import (
    AdamState,
    GaussianAux,
    GaussianModelState,
    tree_map,
)
from gftorf_tpu_torch.ops.tof import depth_from_tof
from gftorf_tpu_torch.train.evaluate import eval_frame
from gftorf_tpu_torch.train.export import load_deform_model, load_gaussians_from_ply
from gftorf_tpu_torch.train.loop import Trainer
from gftorf_tpu_torch.utils.image_io import write_gif, write_png
from gftorf_tpu_torch.utils.runtime import resolve_device
from gftorf_tpu_torch.utils.trace import span
from gftorf_tpu_torch.utils.viz import (
    depth_to_disp_viz,
    normalize_im,
    phasor2real_img_amp,
    to8b,
)

GIF_FRAME_S = 0.08


def _latest_iteration(model_path: str) -> int:
    pc = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[1]) for d in os.listdir(pc)
             if d.startswith("iteration_")]
    return max(iters)


def load_trained(model_path: str, iteration: int = -1, device=None):
    """Rebuild a Trainer in inference mode from saved artifacts (either
    package's); returns (trainer, cfg, iteration). ``device=None`` means
    the CUDA card, where the Trainer's start-up fit check of the dense
    backward kernel runs once (and launches nothing)."""
    dev = resolve_device(device)
    cfg = Config.from_json(os.path.join(model_path, "cfg_args_full.json"))
    cfg.model.model_path = model_path
    if iteration < 0:
        iteration = _latest_iteration(model_path)
    art = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")

    def offset(name):
        return torch.as_tensor(np.load(os.path.join(art, name)),
                               dtype=torch.float32, device=dev)

    scene = Scene(cfg, init_model=False, device=dev)
    params = load_gaussians_from_ply(os.path.join(art, "point_cloud_full.ply"),
                                     cfg.model.sh_degree, device=dev)
    params = params._replace(phase_offset=offset("phase_offset.npy"),
                             dc_offset=offset("dc_offset.npy"))
    n = params.xyz.shape[0]
    zeros = tree_map(torch.zeros_like, params)
    scene.model_state = GaussianModelState(
        params=params,
        aux=GaussianAux(
            alive=torch.ones((n,), dtype=torch.bool, device=dev),
            max_radii2d=torch.zeros((n,), device=dev),
            xyz_grad_accum=torch.zeros((n,), device=dev),
            denom=torch.zeros((n,), device=dev),
        ),
        adam=AdamState(mu=zeros, nu=zeros,
                       step=torch.zeros((), dtype=torch.int32, device=dev)),
    )
    trainer = Trainer(cfg, scene=scene, startup_artifacts=False, device=dev)
    trainer.iteration = iteration
    trainer.active_sh_degree = cfg.model.sh_degree
    trainer.deform = deform_params(load_deform_model(
        os.path.join(art, "deform_model.npz"), trainer.deform_cfg, device=dev))
    return trainer, cfg, iteration


def split_host_values(frames, count: int):
    """The first ``count`` frames' ids and phase offsets, read from the
    device once for the split."""
    ids = frames.frame_id[:count].cpu().tolist()
    offsets = frames.phase_offset[:count].cpu().tolist()
    return ids, offsets


def render_frame(trainer, static, frame):
    """Render one frame; returns (static, host arrays, record). The record
    holds the first render's overflow counters (``tile_overflow``,
    ``tile_max``, ``dup_overflow``, ``rendered_max``), the last one's
    ``tile_overflow_final``, the number of ``renders`` and the capacities
    of the last (``max_per_tile``, ``dup_factor``, ``flat_stream``).

    The frame's outputs and overflow counters reach the host in one
    transfer. On an overflow the Trainer's capacities grow and the frame
    is rendered again; the returned static carries the grown ones.
    """
    occupancy = trainer.occupancy
    with span("serve.frame"):
        deform = functools.partial(apply_deform, trainer.deform,
                                   trainer.deform_cfg)
        first, renders = None, 0
        while True:
            renders += 1
            _, out_color, out_tof = eval_frame(
                static, trainer.model.params, deform, trainer.model.aux.alive,
                frame, device=trainer.device)
            parts = {"color": out_color.color, "phasor": out_tof.phasor,
                     "depth": out_tof.depth[0], "dd": out_tof.depth_distortion[0]}
            with span("serve.to_host"):
                counters = torch.stack([
                    torch.stack([o.tile_overflow.to(torch.int32),
                                 o.tile_max.to(torch.int32),
                                 o.dup_overflow.to(torch.int32),
                                 o.num_rendered.to(torch.int32)])
                    for o in (out_tof, out_color)])
                flat = torch.cat([t.reshape(-1) for t in parts.values()]
                                 + [counters.reshape(-1).view(torch.float32)])
                host = flat.cpu().numpy()
                arrays, pos = {}, 0
                for name, t in parts.items():
                    arrays[name] = host[pos:pos + t.numel()].reshape(t.shape)
                    pos += t.numel()
                c = host[pos:].view(np.int32).reshape(2, 4)
                metrics = {"tile_overflow": int(c[:, 0].max()),
                           "tile_max": int(c[:, 1].max()),
                           "dup_overflow": int(c[:, 2].max()),
                           "rendered_max": int(c[:, 3].max())}
            if first is None:
                first = metrics
            if not occupancy.overflowed(metrics):
                break
            grew = occupancy.grow(metrics, trainer.render_rows)
            print(f"[render] frame {int(frame.frame_id)}: capacity overflow -> "
                  f"{', '.join(grew)}, rendering it again", flush=True)
            static = occupancy.apply(static)
        occupancy.warn_truncation(trainer.iteration, metrics)
        cfg = static.config_tof
        record = dict(first, tile_overflow_final=metrics["tile_overflow"],
                      renders=renders, max_per_tile=cfg.max_per_tile,
                      dup_factor=cfg.dup_factor, flat_stream=cfg.flat_stream)
        return static, arrays, record


def _write_frame(out_dir, i, out, depth_range, phase_offset, use_quad):
    """Colour one rendered frame's channels and write its PNGs and
    ``.npy`` maps; returns the channel images."""
    color = np.moveaxis(out["color"], 0, -1)
    phasor3 = np.moveaxis(out["phasor"][:3], 0, -1)
    depth, dd = out["depth"], out["dd"]
    depth_tof = depth_from_tof(torch.from_numpy(phasor3), depth_range,
                               phase_offset).numpy()
    real, imag, amp = phasor2real_img_amp(phasor3)
    imgs = {
        "color": to8b(color),
        "real": to8b(np.abs(real)),
        "imag": to8b(np.abs(imag)),
        "amp": to8b(normalize_im(amp)),
        "depth": depth_to_disp_viz(depth, depth_range),
        "depth_norm": to8b(normalize_im(depth)),
        "depth_tof": depth_to_disp_viz(depth_tof, depth_range),
        "dd": to8b(normalize_im(dd)),
    }
    if use_quad:
        imgs["quad"] = to8b(normalize_im(np.abs(out["phasor"][3])))
    for ch, img in imgs.items():
        write_png(os.path.join(out_dir, ch, f"{i:04d}.png"), img)
    np.save(os.path.join(out_dir, "depth", f"{i:04d}.npy"), depth)
    np.save(os.path.join(out_dir, "depth_tof", f"{i:04d}.npy"), depth_tof)
    return imgs


def _write_gif(path, frames):
    if len(frames) > 1:
        write_gif(path, frames, GIF_FRAME_S)


def render_split(trainer, frames, n_frames, out_dir, cfg, max_frames=0,
                 write_video=True, static=None, frame_id_override=None):
    """Render a stacked frame split to per-channel sequences; returns one
    overflow record a frame.

    ``static`` overrides the step static (the spiral path retimes the
    deform query by replacing total_num_views); ``frame_id_override``
    pins the deform time to one frame for every camera (the reference's
    freeze-frame spiral, render.py:340-357).
    """
    os.makedirs(out_dir, exist_ok=True)
    if static is None:
        static = trainer._static_for(max(trainer.iteration, 1))
    static = trainer.occupancy.apply(static)
    chans = ["color", "real", "imag", "amp", "depth", "depth_norm",
             "depth_tof", "dd"]
    if cfg.opt.use_quad:
        chans.append("quad")
    for ch in chans:
        os.makedirs(os.path.join(out_dir, ch), exist_ok=True)
    gif_frames = {ch: [] for ch in chans}

    count = n_frames if not max_frames else min(n_frames, max_frames)
    depth_range = trainer.scene.data.depth_range
    frame_ids, frame_offsets = split_host_values(frames, count)
    param_offset = (float(trainer.model.params.phase_offset[0])
                    if cfg.opt.optimize_phase_offset else None)
    records = []
    for i in range(count):
        fid = frame_ids[i] if frame_id_override is None else frame_id_override
        frame = take_frame(frames, i)._replace(
            frame_id=torch.tensor(fid, dtype=torch.int32))
        static, out, rec = render_frame(trainer, static, frame)
        records.append(dict(rec, frame=i))
        imgs = _write_frame(out_dir, i, out, depth_range,
                            param_offset if param_offset is not None
                            else frame_offsets[i], cfg.opt.use_quad)
        for ch, img in imgs.items():
            gif_frames[ch].append(img)

    if write_video:
        for ch, fr in gif_frames.items():
            if fr:
                _write_gif(os.path.join(out_dir, f"{ch}.gif"), fr)
    return records


def render_input_split(trainer, frames, n_frames, out_dir, cfg,
                       max_frames=0):
    """Dump the GT observations as channel sequences (the reference's
    save_input, render.py:150-223): the 'Input' column of the panel."""
    count = n_frames if not max_frames else min(n_frames, max_frames)
    depth_range = trainer.scene.data.depth_range
    chans = ["color", "real", "imag", "amp", "depth", "depth_tof"]
    if cfg.opt.use_quad:
        chans += [f"quad_q{k}" for k in range(4)]
    for ch in chans:
        os.makedirs(os.path.join(out_dir, ch), exist_ok=True)
    _, frame_offsets = split_host_values(frames, count)
    for i in range(count):
        frame = take_frame(frames, i)
        parts = [frame.gt_phasor, frame.gt_image]
        if cfg.opt.use_quad:
            parts.append(frame.gt_quad[i % 4][None])
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        gt_phasor, color, quad = np.split(host, np.cumsum(
            [parts[0].numel(), parts[1].numel()]))
        gt_phasor = np.moveaxis(gt_phasor.reshape(parts[0].shape), 0, -1)
        color = np.moveaxis(color.reshape(parts[1].shape), 0, -1)
        depth_tof = depth_from_tof(torch.from_numpy(gt_phasor), depth_range,
                                   frame_offsets[i]).numpy()
        # same red/blue signed encoding as render_split, so the panel's
        # Input and Ours cells are directly comparable
        real, imag, amp = phasor2real_img_amp(gt_phasor)
        imgs = {
            "color": to8b(color),
            "real": to8b(np.abs(real)),
            "imag": to8b(np.abs(imag)),
            "amp": to8b(normalize_im(amp)),
            "depth": depth_to_disp_viz(depth_tof, depth_range),
            "depth_tof": depth_to_disp_viz(depth_tof, depth_range),
        }
        if cfg.opt.use_quad:
            # GT quad captured at this frame's slot (i%4): the staircase
            # panel's diagonal (render_ftorf_viz_traj.py save-input path).
            k = i % 4
            q = np.abs(quad.reshape(parts[2].shape[1:]))
            imgs[f"quad_q{k}"] = to8b(normalize_im(q))
        for ch, img in imgs.items():
            write_png(os.path.join(out_dir, ch, f"{i:04d}.png"), img)


def render_sets(model_path: str, iteration: int = -1, skip_train=False,
                skip_test=False, skip_video=False, max_frames=0, device=None):
    """Render a saved model's splits under model_path/renders_<it>/;
    returns that directory."""
    trainer, cfg, it = load_trained(model_path, iteration, device)
    return render_trained(trainer, cfg, it, skip_train, skip_test, skip_video,
                          max_frames)


def render_trained(trainer, cfg, it, skip_train=False, skip_test=False,
                   skip_video=False, max_frames=0):
    """``render_sets`` on a Trainer ``load_trained`` returned."""
    model_path = cfg.model.model_path
    base = os.path.join(model_path, f"renders_{it}")
    if not skip_test:
        render_split(trainer, trainer.scene.test_frames,
                     len(trainer.scene.data.test_cameras),
                     os.path.join(base, "test"), cfg, max_frames,
                     not skip_video)
    if not skip_train and (
        trainer.scene.test_frames is not trainer.scene.train_frames
    ):
        render_split(trainer, trainer.scene.train_frames,
                     trainer.scene.num_train, os.path.join(base, "train"),
                     cfg, max_frames, not skip_video)

    # Spiral + freeze-frame spiral paths, torf scenes only
    # (render.py:352-357): the spiral sweep plays scene time along the
    # path (denominator = num spiral views), the freeze-frame sweep pins
    # time to the middle training frame.
    if trainer.scene.scene_type == "torf" and trainer.scene.num_spiral:
        n_sp = trainer.scene.num_spiral
        spiral = trainer.scene.spiral_frames
        base_static = trainer._static_for(max(it, 1))
        st_spiral = dataclasses.replace(
            base_static, total_num_views=max(n_sp, 2)
        )
        render_split(trainer, spiral, n_sp,
                     os.path.join(base, "renders_spiral"), cfg, max_frames,
                     not skip_video, static=st_spiral)
        render_split(trainer, spiral, n_sp,
                     os.path.join(base, "freezeframe_spiral"), cfg,
                     max_frames, not skip_video, static=base_static,
                     frame_id_override=cfg.model.total_num_views // 2)

    if not skip_video and not skip_test:
        from gftorf_tpu_torch.video_panel import create_video_panel

        render_input_split(trainer, trainer.scene.test_frames,
                           len(trainer.scene.data.test_cameras),
                           os.path.join(model_path, "input"), cfg,
                           max_frames)
        create_video_panel(model_path, it,
                           scene_type=trainer.scene.scene_type)
    print(f"renders written to {base}")
    return base
