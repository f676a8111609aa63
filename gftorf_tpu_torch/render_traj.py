"""F-ToRF trajectory / quad-cadence visualization renderer of the port.

    python -m gftorf_tpu_torch.render_traj --model_path M [--iteration N]
        [--num_tracks 64] [--trail 12] [--max_frames K] [--device cpu]

Port of the root ``render_traj.py`` (the reference's
render_ftorf_viz_traj.py:836-858):

- quad-by-quad rendering: each training frame's depth and its rendered
  quad at the frame's slot (frame_id % 4) go to ``depth_quad/``,
  ``depth_q{k}/`` and ``quad_q{k}/``;
- Gaussian 3D-trajectory tracking: dynamic Gaussians picked at
  motion-magnitude quantiles, their deformed positions projected at each
  frame's time, and fading trails over the depth renders in ``traj/``;
- GIFs of both sequences and the website and quad-cadence panels.

Trails are drawn by ``draw_line`` (one pixel wide, numpy) in place of
PIL's ``ImageDraw.line``; images are written by ``utils/image_io.py``.
Frames render through ``render_sets.render_frame`` (one transfer a frame,
no tile truncation); the tracks' deform queries run in one batch.
``--device`` takes the place of ``--platform``: without it the run takes
the CUDA card and raises when there is none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def clip_segment(x0, y0, x1, y1, width, height):
    """The part of the segment inside the image's pixel area
    ([-0.5, width - 0.5] x [-0.5, height - 0.5]), Liang-Barsky; None when
    it misses the image or an end is not finite."""
    if not np.all(np.isfinite([x0, y0, x1, y1])):
        return None
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0 + 0.5), (dx, width - 0.5 - x0),
                 (-dy, y0 + 0.5), (dy, height - 0.5 - y0)):
        if p == 0:
            if q < 0:
                return None
        else:
            t = q / p
            if p < 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
    if t0 > t1:
        return None
    return x0 + t0 * dx, y0 + t0 * dy, x0 + t1 * dx, y0 + t1 * dy


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Draw a one-pixel line from ``p0`` to ``p1`` (x, y floats) into the
    (H, W, 3) uint8 ``img`` in place: one pixel per step along the major
    axis, each the nearest pixel to the segment there."""
    h, w = img.shape[:2]
    seg = clip_segment(float(p0[0]), float(p0[1]), float(p1[0]),
                       float(p1[1]), w, h)
    if seg is None:
        return
    x0, y0, x1, y1 = seg
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip(np.rint(x0 + t * (x1 - x0)).astype(int), 0, w - 1)
    ys = np.clip(np.rint(y0 + t * (y1 - y0)).astype(int), 0, h - 1)
    img[ys, xs] = color


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gftorf_tpu_torch trajectories")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--num_tracks", type=int, default=64)
    parser.add_argument("--trail", type=int, default=12)
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    return parser


def select_tracks(trainer, num_tracks: int) -> np.ndarray:
    """Rows of dynamic, alive Gaussians at the motion-magnitude quantiles
    0.5-0.99 of their deform displacement between t = 0 and t = 0.5
    (the reference picks quantile-based samples, :276-296)."""
    import torch

    from gftorf_tpu_torch.models.deform import apply_deform
    from gftorf_tpu_torch.models.gaussians import get_motion_mask

    params = trainer.model.params
    xyz_n = params.xyz / trainer.scene.scene_extent
    n = xyz_n.shape[0]
    with torch.no_grad():
        d0 = apply_deform(trainer.deform, trainer.deform_cfg, xyz_n,
                          torch.zeros((n, 1), device=xyz_n.device))[0]
        d1 = apply_deform(trainer.deform, trainer.deform_cfg, xyz_n,
                          torch.full((n, 1), 0.5, device=xyz_n.device))[0]
    motion = (get_motion_mask(params) & trainer.model.aux.alive).cpu().numpy()
    mag = np.linalg.norm((d1 - d0).cpu().numpy(), axis=-1) * motion
    idx_pool = np.where(motion & (mag > 0))[0]
    if idx_pool.size == 0:
        idx_pool = np.where(motion)[0]
    if idx_pool.size == 0:
        print("no dynamic gaussians to track")
        return np.array([], np.int64)
    qs = np.quantile(mag[idx_pool], np.linspace(0.5, 0.99, num_tracks))
    return np.array([idx_pool[np.argmin(np.abs(mag[idx_pool] - q))]
                     for q in qs])


def track_points(trainer, idx_sel: np.ndarray, n_frames: int,
                 denom: int) -> np.ndarray:
    """(n_frames, len(idx_sel), 3) deformed world positions of the tracked
    Gaussians at t = fid / denom, in one deform query."""
    import torch

    from gftorf_tpu_torch.models.deform import apply_deform

    params = trainer.model.params
    sel = torch.as_tensor(idx_sel, device=params.xyz.device)
    xyz = params.xyz[sel]
    k = len(idx_sel)
    t = (torch.arange(n_frames, device=xyz.device, dtype=torch.float32)
         / denom).repeat_interleave(k)[:, None]
    with torch.no_grad():
        d_xyz = apply_deform(trainer.deform, trainer.deform_cfg,
                             (xyz / trainer.scene.scene_extent).repeat(n_frames, 1),
                             t)[0]
    return (xyz.cpu().numpy()[None]
            + d_xyz.cpu().numpy().reshape(n_frames, k, 3))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from gftorf_tpu_torch.data.scene import take_frame
    from gftorf_tpu_torch.render_sets import (
        GIF_FRAME_S,
        load_trained,
        render_frame,
        split_host_values,
    )
    from gftorf_tpu_torch.utils.image_io import write_gif, write_png
    from gftorf_tpu_torch.utils.viz import (
        depth_to_disp_viz_window,
        paper_viz_bounds,
        to8b,
    )
    from gftorf_tpu_torch.video_panel import (
        create_quad_cadence_panel,
        create_website_panel,
    )

    trainer, cfg, it = load_trained(args.model_path, args.iteration, args.device)
    out_dir = os.path.join(args.model_path, f"traj_{it}")
    os.makedirs(os.path.join(out_dir, "depth_quad"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "traj"), exist_ok=True)
    for q in range(4):
        os.makedirs(os.path.join(out_dir, f"depth_q{q}"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, f"quad_q{q}"), exist_ok=True)
    inv_perm = list(trainer.scene.tof_inverse_permutation)

    scene = trainer.scene
    static = trainer._static_for(max(trainer.iteration, 1))
    # paper disparity window keyed by scene name (torf_utils.py:474-495)
    scene_name = os.path.basename(cfg.model.source_path.rstrip("/"))
    viz_lo, viz_hi, _ = paper_viz_bounds(scene_name)
    n_frames = scene.num_train if not args.max_frames else min(
        scene.num_train, args.max_frames
    )
    denom = max(cfg.model.total_num_views - 1, 1)

    idx_sel = select_tracks(trainer, args.num_tracks)
    frames = scene.train_frames
    frame_ids, _ = split_host_values(frames, n_frames)
    if idx_sel.size:
        pts_all = track_points(trainer, idx_sel, n_frames, denom)
        ks = frames.intrinsics_tof[:n_frames].cpu().numpy()
        views = frames.cam_tof.viewmatrix[:n_frames].cpu().numpy()

    # --- per-frame renders + tracked 2D positions
    depth_frames, traj_frames = [], []
    tracks2d = []
    for fid in range(n_frames):
        frame = take_frame(frames, fid)._replace(
            frame_id=torch.tensor(frame_ids[fid], dtype=torch.int32))
        static, out, _ = render_frame(trainer, static, frame)
        dimg = depth_to_disp_viz_window(out["depth"], viz_lo, viz_hi)
        write_png(os.path.join(out_dir, "depth_quad", f"{fid:04d}.png"), dimg)
        depth_frames.append(dimg)

        # per-quad-slot sequences (reference depth_qK / quad_qK at fps/4)
        q = frame_ids[fid] % 4
        write_png(os.path.join(out_dir, f"depth_q{q}", f"{fid:04d}.png"), dimg)
        quad_im = np.abs(out["phasor"][3:][inv_perm][q])
        quad_im = quad_im / max(float(quad_im.max()), 1e-6)
        write_png(os.path.join(out_dir, f"quad_q{q}", f"{fid:04d}.png"),
                  to8b(quad_im))

        if idx_sel.size:
            view_t = views[fid]
            cam = pts_all[fid] @ view_t[:3, :3] + view_t[3, :3]
            uv = ks[fid] @ cam.T
            uv = (uv[:2] / np.maximum(uv[2:], 1e-6)).T
            tracks2d.append(uv)

            # draw fading trails (reference :73-114)
            img = depth_frames[-1].copy()
            start = max(0, len(tracks2d) - args.trail)
            for t_i in range(start + 1, len(tracks2d)):
                fade = (t_i - start) / max(len(tracks2d) - start, 1)
                col = (int(255 * fade), int(50 * fade), int(255 * (1 - fade)))
                for j in range(idx_sel.size):
                    draw_line(img, tracks2d[t_i - 1][j], tracks2d[t_i][j], col)
            traj_frames.append(img)
            write_png(os.path.join(out_dir, "traj", f"{fid:04d}.png"), img)

    if len(depth_frames) > 1:
        write_gif(os.path.join(out_dir, "depth_quad.gif"), depth_frames,
                  GIF_FRAME_S)
    if len(traj_frames) > 1:
        write_gif(os.path.join(out_dir, "traj.gif"), traj_frames, GIF_FRAME_S)

    create_website_panel(args.model_path, it, traj_dir=out_dir)
    create_quad_cadence_panel(args.model_path, it, traj_dir=out_dir)
    print(f"trajectory renders written to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
