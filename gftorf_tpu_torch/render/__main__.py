"""Render CLI of the port, the counterpart of the root ``render.py``.

    python -m gftorf_tpu_torch.render --model_path M [--iteration N]
        [--skip_train] [--skip_test] [--skip_video] [--max_frames K]
        [--proxy_pcd] [--device cpu]

Loads ``cfg_args_full.json`` and the trained PLY, offsets and deform
weights from the model path (either package's), renders the test and
train splits (and the spiral paths of ToRF scenes) and writes the tree
``render.py`` writes under ``renders_<it>/``, the ``input/`` split and the
comparison panel; ``--proxy_pcd`` adds ``proxy_pcd/frame_N/``. ``--device``
takes the place of ``--platform``: without it the run takes the CUDA card
and raises when there is none.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gftorf_tpu_torch rendering")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--max_frames", type=int, default=0)
    parser.add_argument("--proxy_pcd", action="store_true",
                        help="write per-frame GT-vs-rendered depth proxy "
                             "point clouds (proxy_pcd/frame_N/input.ply)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    return parser


def main(argv=None) -> str:
    """Render as ``render.py`` does; returns the renders directory."""
    args = build_parser().parse_args(argv)

    from gftorf_tpu_torch.render_sets import load_trained, render_trained
    from gftorf_tpu_torch.train.export import write_proxy_pcds

    # One Trainer serves the splits and the proxy clouds, so the proxy
    # frames start at the capacities the splits grew to.
    trainer, cfg, it = load_trained(args.model_path, args.iteration, args.device)
    base = render_trained(trainer, cfg, it, skip_train=args.skip_train,
                          skip_test=args.skip_test, skip_video=args.skip_video,
                          max_frames=args.max_frames)
    if args.proxy_pcd:
        out = write_proxy_pcds(trainer, it, max_frames=args.max_frames)
        print(f"proxy point clouds written to {out}")
    return base


if __name__ == "__main__":
    main()
