"""End-to-end training-step benchmark of the port, the counterpart of the
root ``bench_train.py`` (320x240, 50k points, quads + deform + flow: the
reference's headline workload).

    python -m gftorf_tpu_torch.bench_train [--device cpu] [--iters 550]
        [--warm 250] [--points 50000] [--width 320] [--height 240]
        [--profile DIR] [--set key=json ...]

The workload is ``bench_train.py``'s field for field: the dataset writer's
32 frames after ``np.random.seed(7)``, the same config (``--set`` overrides
included), the Trainer built after ``np.random.seed(7)`` without start-up
artifacts, ``--warm`` iterations and a drain, then the timed window of
``--iters - --warm`` iterations closed by a drain. The last line is the
root script's, with its metric name, unit and baseline:

    {"metric": "train_step", "value": <ms/iter>, "unit": "ms/iter",
     "vs_baseline": <180 / value>}

180 ms/iter is the reference's RTX 3090 envelope (20k iterations in at most
3600 s at 320x240, BASELINE.md). Earlier lines carry context and no
metric: the card's name and power limit, the Trainer's capacity, replay,
shrink and flat-fallback lines (each names its iteration), and where the
timed window starts. ``--device`` takes the place of ``--platform``: the
run takes the CUDA card and raises without one unless ``--device cpu`` is
given. There is no compilation cache: the kernels build into
``build/kernels/`` at their first launch, inside the warm-up. ``--profile
DIR`` records a torch.profiler trace of 20 steady-state steps into
``DIR/trace.json``.

The port's writer draws its Gaussians from a ``torch.Generator`` where the
JAX writer draws from a JAX key, so the two write different scenes for one
seed (``tests/test_torch_data.py`` holds the port's writer to JAX's only
when it is handed JAX's Gaussians). The scene is therefore written under
``BENCH_DIR``, never into the JAX script's ``/tmp/bench_train_scene_*``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Where the scene (scene_{w}x{h}) and the model path go.
BENCH_DIR = os.path.join(ROOT, "build", "bench")
BASELINE_MS = 180.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gftorf_tpu_torch training-step "
                                             "benchmark")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    # Warm-up must cover the adaptive-capacity settling: occupancy tracking
    # evaluates after shrink_window=200 resolved steps, and the shrink
    # belongs in warm-up, not in the timed steady-state window.
    ap.add_argument("--iters", type=int, default=550)
    ap.add_argument("--warm", type=int, default=250,
                    help="iterations excluded from the timed window")
    ap.add_argument("--points", type=int, default=50_000)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of 20 steady-state "
                         "steps into DIR/trace.json")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides key=json_value (ablations)")
    return ap


def config_dict(args, src: str, model_path: str) -> dict:
    """``bench_train.py:68-85``: the benchmark's config and its overrides."""
    cfg = dict(
        source_path=src, model_path=model_path,
        total_num_views=32,
        tof_image_width=args.width, tof_image_height=args.height,
        color_image_width=args.width, color_image_height=args.height,
        depth_range=15.0, num_points=args.points,
        iterations=args.iters + 1,
        warm_up=10, use_quad=True, dynamic=True, dataset_type="quad",
        random_bg_color=True, optimize_sync_iters=-1,
        flow_loss_iter_start=20, lambda_flow=0.01, lambda_mlp_reg=0.01,
        lambda_color=0.0,
        # steady-state window: no densify events inside the run
        densify_from_iter=10 * args.iters,
        opacity_reset_interval=100 * args.iters,
    )
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg[k] = json.loads(v)
    return cfg


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns the last line's dict."""
    args = build_parser().parse_args(argv)
    if not 0 <= args.warm < args.iters:
        raise SystemExit("--warm must lie in [0, --iters)")

    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.data.generate import write_dataset
    from gftorf_tpu_torch.train.loop import Trainer
    from gftorf_tpu_torch.utils.runtime import card_name, resolve_device

    device = resolve_device(args.device)
    print(f"card: {card_name(device)}", flush=True)
    src = os.path.join(BENCH_DIR, f"scene_{args.width}x{args.height}")
    if not os.path.isdir(src):
        np.random.seed(7)
        write_dataset(src, num_frames=32, width=args.width,
                      height=args.height, device=device)
    cfg = Config.from_dict(config_dict(args, src,
                                       os.path.join(BENCH_DIR, "model")))
    np.random.seed(7)
    trainer = Trainer(cfg, startup_artifacts=False, device=device)

    # Warm-up: the kernels' build, the capacity growth and shrink, and the
    # metric pipeline's fill.
    for _ in range(args.warm):
        trainer.step()
    trainer.drain()

    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for _ in range(20):
                trainer.step()
            trainer.drain()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    print(f"timed window: iterations {trainer.iteration + 1}-"
          f"{trainer.iteration + args.iters - args.warm} (max_per_tile "
          f"{trainer.tile_cap}, dup_factor {trainer.dup_factor}, flat_stream "
          f"{trainer.flat_stream})", flush=True)
    t0 = time.perf_counter()
    outs = []
    for _ in range(args.iters - args.warm):
        outs += trainer.step()
    outs += trainer.drain()
    dt = time.perf_counter() - t0

    n = args.iters - args.warm
    ms = dt / n * 1e3
    if not all(np.isfinite(o["loss"]) for o in outs):
        raise FloatingPointError("a loss in the timed window is not finite")
    result = {"metric": "train_step", "value": round(ms, 2), "unit": "ms/iter",
              "vs_baseline": round(BASELINE_MS / ms, 3)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
