"""Headline benchmark of the port, the counterpart of the root ``bench.py``.
Prints ONE JSON line last:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

    python -m gftorf_tpu_torch.bench [bench_train flags]
    python -m gftorf_tpu_torch.bench --rasterizer [--device cpu]

The default is the end-to-end training step at the reference's workload
(``gftorf_tpu_torch/bench_train.py``, which takes the remaining flags;
baseline 180 ms/iter on an RTX 3090, BASELINE.md). ``--rasterizer`` runs
``bench.py:32-89``, the rasterizer's forward and backward throughput
(baseline 0.9 Mpix/s, the same envelope):

- ``data/synthetic.py::make_scene`` from a ``torch.Generator`` seeded with
  0: 100,000 points at 640x480, ``max_per_tile`` 1,024, scales in
  [0.004, 0.02] (a realistic 3DGS footprint of a few pixels, one to six
  tiles a Gaussian), ``dup_factor`` 8, and ``RasterConfig``'s default
  16x16 tiles (1,200 tiles of 256 pixels) as the JAX ``make_scene`` leaves
  them. The parameters are the JAX script's; the values are not, because
  JAX's threefry draws cannot be reproduced in torch.
- a zero 7-channel background and zero ``means2d_ndc``; the loss is the
  sum of squares of colour, phasor and depth, differentiated with respect
  to ``means3d`` only; each step feeds ``m - 0.0 * g`` to the next, so no
  two steps overlap;
- one warm-up step, then 20 steps timed between two
  ``torch.cuda.synchronize()`` calls.

The last line is ``{"metric": "rasterize_fwd_bwd_640x480_100k", "value":
<Mpix/s>, "unit": "Mpix/s/chip", "vs_baseline": <value / 0.9>}``. Earlier
lines give the card's name and power limit, the tile shape and count,
``num_rendered`` and whether a tile or the duplicate buffer overflowed (the
workload is kept either way, as in JAX). ``--points``, ``--width`` and
``--height`` shrink it for a test on the CPU; the metric's name then
carries the sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BASELINE_MPIX_S = 0.9
# bench.py:36-45.
RASTER_SCENE = dict(num_points=100_000, width=640, height=480,
                    max_per_tile=1024, scale_range=(0.004, 0.02), dup_factor=8)
RASTER_ITERS = 20


def raster_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="gftorf_tpu_torch rasterizer "
                                             "forward+backward benchmark")
    ap.add_argument("--rasterizer", action="store_true", required=True)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--points", type=int, default=RASTER_SCENE["num_points"])
    ap.add_argument("--width", type=int, default=RASTER_SCENE["width"])
    ap.add_argument("--height", type=int, default=RASTER_SCENE["height"])
    return ap


def raster_metric(width: int, height: int, points: int) -> str:
    """The metric's name: ``rasterize_fwd_bwd_640x480_100k`` at bench.py's
    sizes."""
    n = f"{points // 1000}k" if points % 1000 == 0 else str(points)
    return f"rasterize_fwd_bwd_{width}x{height}_{n}"


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns the last line's dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--rasterizer" not in argv:
        from gftorf_tpu_torch.bench_train import main as train_main

        return train_main(argv)
    return rasterizer(raster_parser().parse_args(argv))


def rasterizer(args) -> dict:
    import torch

    from gftorf_tpu_torch.data.synthetic import make_scene
    from gftorf_tpu_torch.render.rasterize import rasterize
    from gftorf_tpu_torch.utils.runtime import card_name, resolve_device

    device = resolve_device(args.device)
    print(f"card: {card_name(device)}", flush=True)
    width, height = args.width, args.height
    kw = dict(RASTER_SCENE, num_points=args.points, width=width, height=height)
    sc = make_scene(torch.Generator().manual_seed(0), device=device, **kw)
    n = sc.means3d.shape[0]
    bg = torch.zeros((7, height, width), device=device)
    zeros2d = torch.zeros((n, 2), device=device)
    cfg = sc.config

    def render(means3d):
        return rasterize(means3d, sc.scales, sc.rotations, sc.opacities,
                         sc.shs, sc.shs_p, 0.0, 0.0, zeros2d, bg,
                         camera=sc.camera, config=cfg)

    def step(means3d):
        m = means3d.detach().requires_grad_(True)
        out = render(m)
        loss = ((out.color ** 2).sum() + (out.phasor ** 2).sum()
                + (out.depth ** 2).sum())
        (g,) = torch.autograd.grad(loss, m)
        return (m - 0.0 * g).detach()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        first = render(sc.means3d)
    print(f"scene: {n} Gaussians at {width}x{height}, tiles {cfg.tile_w}x"
          f"{cfg.tile_h} ({cfg.num_tiles} tiles of {cfg.tile_pixels} pixels), "
          f"max_per_tile {cfg.max_per_tile}, dup_factor {cfg.dup_factor}: "
          f"num_rendered {int(first.num_rendered)}, deepest tile "
          f"{int(first.tile_max)}, tile_overflow {int(first.tile_overflow)}, "
          f"dup_overflow {bool(first.dup_overflow)}", flush=True)

    m = step(sc.means3d)
    sync()
    t0 = time.perf_counter()
    for _ in range(RASTER_ITERS):
        m = step(m)
    sync()
    dt = (time.perf_counter() - t0) / RASTER_ITERS

    mpix_s = (width * height) / dt / 1e6
    result = {"metric": raster_metric(width, height, args.points),
              "value": round(mpix_s, 3), "unit": "Mpix/s/chip",
              "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 2)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
