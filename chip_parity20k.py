#!/usr/bin/env python3
"""The aroom scene trained for 20,000 iterations by the port on one card,
against the JAX package's table of the same run.

    python3 chip_parity20k.py [--out build/parity20k] [--keep chiprun_out/parity20k]

The run is the JAX campaign's (tools/parity_campaign_defaults.sh, scene
"aroom", through tools/parity20k_watchdog.sh): the analytic ``room`` scene
(``gftorf_tpu_torch/data/analytic.py``, 60 frames at 320x240, written
after ``np.random.seed(11)``), trained with ``python -m
gftorf_tpu_torch.train`` on configs/ftorf.json with the watchdog's
arguments (``--seed 42``, ``--lambda_flow 0.0008``, evaluations at 1 and
every 1,000 iterations, a checkpoint every 1,000). A model directory that
already holds checkpoints resumes from the newest. At the end it prints
``tools/parity_report.py``'s table of the run and the last evaluation
beside reports/parity_defaults_r05/report_aroom.md's (psnr_p 53.51 dB,
mae_d_tof 0.0105, 28,704 points) with the campaign's bar (0.2 dB of
psnr_p, 5 % of mae_d_tof), and copies the table and train_log.jsonl to
``--keep``. A gap past the bar is reported, not raised: it is a lead to
bisect. The card's name and power limit are printed first; without CUDA
(and without ``--device cpu``, for a rehearsal at a few ``--iterations``)
it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# reports/parity_defaults_r05/report_aroom.md, iteration 20,000.
JAX_FINAL = {"psnr_p": 53.51, "mae_d_tof": 0.0105, "points": 28704}
BAR_DB, BAR_MAE_FRAC = 0.2, 0.05


def train_args(scene, model, iters, frames):
    """tools/parity20k_watchdog.sh's train.py arguments for an ftorf scene."""
    marks = list(range(1000, iters + 1, 1000)) or [iters]
    return ["--config", os.path.join(ROOT, "configs", "ftorf.json"),
            "--seed", "42", "--source_path", scene, "--model_path", model,
            "--total_num_views", str(frames),
            "--min_depth_fac", "0.01", "--max_depth_fac", "0.45",
            "--iterations", str(iters), "--position_lr_max_steps", str(iters),
            "--densify_until_iter", "12000", "--lambda_tof", "1.0",
            "--densify_grad_threshold", "0.0002", "--initial_amplitude", "0.02",
            "--feature_amp_lr_init", "0.000016",
            "--feature_amp_lr_final", "0.000016", "--lambda_flow", "0.0008",
            "--test_iterations", "1", *map(str, marks),
            "--save_iterations", str(iters),
            "--checkpoint_iterations", *map(str, marks), "--quiet"]


def latest_checkpoint(model):
    found = [(int(m.group(1)), f) for f in os.listdir(model)
             if (m := re.fullmatch(r"chkpnt(\d+)\.npz", f))] if os.path.isdir(
                 model) else []
    return os.path.join(model, max(found)[1]) if found else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "parity20k"))
    ap.add_argument("--keep", default=os.path.join(ROOT, "chiprun_out",
                                                   "parity20k"))
    ap.add_argument("--iterations", type=int, default=20000)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_parity20k: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gftorf_tpu_torch.data.analytic import write_dataset
    from gftorf_tpu_torch.train.__main__ import main as train_main
    from gftorf_tpu_torch.utils.runtime import card_name, resolve_device

    card = card_name(resolve_device(args.device))
    print(f"card: {card}", flush=True)
    scene = os.path.join(args.out, "scene_aroom")
    model = os.path.join(args.out, "model_aroom")
    if not os.path.isdir(os.path.join(scene, "tofType0")):
        t0 = time.perf_counter()
        np.random.seed(11)
        write_dataset(scene, num_frames=args.frames, width=320, height=240,
                      seed=11, layout="room")
        print(f"scene written in {time.perf_counter() - t0:.1f} s", flush=True)
    flags = train_args(scene, model, args.iterations, args.frames)
    ckpt = latest_checkpoint(model)
    if ckpt:
        print(f"resuming from {ckpt}", flush=True)
        flags += ["--start_checkpoint", ckpt]
    if args.device:
        flags += ["--device", args.device]
    t0 = time.perf_counter()
    train_main(flags)
    print(f"trained to {args.iterations} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    table = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "parity_report.py"), model],
        capture_output=True, text=True, check=True).stdout
    os.makedirs(args.keep, exist_ok=True)
    with open(os.path.join(args.keep, "report_aroom.md"), "w") as f:
        f.write(f"{card}\n\n{table}")
    shutil.copy(os.path.join(model, "train_log.jsonl"), args.keep)
    print(table, flush=True)
    with open(os.path.join(model, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    last = [r for r in recs if "eval" in r][-1]
    test = last["eval"]["test"]
    points = [r for r in recs if "num_points" in r][-1]["num_points"]
    d_db = test["psnr_p"] - JAX_FINAL["psnr_p"]
    d_mae = test["mae_d_tof"] / JAX_FINAL["mae_d_tof"] - 1.0
    within = abs(d_db) <= BAR_DB and abs(d_mae) <= BAR_MAE_FRAC
    print(json.dumps({
        "iteration": last["iteration"], "card": card,
        "psnr_p": test["psnr_p"], "mae_d_tof": test["mae_d_tof"],
        "points": points, "jax": JAX_FINAL, "delta_psnr_p_db": d_db,
        "delta_mae_d_tof_frac": d_mae,
        "within_bar": within}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
