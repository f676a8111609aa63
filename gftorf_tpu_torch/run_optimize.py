"""Batch training runner with the paper's per-scene settings.

The port's counterpart of the root ``run_optimize.py`` (which drives the
JAX CLIs): the same scene tables and flags, driving ``python -m
gftorf_tpu_torch.train`` and ``python -m gftorf_tpu_torch.render`` once
per scene. Data is expected under ``{data_root}/{scene_type}/{scene}``::

    python -m gftorf_tpu_torch.run_optimize --family torf --scenes cupboard
    python -m gftorf_tpu_torch.run_optimize --family ftorf --no_render

Both CLIs run on the CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from datetime import datetime

# (scene_type, scene, total_num_views, max_depth_fac, lambda_tof,
#  quad_scale, iterations)
SCENES_FTORF = [
    ("ftorf_synthetic_scenes", "sliding_cube", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_synthetic_scenes", "arcing_cube", 60, 0.45, 1.0, 5.0, 20000),
    ("ftorf_synthetic_scenes", "acute_z_speed_test", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_synthetic_scenes", "speed_test_texture", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_synthetic_scenes", "speed_test_chair", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_synthetic_scenes", "occlusion", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_synthetic_scenes", "z_motion_speed_test", 60, 0.45, 1.0, 1.0, 20000),
    ("ftorf_real_scenes", "pillow", 64, 0.45, 5.0, 1.0, 20000),
    ("ftorf_real_scenes", "baseball", 60, 0.45, 5.0, 1.0, 20000),
    ("ftorf_real_scenes", "fan", 60, 0.45, 5.0, 1.0, 20000),
    ("ftorf_real_scenes", "jacks1", 68, 0.45, 1.0, 1.0, 20000),
    ("ftorf_real_scenes", "target1", 68, 0.65, 1.0, 10.0, 20000),
]

# (scene, total_num_views)
SCENES_TORF = [
    ("cupboard", 30),
    ("deskbox", 30),
    ("studybook", 30),
    ("copier", 30),
    ("phonebooth", 30),
]

TRAIN, RENDER = "gftorf_tpu_torch.train", "gftorf_tpu_torch.render"


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def optimize_ftorf(selected=None, data_root="data", render=True):
    for (scene_type, scene, views, zfar, lambda_tof, quad_scale,
         iterations) in SCENES_FTORF:
        if selected and scene not in selected:
            continue
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = f"output/{scene}_{ts}"
        # per-scene amplitude settings (reference run_optimize.py:45-56)
        if scene == "target1":
            amp_div, initial_amp = 1000.0, 0.5
        elif scene == "jacks1":
            amp_div, initial_amp = 1000.0, 0.1
        else:
            amp_div, initial_amp = 100.0, 0.02
        run([
            sys.executable, "-m", TRAIN,
            "--config", "configs/ftorf.json",
            "--seed", "42",
            "--source_path", f"{data_root}/{scene_type}/{scene}",
            "--model_path", out,
            "--total_num_views", str(views),
            "--min_depth_fac", "0.01",
            "--max_depth_fac", str(zfar),
            "--iterations", str(iterations),
            "--position_lr_max_steps", str(iterations),
            "--densify_until_iter", str(int(iterations * 0.6)),
            "--lambda_tof", str(lambda_tof),
            "--densify_grad_threshold", str(0.0002 * lambda_tof),
            "--lambda_flow", "0.0008",
            "--quad_scale", str(quad_scale),
            "--initial_amplitude", str(initial_amp),
            "--feature_amp_lr_init", str(0.0016 / amp_div),
            "--feature_amp_lr_final", str(0.0016 / amp_div),
        ])
        if render:
            run([sys.executable, "-m", RENDER, "--model_path", out,
                 "--iteration", str(iterations)])


def optimize_torf(selected=None, data_root="data", render=True):
    for scene, views in SCENES_TORF:
        if selected and scene not in selected:
            continue
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = f"output/{scene}_{ts}"
        iterations = 20000
        # reference run_optimize.py:93-98
        if scene in ("copier", "phonebooth"):
            initial_amp, lambda_mlp_reg = 0.5, 0.0
        else:
            initial_amp, lambda_mlp_reg = 0.1, 0.05
        amp_div = 10.0
        run([
            sys.executable, "-m", TRAIN,
            "--config", "configs/torf.json",
            "--seed", "42",
            "--source_path", f"{data_root}/torf_scenes/{scene}",
            "--model_path", out,
            "--total_num_views", str(views),
            "--min_depth_fac", "0.01",
            "--max_depth_fac", "0.55",
            "--lambda_mlp_reg", str(lambda_mlp_reg),
            "--lambda_flow", "0.0",
            "--iterations", str(iterations),
            "--position_lr_max_steps", str(iterations),
            "--densify_until_iter", str(iterations),
            "--initial_amplitude", str(initial_amp),
            "--feature_amp_lr_init", str(0.0016 / amp_div),
            "--feature_amp_lr_final", str(0.0016 / amp_div),
            "--lambda_tof", "1.0",
            "--densify_grad_threshold", "0.0004",
        ])
        if render:
            run([sys.executable, "-m", RENDER, "--model_path", out,
                 "--iteration", str(iterations)])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gftorf_tpu_torch batch training")
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--family", choices=["ftorf", "torf", "both"],
                   default="both")
    p.add_argument("--data_root", default="data")
    p.add_argument("--no_render", action="store_true")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.family in ("ftorf", "both"):
        optimize_ftorf(a.scenes, a.data_root, not a.no_render)
    if a.family in ("torf", "both"):
        optimize_torf(a.scenes, a.data_root, not a.no_render)


if __name__ == "__main__":
    main()
