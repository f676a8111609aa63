"""Batch rendering runner: render every trained model under an output root.

The port's counterpart of the root ``run_render.py`` (which drives the JAX
CLIs): it finds the model directories (those holding
``cfg_args_full.json``) and runs ``python -m gftorf_tpu_torch.render``, and
with ``--traj`` also ``python -m gftorf_tpu_torch.render_traj``, on each::

    python -m gftorf_tpu_torch.run_render --output_root output --traj

``--device`` takes the place of the root script's ``--platform``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

RENDER, RENDER_TRAJ = "gftorf_tpu_torch.render", "gftorf_tpu_torch.render_traj"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gftorf_tpu_torch batch rendering")
    p.add_argument("--output_root", default="output")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--traj", action="store_true",
                   help="also run the trajectory visualization")
    p.add_argument("--device", type=str, default=None,
                   help="passed to the render CLIs (default: CUDA)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    models = []
    for name in sorted(os.listdir(args.output_root)):
        path = os.path.join(args.output_root, name)
        if not os.path.isdir(path):
            continue
        if not os.path.exists(os.path.join(path, "cfg_args_full.json")):
            continue
        if args.scenes and not any(name.startswith(s) for s in args.scenes):
            continue
        models.append(path)

    device = ["--device", args.device] if args.device else []
    for path in models:
        cmd = [sys.executable, "-m", RENDER, "--model_path", path,
               "--iteration", str(args.iteration)] + device
        print("+", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
        if args.traj:
            cmd = [sys.executable, "-m", RENDER_TRAJ, "--model_path", path,
                   "--iteration", str(args.iteration)] + device
            subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
