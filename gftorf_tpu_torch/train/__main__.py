"""Training CLI of the port, the counterpart of the root ``train.py``.

    python -m gftorf_tpu_torch.train --config configs/ftorf.json [--device cpu] [...]

Any ModelParams / OptimizationParams / PipelineParams / TpuParams field
can be overridden on the command line; precedence is defaults < JSON <
CLI, as in the reference (train.py:605-643). ``--device`` takes the place
of ``--platform``: without it the run takes the CUDA card and raises when
there is none. The run writes what ``train.py`` writes under model_path:
``train_log.jsonl``, ``cfg_args_full.json``, the scene metadata,
``point_cloud/iteration_N/`` at the save iterations and ``chkpnt{N}.npz``
at the checkpoint iterations.

``--debug_nans`` (the counterpart of ``jax_debug_nans``) raises
``FloatingPointError`` at the first op, kernel launch or backward function
that makes a NaN (``utils/debug_nans.py``); every rank of a mesh checks
its own ops. It changes no result, and it is slow.

Multi-device training runs one process per rank under
``torch.distributed.run`` with ``--distributed`` and the mesh in the
config (``mesh_data`` x ``mesh_shards`` ranks), for example

    python -m torch.distributed.run --nproc_per_node 2 \
        -m gftorf_tpu_torch.train --config configs/ftorf.json \
        --distributed --mesh_shards 2

Each rank takes ``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``),
and the backend follows the device (``nccl`` on cards, ``gloo`` on the
CPU) unless ``--dist_backend`` names it: ranks that share one card
(``--device cuda:0``) need ``--dist_backend gloo``. Rank 0 writes the
tree above, once; the other ranks train in lockstep and write nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from gftorf_tpu_torch.config import (
    Config,
    ModelParams,
    OptimizationParams,
    PipelineParams,
    TpuParams,
)

# Flags that are not config fields (the iteration lists are both: flags
# here, and saved with the config as train.py saves them).
CLI_ONLY = ("config", "device", "quiet", "start_checkpoint", "profile_steps",
            "distributed", "dist_backend", "debug_nans", "tensorboard")
LIST_FLAGS = ("test_iterations", "save_iterations", "checkpoint_iterations")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="gftorf_tpu_torch training")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--profile_steps", type=int, nargs=2, default=None,
                        metavar=("START", "END"),
                        help="record a torch.profiler trace between these "
                             "iterations (model_path/profile/trace.json)")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=None)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=None)
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=None)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--distributed", action="store_true",
                        help="join the torch.distributed process group of "
                             "torch.distributed.run (RANK, WORLD_SIZE, "
                             "LOCAL_RANK, MASTER_ADDR/PORT) before any device "
                             "is chosen; the mesh is mesh_data x mesh_shards "
                             "of its ranks")
    parser.add_argument("--dist_backend", type=str, default=None,
                        choices=("nccl", "gloo"),
                        help="with --distributed: nccl (one rank per card) "
                             "or gloo (the CPU, or ranks sharing a card); "
                             "default: nccl on CUDA, gloo on the CPU")
    parser.add_argument("--debug_nans", action="store_true",
                        help="raise FloatingPointError at the first op, "
                             "kernel launch or backward function that makes "
                             "a NaN (jax_debug_nans; the reference's "
                             "--detect_anomaly). Every check waits for the "
                             "device: slow, for debugging only")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard event files to model_path")
    for group in (ModelParams(), OptimizationParams(), PipelineParams(),
                  TpuParams()):
        for f in dataclasses.fields(group):
            if f.name in LIST_FLAGS:
                continue
            default = getattr(group, f.name)
            if isinstance(default, bool):
                parser.add_argument(f"--{f.name}", default=None,
                                    type=lambda s: s.lower() in ("1", "true", "yes"))
            elif isinstance(default, list):
                parser.add_argument(f"--{f.name}", nargs=len(default),
                                    type=float, default=None)
            else:
                parser.add_argument(f"--{f.name}", type=type(default),
                                    default=None)
    return parser


def main(argv=None):
    """Train as ``train.py`` does; returns the Trainer at the end."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dist_backend and not args.distributed:
        parser.error("--dist_backend needs --distributed")
    if args.distributed and "RANK" not in os.environ:
        parser.error("--distributed needs the ranks of torch.distributed.run: "
                     "python -m torch.distributed.run --nproc_per_node N -m "
                     "gftorf_tpu_torch.train --distributed ...")
    overrides = {k: v for k, v in vars(args).items()
                 if k not in CLI_ONLY and v is not None}
    cfg = Config.from_json(args.config, overrides)

    from gftorf_tpu_torch.utils.runtime import resolve_device

    if args.distributed:
        from gftorf_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(args.dist_backend, args.device)
    else:
        device = resolve_device(args.device)
    try:
        if args.debug_nans:
            from gftorf_tpu_torch.utils.debug_nans import nan_checks

            with nan_checks():
                return _train(args, cfg, device)
        return _train(args, cfg, device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _train(args, cfg, device):
    from gftorf_tpu_torch.train.debug import (
        dump_debug_images,
        param_histograms,
        param_series,
    )
    from gftorf_tpu_torch.train.evaluate import evaluate_and_report
    from gftorf_tpu_torch.train.export import save_scene_artifacts
    from gftorf_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device)
    # Rank 0 of a mesh writes everything below; the others only train.
    writer = trainer.is_writer
    if writer:
        os.makedirs(cfg.model.model_path, exist_ok=True)
        cfg.save(cfg.model.model_path)
    if args.start_checkpoint:
        trainer.load_checkpoint(args.start_checkpoint)

    iterations = cfg.opt.iterations
    test_iters = args.test_iterations
    if test_iters is None:
        test_iters = [1] + list(
            np.linspace(0, iterations, iterations // 1000 + 1).astype(int))
    save_iters = args.save_iterations or [iterations // 2, iterations]
    ckpt_iters = args.checkpoint_iterations or []

    t_start = time.time()
    log_f = (open(os.path.join(cfg.model.model_path, "train_log.jsonl"), "a")
             if writer else None)
    quiet = args.quiet or not writer
    profile_range = args.profile_steps
    prof = None
    tb = None
    if args.tensorboard and writer:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(cfg.model.model_path)
        except ImportError:
            print("tensorboard requested but not importable; continuing with "
                  "train_log.jsonl only", flush=True)

    def handle_record(out):
        nonlocal prof
        oit = out["iteration"]
        if prof is not None and oit == profile_range[1]:
            prof.stop()
            path = os.path.join(cfg.model.model_path, "profile", "trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            prof = None
            print(f"profiler trace written to {path}", flush=True)
        if not writer:
            return
        if oit % 50 == 0 or oit == 1:
            log_f.write(json.dumps(out) + "\n")
            log_f.flush()
            if tb is not None:
                for k, v in out.items():
                    if isinstance(v, (int, float)) and k != "iteration":
                        tb.add_scalar(f"train/{k}", v, oit)
        if not quiet and (oit % 200 == 0 or oit == 1):
            print(f"[{oit}/{iterations}] loss {out['ema_loss']:.5f} "
                  f"pts {out['num_points']} vis {out['visible']} "
                  f"{out['iter_time'] * 1e3:.1f} ms", flush=True)
        if cfg.pipe.debug and (oit % cfg.tpu.debug_interval == 0 or oit == 1):
            # label with the trainer's live iteration: the model state is
            # metrics_lag steps ahead of this resolved record
            dump_debug_images(trainer, out["idx"], trainer.iteration)

    while trainer.iteration < iterations:
        if (profile_range and writer
                and trainer.iteration + 1 == profile_range[0]):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        outs = trainer.step()
        it = trainer.iteration
        if it in test_iters or it in save_iters or it in ckpt_iters:
            outs += trainer.drain()
        for out in outs:
            handle_record(out)
        if it in test_iters and writer:
            report = evaluate_and_report(trainer)
            log_f.write(json.dumps({"eval": report, "iteration": it}) + "\n")
            log_f.write(json.dumps({"histograms": param_histograms(trainer.model),
                                    "iteration": it}) + "\n")
            log_f.flush()
            if tb is not None:
                for split, metrics in report.items():
                    for k, v in metrics.items():
                        if isinstance(v, (int, float)):
                            tb.add_scalar(f"{split}/{k}", v, it)
                for name, vals in param_series(trainer.model).items():
                    if vals.size:
                        tb.add_histogram(f"scene/{name}", vals, it)
            if not quiet:
                print(f"[eval {it}] {report}", flush=True)
        if it in save_iters and writer:
            save_scene_artifacts(trainer, it)
        if it in test_iters or it in save_iters:
            trainer.barrier()  # the other ranks wait for rank 0's writes
        if it in ckpt_iters:
            trainer.save_checkpoint(
                os.path.join(cfg.model.model_path, f"chkpnt{it}.npz"))
    for out in trainer.drain():
        handle_record(out)
    if prof is not None:
        prof.stop()
    if trainer.mesh is not None:
        digest = trainer.check_ranks_agree()
        if writer:
            print(f"ranks agree: state digest {digest} on "
                  f"{trainer.mesh.size} ranks", flush=True)
    if writer:
        log_f.close()
        print(f"Training complete in {time.time() - t_start:.1f} s")
    trainer.barrier()
    return trainer


if __name__ == "__main__":
    main()
