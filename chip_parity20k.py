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

Arms from one state (the densify window bisected from one iteration):

    python3 chip_parity20k.py --stop_at 11000
    cp chiprun_out/parity20k/state11000.npz build/parity20k/
    python3 chip_parity20k.py --arm card --from_state build/parity20k/state11000.npz \
        --until 12000 --noise build/parity20k/noise.npz
    python3 chip_parity20k.py --arm bg43 --from_state ... --until 12000 --random_bg --seed 43

``--stop_at N`` trains as above, evaluates at N, and instead of
continuing writes the compact state ``state{N}.npz`` into ``--keep``: the
live rows only (94 floats a row for the parameters and each Adam moment,
4 for the densify statistics) and the deform MLP with its moments, in the
JAX checkpoint layout, with ``np.savez_compressed`` (12.4 MB for 28,893
rows at 11,000, where the CLI's checkpoint of the capacity passes 100 MB).
Both packages' ``Trainer.load_checkpoint`` read it. The arms read their
state from a copy under ``build/``.
``--arm NAME`` loads such a state into a Trainer of the same run
(``--device cpu`` for the CPU), pads it to 65,536 rows, trains to
``--until`` and writes ``arm_NAME.json`` (every densify try: iteration,
capacity, clone / split / prune counts, points after; the test split's
evaluation at the end, or with ``--no_eval`` the final compact state
``arm_NAME_state.npz`` instead, for ``--evaluate FILE...`` on the card)
and, with ``--noise``, ``arm_NAME_events.npz`` (each try's masks and the
statistics they were decided on) into ``--keep``. Random backgrounds are
off unless ``--random_bg``; ``--noise`` hands densify the split draws of
a file (``tools/parity_events_jax.py noise`` writes the JAX Trainer's,
one array ``it{N}_C{capacity}`` a try) in place of the Trainer's own
generator; ``--interval`` densifies every that many iterations (a cut
window); ``--save_pre_event K`` keeps the state that each of the first K
densify tries reads (``tools/parity_events_jax.py densify`` holds both
packages' densify on it). ``tools/parity_events_jax.py arm`` runs the
JAX Trainer's arm from the same files.
"""

from __future__ import annotations

import argparse
import contextlib
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


ARM_CAPACITY = 65536  # the arms' rows: room for the window's growth


def run_overrides(scene, model, frames, seed=42, random_bg=None, interval=None):
    """The config path and the config overrides of the train CLI for this
    run (both packages' ``Config.from_json(path, overrides)`` read them),
    with ``densification_interval`` set to ``interval`` where given."""
    from gftorf_tpu_torch.train.__main__ import CLI_ONLY, build_parser

    args = build_parser().parse_args(train_args(scene, model, 20000, frames))
    over = {k: v for k, v in vars(args).items()
            if k not in CLI_ONLY and v is not None}
    over["seed"] = seed
    if random_bg is not None:
        over["random_bg_color"] = random_bg
    if interval:
        over["densification_interval"] = interval
    return args.config, over


def arm_trainer(args, name, state, random_bg=False, interval=None):
    """A port Trainer of this run loaded from a compact ``state``, padded
    to ARM_CAPACITY rows."""
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.models.gaussians import grow_capacity, sort_layout
    from gftorf_tpu_torch.train.loop import Trainer

    scene = os.path.join(args.out, "scene_aroom")
    path, over = run_overrides(scene, os.path.join(args.out, name), args.frames,
                               args.seed, random_bg, interval)
    tr = Trainer(Config.from_json(path, over), startup_artifacts=False,
                 device=args.device)
    tr.load_checkpoint(state)
    tr.model = sort_layout(grow_capacity(tr.model, ARM_CAPACITY))
    tr._update_deform_bucket()
    return tr


def run_evaluate(args, card):
    """``--evaluate``: the test split of each compact state (either
    package's) on one device."""
    from gftorf_tpu_torch.train.evaluate import evaluate_and_report

    rows = []
    for state in args.evaluate:
        tr = arm_trainer(args, "evaluate", state)
        t0 = time.perf_counter()
        report = evaluate_and_report(tr)["test"]
        rows.append({"state": os.path.basename(state), "card": card,
                     "iteration": tr.iteration,
                     "points": int(tr.model.aux.alive.sum()),
                     "psnr_p": report["psnr_p"], "mae_d_tof": report["mae_d_tof"],
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(args.keep, exist_ok=True)
    with open(os.path.join(args.keep, "evaluate.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def save_compact_state(trainer, path, model=None):
    """The Trainer's checkpoint (the JAX layout), with ``model`` in place
    of its Gaussians where given, cut to the live rows and compressed; the
    meta holds the capacity as ``capacity``."""
    import numpy as np

    from gftorf_tpu_torch.models.gaussians import map_rows
    from gftorf_tpu_torch.utils.checkpoint import tree_leaves

    tree = trainer._checkpoint_tree()
    if model is not None:
        tree["model"] = model
    alive = tree["model"].aux.alive
    cap = int(alive.shape[0])
    tree["model"] = map_rows(lambda x: x[alive], tree["model"], cap)
    arrays = {f"leaf_{i}": (x.detach().cpu().numpy() if hasattr(x, "detach")
                            else np.asarray(x))
              for i, x in enumerate(tree_leaves(tree))}
    meta = {"iteration": trainer.iteration,
            "active_sh_degree": trainer.active_sh_degree,
            "lambda_color": trainer.lambda_color,
            "opacity_reset_interval": trainer.opacity_reset_interval,
            **trainer.occupancy.meta(),
            "capacity": cap, "live": int(alive.sum())}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)
    return meta


def tree_digest(root):
    """A SHA-1 of every file under ``root`` (names and bytes, in order)."""
    import hashlib

    h = hashlib.sha1()
    for d, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            path = os.path.join(d, name)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


class StopAt(Exception):
    """Raised by the checkpoint hook at ``--stop_at``."""


@contextlib.contextmanager
def stop_at(iteration, path):
    """Make the train CLI's checkpoint at ``iteration`` write the compact
    state to ``path`` and stop the run (raising ``StopAt``)."""
    from gftorf_tpu_torch.train import loop

    real = loop.Trainer.save_checkpoint

    def save(self, ckpt):
        if self.iteration != iteration:
            return real(self, ckpt)
        meta = save_compact_state(self, path)
        raise StopAt(meta)

    loop.Trainer.save_checkpoint = save
    try:
        yield
    finally:
        loop.Trainer.save_checkpoint = real


def densify_inputs(state, hyper, extent, size_thr):
    """What a densify decision reads, per row, as numpy: the alive mask,
    the statistics, the raw opacity (a logit) and the largest raw scaling
    (a log-scale), with the package's own clone / split / prune masks."""
    from gftorf_tpu_torch.models.gaussians import densify_masks

    clone, split, prune = densify_masks(state, hyper, extent, size_thr)
    p, a = state.params, state.aux
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"alive": host(a.alive), "xyz_grad_accum": host(a.xyz_grad_accum),
            "denom": host(a.denom), "max_radii2d": host(a.max_radii2d),
            "opacity": host(p.opacity[:, 0]),
            "max_scaling": host(p.scaling.max(dim=-1).values),
            "clone": host(clone), "split": host(split), "prune": host(prune)}


@contextlib.contextmanager
def record_events(trainer, noise_for=None, keep_state=None):
    """Record every densify try of the port's ``trainer``: a list of dicts
    (iteration, capacity, size_thr, dropped, alive_after and
    ``densify_inputs``). ``noise_for(iteration, capacity)``, when given,
    returns the split draw, a (2, capacity, 3) tensor on the Trainer's
    device, in place of the Trainer's generator. ``keep_state(i)``, when
    given, returns a path for the compact state that try ``i`` reads, or
    None."""
    from gftorf_tpu_torch.train import loop

    real = loop.densify_and_prune
    events = []

    def densify(state, rng, hyper, extent, size_thr):
        cap = int(state.aux.alive.shape[0])
        path = keep_state(len(events)) if keep_state else None
        if path:
            save_compact_state(trainer, path, state)
        noise = rng if noise_for is None else noise_for(trainer.iteration, cap)
        rec = {"it": trainer.iteration, "capacity": cap, "size_thr": size_thr,
               **densify_inputs(state, hyper, extent, size_thr)}
        new, dropped = real(state, noise, hyper, extent, size_thr)
        rec["dropped"] = int(dropped)
        rec["alive_after"] = int(new.aux.alive.sum())
        events.append(rec)
        return new, dropped

    loop.densify_and_prune = densify
    try:
        yield events
    finally:
        loop.densify_and_prune = real


def event_rows(events):
    """One table row a densify try: counts of each decision."""
    rows = []
    for e in events:
        alive = e["alive"]
        rows.append({"it": e["it"], "capacity": e["capacity"],
                     "size_thr": e["size_thr"], "alive": int(alive.sum()),
                     "clone": int(e["clone"].sum()), "split": int(e["split"].sum()),
                     "prune": int((e["prune"] & ~e["split"]).sum()),
                     "dropped": e["dropped"], "points_after": e["alive_after"]})
    return rows


def save_events(events, path):
    """Each try's per-row arrays over its alive rows (a prefix: the
    Trainer keeps the sorted layout), one npz entry ``{k}_{i}`` a try."""
    import numpy as np

    arrays = {}
    for i, e in enumerate(events):
        n = int(e["alive"].sum())
        if not e["alive"][:n].all():
            raise AssertionError(f"try {i}: the alive rows are not a prefix")
        for k, v in e.items():
            if isinstance(v, np.ndarray):
                arrays[f"{k}_{i}"] = v[:n]
    np.savez_compressed(path, **arrays)


def run_arm(args, card):
    """``--arm``: from ``--from_state`` to ``--until`` on one device."""
    import numpy as np
    import torch

    from gftorf_tpu_torch.train.evaluate import evaluate_and_report

    tr = arm_trainer(args, f"arm_{args.arm}", args.from_state, args.random_bg,
                     args.interval)
    start = tr.iteration
    noise_for = None
    if args.noise:
        draws = np.load(args.noise)

        def noise_for(it, cap):
            return torch.as_tensor(draws[f"it{it}_C{cap}"], device=tr.device)

    def keep_state(i):
        if i < args.save_pre_event:
            return os.path.join(args.keep, f"arm_{args.arm}_pre{i}.npz")
        return None

    t0 = time.perf_counter()
    with record_events(tr, noise_for, keep_state) as events:
        while tr.iteration < args.until:
            tr.step()
        tr.drain()
    train_s = time.perf_counter() - t0
    os.makedirs(args.keep, exist_ok=True)
    report = {"psnr_p": None, "mae_d_tof": None}
    if args.no_eval:
        save_compact_state(tr, os.path.join(args.keep, f"arm_{args.arm}_state.npz"))
    else:
        report = evaluate_and_report(tr)["test"]
    rows = event_rows(events)
    out = {"arm": args.arm, "card": card, "device": str(tr.device),
           "package": "gftorf_tpu_torch", "from": start, "until": tr.iteration,
           "seed": args.seed, "random_bg": bool(args.random_bg),
           "interval": tr.opt.densification_interval,
           "noise": os.path.basename(args.noise) if args.noise else None,
           "capacity": ARM_CAPACITY, "train_seconds": train_s,
           "scene_sha1": tree_digest(os.path.join(args.out, "scene_aroom")),
           "points": int(tr.model.aux.alive.sum()),
           "psnr_p": report["psnr_p"], "mae_d_tof": report["mae_d_tof"],
           "events": rows}
    with open(os.path.join(args.keep, f"arm_{args.arm}.json"), "w") as f:
        json.dump(out, f, indent=1)
    if args.noise:
        save_events(events, os.path.join(args.keep, f"arm_{args.arm}_events.npz"))
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "events"}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "parity20k"))
    ap.add_argument("--keep", default=os.path.join(ROOT, "chiprun_out",
                                                   "parity20k"))
    ap.add_argument("--iterations", type=int, default=20000)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--stop_at", type=int, default=None,
                    help="write the compact state at this iteration and stop")
    ap.add_argument("--arm", default=None,
                    help="run an arm from --from_state (its name)")
    ap.add_argument("--from_state", default=None)
    ap.add_argument("--until", type=int, default=12000)
    ap.add_argument("--noise", default=None,
                    help="npz of split draws it{N}_C{capacity}")
    ap.add_argument("--random_bg", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--interval", type=int, default=None,
                    help="the arm's densification_interval (a cut window)")
    ap.add_argument("--save_pre_event", type=int, default=0,
                    help="keep the compact state that each of the first N "
                         "densify tries reads (arm_NAME_preI.npz)")
    ap.add_argument("--no_eval", action="store_true",
                    help="keep the arm's final compact state instead of "
                         "evaluating it")
    ap.add_argument("--evaluate", nargs="+", default=None,
                    help="evaluate these compact states and stop")
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
    if args.evaluate:
        return run_evaluate(args, card)
    if args.arm:
        return run_arm(args, card)
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
    if args.stop_at:
        state = os.path.join(args.keep, f"state{args.stop_at}.npz")
        try:
            with stop_at(args.stop_at, state):
                train_main(flags + ["--checkpoint_iterations", str(args.stop_at)])
        except StopAt as stop:
            meta = stop.args[0]
        else:
            raise RuntimeError(f"the run ended before {args.stop_at}")
        os.makedirs(args.keep, exist_ok=True)
        shutil.copy(os.path.join(model, "train_log.jsonl"), args.keep)
        print(json.dumps({"state": state, "bytes": os.path.getsize(state),
                          "seconds": time.perf_counter() - t0, "card": card,
                          "scene_sha1": tree_digest(scene), **meta}), flush=True)
        return 0
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
