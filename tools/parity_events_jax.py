#!/usr/bin/env python
"""The JAX side of ``chip_parity20k.py``'s arms (the aroom densify window
run from one state by each package).

    python tools/parity_events_jax.py noise --from_it 11000 --until 12000 \\
        [--interval 10] [--seed 42] [--out build/parity20k/noise.npz]
    python tools/parity_events_jax.py arm --from_state chiprun_out/parity20k/state11000.npz \\
        [--until 11300] [--noise build/parity20k/noise.npz]
    python tools/parity_events_jax.py densify --pre_state chiprun_out/parity20k/arm_card2_pre0.npz \\
        --noise build/parity20k/noise.npz

``noise`` writes the split draws of the JAX Trainer's densify at every
densify iteration of the window (``jax.random.normal(fold_in(PRNGKey(seed),
1_000_000 + it), (2, capacity, 3))``, gftorf_tpu/train/loop.py:713), one
array ``it{N}_C{capacity}`` each, for the port's arms. ``arm`` runs the
JAX Trainer on the CPU from a compact state of ``chip_parity20k.py
--stop_at`` (random backgrounds off, the state padded to the arms'
65,536 rows; at the aroom state of 11,000 its step needs more than 16 GB),
records every densify try as ``chip_parity20k.py --arm`` does and
writes ``arm_NAME.json`` and ``arm_NAME_events.npz`` into ``--keep``.
``--noise``, given, checks that each draw equals the file's (the port's
arms read that file). ``densify`` runs one densify of each package on the
CPU from each pre-event state that a port arm kept (``--save_pre_event``)
with that event's draw from ``--noise``, and compares the masks, the
dropped count and the new states (``densify_same_inputs.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_parity20k as cp  # noqa: E402

DENSIFY_SEED_OFFSET = 1_000_000
SPLIT_N = 2


def densify_its(start, until, cfg_opt):
    """The iterations in (start, until] at which the Trainer densifies."""
    o = cfg_opt
    return [it for it in range(start + 1, until + 1)
            if it < o.densify_until_iter and it > o.densify_from_iter
            and it % o.densification_interval == 0]


def split_draw(seed, it, capacity):
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(seed), DENSIFY_SEED_OFFSET + it)
    return jax.random.normal(key, (SPLIT_N, capacity, 3))


def jax_densify_inputs(state, hyper, extent, size_thr):
    """``chip_parity20k.densify_inputs`` for a JAX state: the masks as
    gftorf_tpu/models/gaussians.py::densify_and_prune forms them."""
    import jax.numpy as jnp
    import numpy as np

    from gftorf_tpu.models.gaussians import get_opacity, get_scaling

    p, a = state.params, state.aux
    max_scale = jnp.max(get_scaling(p), axis=-1)
    grads = a.xyz_grad_accum / jnp.maximum(a.denom, 1e-30)
    grads = jnp.where(a.denom > 0, grads, 0.0)
    high = a.alive & (grads >= hyper.grad_threshold)
    clone = high & (max_scale <= hyper.percent_dense * extent)
    split = high & (max_scale > hyper.percent_dense * extent)
    prune = a.alive & (get_opacity(p)[:, 0] < hyper.min_opacity)
    if size_thr > 0:
        prune = prune | (a.alive & ((max_scale > 0.05 * extent)
                                    | (max_scale < 0.001 * extent)))
    host = np.asarray
    return {"alive": host(a.alive), "xyz_grad_accum": host(a.xyz_grad_accum),
            "denom": host(a.denom), "max_radii2d": host(a.max_radii2d),
            "opacity": host(p.opacity[:, 0]),
            "max_scaling": host(jnp.max(p.scaling, axis=-1)),
            "clone": host(clone), "split": host(split),
            "prune": host(prune | split)}


@contextlib.contextmanager
def record_jax_events(trainer, check_noise=None):
    """Record every densify try of the JAX ``trainer`` as
    ``chip_parity20k.record_events`` does for the port's.
    ``check_noise(iteration, capacity, key)`` is called on each try."""
    from gftorf_tpu.train import loop

    real = loop._densify_step
    events = []

    def densify(state, key, hyper, size_thr, extent):
        cap = int(state.aux.alive.shape[0])
        if check_noise is not None:
            check_noise(trainer.iteration, cap, key)
        rec = {"it": trainer.iteration, "capacity": cap, "size_thr": size_thr,
               **jax_densify_inputs(state, hyper, extent, size_thr)}
        new, dropped = real(state, key, hyper, size_thr, extent)
        rec["dropped"] = int(dropped)
        rec["alive_after"] = int(new.aux.alive.sum())
        events.append(rec)
        return new, dropped

    loop._densify_step = densify
    try:
        yield events
    finally:
        loop._densify_step = real


def save_compact_state(trainer, path):
    """``chip_parity20k.save_compact_state`` for the JAX Trainer: its
    checkpoint tree cut to the live rows (a prefix of the sorted layout)."""
    import jax
    import numpy as np

    alive = np.asarray(trainer.model.aux.alive)
    n, cap = int(alive.sum()), alive.shape[0]
    if not alive[:n].all():
        raise AssertionError("the alive rows are not a prefix")
    cut = lambda x: x[:n] if x.ndim >= 1 and x.shape[0] == cap else x  # noqa: E731
    tree = {"model": jax.tree.map(lambda x: cut(np.asarray(x)), trainer.model),
            "deform": trainer.deform, "deform_adam": trainer.deform_adam}
    arrays = {f"leaf_{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(tree))}
    meta = {"iteration": trainer.iteration,
            "active_sh_degree": trainer.active_sh_degree,
            "lambda_color": trainer.lambda_color,
            "opacity_reset_interval": trainer.opacity_reset_interval,
            "tile_cap": trainer.tile_cap, "dup_factor": trainer.dup_factor,
            "flat_stream": trainer.flat_stream, "flat_auto": trainer._flat_auto,
            "capacity": cap, "live": n}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def cmd_noise(args):
    import numpy as np

    from gftorf_tpu.config import Config

    scene = os.path.join(args.out_dir, "scene_aroom")
    path, over = cp.run_overrides(scene, "", args.frames, args.seed,
                                  interval=args.interval)
    opt = Config.from_json(path, over).opt
    draws = {f"it{it}_C{cp.ARM_CAPACITY}":
             np.asarray(split_draw(args.seed, it, cp.ARM_CAPACITY))
             for it in densify_its(args.from_it, args.until, opt)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **draws)
    print(json.dumps({"noise": args.out, "draws": sorted(draws)}), flush=True)
    return 0


def cmd_arm(args):
    import jax
    import numpy as np

    from gftorf_tpu.config import Config
    from gftorf_tpu.models.gaussians import grow_capacity
    from gftorf_tpu.train import loop
    from gftorf_tpu.train.evaluate import evaluate_and_report

    scene = os.path.join(args.out_dir, "scene_aroom")
    path, over = cp.run_overrides(scene, os.path.join(args.out_dir,
                                                      f"arm_{args.arm}"),
                                  args.frames, args.seed, False, args.interval)
    tr = loop.Trainer(Config.from_json(path, over), startup_artifacts=False)
    tr.load_checkpoint(args.from_state)
    tr.model = loop._sort_layout_step(grow_capacity(tr.model, cp.ARM_CAPACITY))
    tr._update_deform_bucket()
    start = tr.iteration
    check = None
    if args.noise:
        draws = np.load(args.noise)

        def check(it, cap, key):
            got = np.asarray(jax.random.normal(key, (SPLIT_N, cap, 3)))
            np.testing.assert_array_equal(got, draws[f"it{it}_C{cap}"])

    t0 = time.perf_counter()
    with record_jax_events(tr, check) as events:
        while tr.iteration < args.until:
            tr.step()
        tr.drain()
    train_s = time.perf_counter() - t0
    os.makedirs(args.keep, exist_ok=True)
    report = {"psnr_p": None, "mae_d_tof": None}
    if args.no_eval:
        save_compact_state(tr, os.path.join(args.keep,
                                            f"arm_{args.arm}_state.npz"))
    else:
        report = {k: float(v) for k, v in
                  evaluate_and_report(tr)["test"].items()
                  if k in ("psnr_p", "mae_d_tof")}
    rows = cp.event_rows(events)
    out = {"arm": args.arm, "card": "cpu", "device": "cpu",
           "package": "gftorf_tpu", "from": start, "until": tr.iteration,
           "seed": args.seed, "random_bg": False,
           "interval": tr.opt.densification_interval,
           "noise": "jax", "capacity": cp.ARM_CAPACITY, "train_seconds": train_s,
           "points": int(tr.model.aux.alive.sum()),
           "psnr_p": report["psnr_p"], "mae_d_tof": report["mae_d_tof"],
           "events": rows}
    with open(os.path.join(args.keep, f"arm_{args.arm}.json"), "w") as f:
        json.dump(out, f, indent=1)
    cp.save_events(events, os.path.join(args.keep, f"arm_{args.arm}_events.npz"))
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "events"}), flush=True)
    return 0


def cmd_densify(args):
    """The densify of each pre-event state (``chip_parity20k.py --arm ...
    --save_pre_event``) by both packages on the CPU from identical inputs:
    the masks, the dropped count and the new state compared."""
    import jax
    import numpy as np
    import torch

    from gftorf_tpu.config import Config as JConfig
    from gftorf_tpu.models.gaussians import DensifyHyper as JHyper
    from gftorf_tpu.models.gaussians import grow_capacity as j_grow
    from gftorf_tpu.train import loop as jloop
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.models.gaussians import (
        DensifyHyper,
        densify_and_prune,
        grow_capacity,
    )
    from gftorf_tpu_torch.train.loop import Trainer
    from gftorf_tpu_torch.utils.checkpoint import tree_leaves

    scene = os.path.join(args.out_dir, "scene_aroom")
    path, over = cp.run_overrides(scene, "", args.frames, args.seed, False)
    tr_j = jloop.Trainer(JConfig.from_json(path, over), startup_artifacts=False)
    tr_t = Trainer(Config.from_json(path, over), startup_artifacts=False,
                   device="cpu")
    draws = np.load(args.noise)
    rows = []
    for state in args.pre_state:
        tr_j.load_checkpoint(state)
        tr_t.load_checkpoint(state)
        js = j_grow(tr_j.model, cp.ARM_CAPACITY)
        ts = grow_capacity(tr_t.model, cp.ARM_CAPACITY)
        it, opt = tr_j.iteration, tr_j.opt
        size_thr = 10.0 if it > tr_j.opacity_reset_interval else 0.0
        extent = tr_j.scene.scene_extent
        key = jax.random.fold_in(tr_j.key, DENSIFY_SEED_OFFSET + it)
        hyper = dict(grad_threshold=opt.densify_grad_threshold,
                     min_opacity=opt.min_opacity, percent_dense=opt.percent_dense)
        j_in = jax_densify_inputs(js, JHyper(**hyper), np.float32(extent), size_thr)
        t_in = cp.densify_inputs(ts, DensifyHyper(**hyper), extent, size_thr)
        jn, jd = jloop._densify_step(js, key, JHyper(**hyper), size_thr,
                                     np.float32(extent))
        noise = torch.as_tensor(draws[f"it{it}_C{cp.ARM_CAPACITY}"])
        tn, td = densify_and_prune(ts, noise, DensifyHyper(**hyper), extent,
                                   size_thr)
        masks = {k: int((j_in[k] != t_in[k]).sum())
                 for k in ("clone", "split", "prune")}
        worst = 0.0
        for a, b in zip(tree_leaves(tn), jax.tree.leaves(jn)):
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype == np.float32 and a.size:
                worst = max(worst, float(np.abs(a - b).max()
                                         / max(float(np.abs(b).max()), 1e-30)))
            elif not np.array_equal(a, b):
                worst = float("inf")
        rows.append({"state": os.path.basename(state), "iteration": it,
                     "size_thr": size_thr, "alive": int(j_in["alive"].sum()),
                     "clone": int(j_in["clone"].sum()),
                     "split": int(j_in["split"].sum()),
                     "prune": int((j_in["prune"] & ~j_in["split"]).sum()),
                     "masks_differ": masks, "dropped": [int(jd), int(td)],
                     "points_after": [int(np.asarray(jn.aux.alive).sum()),
                                      int(tn.aux.alive.sum())],
                     "state_max_diff_of_leaf_max": worst})
        print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(args.keep, "densify_same_inputs.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("noise", "arm", "densify"):
        p = sub.add_parser(name)
        p.add_argument("--out_dir", default=os.path.join(ROOT, "build", "parity20k"))
        p.add_argument("--frames", type=int, default=60)
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--until", type=int, default=12000)
        p.add_argument("--interval", type=int, default=None)
    n = sub.choices["noise"]
    n.add_argument("--from_it", type=int, default=11000)
    n.add_argument("--out", default=os.path.join(ROOT, "build", "parity20k",
                                                 "noise.npz"))
    a = sub.choices["arm"]
    a.add_argument("--arm", default="jax_cpu")
    a.add_argument("--from_state", required=True)
    a.add_argument("--noise", default=None)
    a.add_argument("--no_eval", action="store_true")
    a.add_argument("--keep", default=os.path.join(ROOT, "chiprun_out", "parity20k"))
    d = sub.choices["densify"]
    d.add_argument("--pre_state", nargs="+", required=True)
    d.add_argument("--noise", required=True)
    d.add_argument("--keep", default=os.path.join(ROOT, "chiprun_out", "parity20k"))
    args = ap.parse_args(argv)
    return {"noise": cmd_noise, "arm": cmd_arm, "densify": cmd_densify}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
