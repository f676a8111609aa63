"""A training cell: the program's Trainer resumed from the benchmark's start
state and stepped with ``Trainer.step()`` through the config's own
cadence.

Set-up builds one Trainer, hands it the start state through
``Trainer.load_checkpoint``, drives it through its first steps (the steps
the reference follows) and on through the warm-up, which covers the
capacity growth, the replays and the first shrink (``shrink_window``).
The window steps the same Trainer until ``--seconds`` are spent, then
drains it and synchronises. Then the reference runs."""

from __future__ import annotations

import functools
import gc
import math
import os
import random
import statistics
import sys
import tempfile
import time

import torch
from torch.profiler import record_function

from harness import checks, scenes, state
from harness.trace import CompositeCalls
# The default layout's start box and cadence, which the state and densify
# tests read here.
from layouts.tof import start_bounds, start_meta  # noqa: F401
from traffic import peaks


def program_config(cell, scene_dir: str, model_dir: str, seed: int) -> dict:
    """The cell's config with the keys the harness sets at run time."""
    return dict(cell.config, source_path=scene_dir, model_path=model_dir,
                seed=seed % 2**32)


def capacity_for(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def dynamic_rows(model) -> int:
    """Live rows whose frozen segmentation colour marks them dynamic."""
    return int(((model.params.seg_color[:, 0] > 0.5) & model.aux.alive).sum())


class Events:
    """The Trainer's densify and opacity-reset calls wrapped in the spans
    ``bench.densify`` and ``bench.reset``. Keeps the state before and after
    the first densify at or after iteration ``keep_from`` (and the last one
    before it, where no later one comes) for the reference, and calls
    ``on_event`` after each event."""

    def __init__(self, trainer):
        self.keep_from = math.inf
        self.kept = None
        self.on_event = None
        densify, reset = trainer._densify, trainer._reset_opacity

        def wrapped_densify(size_thr):
            pre, it = trainer.model, trainer.iteration
            with record_function("bench.densify"):
                densify(size_thr)
            if self.kept is None or self.kept["it"] < self.keep_from:
                self.kept = {"it": it, "size_thr": size_thr, "pre": pre,
                             "post": trainer.model}
            if self.on_event:
                self.on_event()

        def wrapped_reset():
            with record_function("bench.reset"):
                reset()
            if self.on_event:
                self.on_event()

        trainer._densify = wrapped_densify
        trainer._reset_opacity = wrapped_reset


class DeformCount:
    """fp32 operations of the deform MLP's GEMMs over the rows each call
    queries (the dynamic live rows, not the padded bucket), forward and
    backward. Installed in place of the step's ``apply_deform``."""

    def __init__(self, module, cfg: dict, backward: bool, rows_of):
        self.module, self.backward, self.rows_of = module, backward, rows_of
        ins, heads = state.deform_widths(cfg)
        self.ins, self.width = ins, cfg["W"]
        # apply_deform evaluates the xyz and r, g, b heads only.
        self.heads = [heads[h] for h in ("xyz", "r", "g", "b")]
        self.ops = 0.0
        self._orig = module.apply_deform

    def install(self):
        orig = self._orig

        @functools.wraps(orig)
        def apply_deform(params, config, xyz, t, x_emb=None):
            bucket, live = self.rows_of()
            rows = xyz.shape[0] // bucket * live
            self.ops += peaks.deform_gemm_ops(self.ins, self.width, self.heads,
                                              rows, self.backward)
            return orig(params, config, xyz, t, x_emb=x_emb)

        self.module.apply_deform = apply_deform

    def uninstall(self):
        self.module.apply_deform = self._orig


def start_checkpoint(cell, seed: int, device, tmp: str,
                     cache: str = scenes.CACHE):
    """The cell's config as run, its start state from ``seed`` (the
    benchmark's own tensors), that state written as a Trainer checkpoint
    under ``tmp``, and the seconds spent writing the scene."""
    src, written = scenes.scene_dir(cell, cache)
    ckpt = os.path.join(tmp, "start.npz")
    cfg = program_config(cell, src, os.path.join(tmp, "model"), seed)
    start = int(cell.traffic["start_iteration"])
    s = cell.layout.start_state(cfg, cell.scene, seed,
                                capacity_for(cfg["num_points"]), start, device)
    state.write_checkpoint(ckpt, s, cfg["D"],
                           cell.layout.start_meta(cfg, start))
    return cfg, ckpt, s, written


class WindowStep:
    """Keeps the state before and after the step of iteration ``target``
    (its last dispatch, where a replay came), by wrapping the Trainer's
    ``train_step``; the wrapper adds one Python call a step."""

    def __init__(self, loop_module, target: int):
        self.module, self.target, self.kept = loop_module, target, None
        self._real = loop_module.train_step

    def install(self):
        real = self._real

        @functools.wraps(real)
        def train_step(static, model, deform, deform_adam, frames, idx, it,
                       *a, **kw):
            out = real(static, model, deform, deform_adam, frames, idx, it,
                       *a, **kw)
            if int(it) == self.target:
                self.kept = {"it": int(it), "idx": idx,
                             "pre": (model, deform, deform_adam),
                             "post": tuple(out[:3])}
            return out

        self.module.train_step = train_step

    def uninstall(self):
        self.module.train_step = self._real


def window_target(seed: int, it0: int, within: int) -> int:
    """The iteration of the window whose step is checked: one of its first
    ``within``, drawn from the seed."""
    return it0 + 1 + random.Random(seed).randrange(max(1, within))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        cache: str = scenes.CACHE) -> dict:
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.render.kernels import dense, flat
    from gftorf_tpu_torch.train import loop
    from gftorf_tpu_torch.train import step as step_module
    from gftorf_tpu_torch.train.loop import Trainer

    tr = cell.traffic
    tmp = tempfile.TemporaryDirectory(prefix="gftorf-bench-")
    cfg, ckpt, start_state, written = start_checkpoint(cell, seed, device,
                                                       tmp.name, cache)

    trainer = Trainer(Config.from_dict(cfg), startup_artifacts=False,
                      device=device)
    trainer.load_checkpoint(ckpt)
    events = Events(trainer)
    first = checks.first_steps(trainer, int(tr["checked_steps"]))
    for _ in range(int(tr["warm_up_iterations"]) - int(tr["checked_steps"])):
        trainer.step()
    trainer.drain()
    sync(device)
    setup_s = time.perf_counter() - t_start - written

    it0 = trainer.iteration
    events.keep_from = it0 + 1
    checked = WindowStep(loop, window_target(seed, it0,
                                             int(tr["checked_within"])))
    checked.install()
    out = {"setup_s": setup_s, "scene_write_s": written}
    try:
        if trace:
            out["reading"] = _traced_window(trainer, events, cfg, tr,
                                            CompositeCalls(dense, flat),
                                            step_module, device)
            units = trainer.iteration - it0
        else:
            t0 = time.perf_counter()
            stamps = [t0]
            while True:
                trainer.step()
                stamps.append(time.perf_counter())
                if stamps[-1] - t0 >= seconds:
                    break
            trainer.drain()
            sync(device)
            window = time.perf_counter() - t0
            units = trainer.iteration - it0
            out["train_ms_per_iter"] = 1e3 * window / units
            gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
            if len(gaps) > 1:
                q = statistics.quantiles(gaps, n=4)
                print(f"host ms a step: quartiles "
                      f"{[round(1e3 * x, 3) for x in q]}, slowest "
                      f"{[round(1e3 * x, 3) for x in gaps[-5:]]}",
                      file=sys.stderr)
    finally:
        checked.uninstall()
    out["memory_peak_bytes"] = peak_bytes(device)
    losses = [h["loss"] for h in trainer.history if h["iteration"] > it0]
    out["attempted"] = units
    out["failed"] = sum(not math.isfinite(x) for x in losses) + (units
                                                                 - len(losses))
    window_loss = {h["iteration"]: h["loss"] for h in trainer.history}
    kept, step_kept = events.kept, checked.kept
    if step_kept is not None:
        step_kept["loss"] = float(window_loss[step_kept["it"]])
    del trainer, events, checked

    def reference(control=False):
        """The numbers, once the program's state is freed. With
        ``control``, also the control's numbers: the reference with TF32
        matrix products in the program's place."""
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        driver = cell.layout.reference()
        sc = driver.read_scene(cfg["source_path"], cfg, device)
        ref_start = driver.start(start_state.params, start_state.aux,
                                 start_state.deform, start_state.step)
        schedule = list(zip(first["iteration"], first["camera"]))

        def ref_first():
            return checks.reduce_steps(ref_start, *driver.follow(
                cfg, sc, ref_start, schedule, cfg["seed"]))

        ref = ref_first()
        numbers = checks.step_numbers(first, ref)
        print("worst leaves:", checks.worst_leaves(first, ref),
              file=sys.stderr)
        low = checks.step_numbers(lowered(ref_first), ref) if control else {}
        numbers["window_missing"] = float(step_kept is None)
        if step_kept is not None:
            pre = checks.plain_state(*step_kept["pre"])
            it, fid = step_kept["it"], int(step_kept["idx"])

            def ref_step():
                (loss,), (post,) = driver.follow(cfg, sc, pre, [(it, fid)],
                                                 cfg["seed"])
                return checks.one_step(pre, post, loss)

            ref_one = ref_step()
            prog_one = checks.one_step(
                pre, checks.plain_state(*step_kept["post"]), step_kept["loss"])
            numbers.update(checks.window_numbers(prog_one, ref_one))
            print(f"window step {it}:",
                  checks.window_diagnostics(prog_one, ref_one), file=sys.stderr)
            if control:
                low_one = lowered(ref_step)
                low.update(checks.window_numbers(low_one, ref_one))
                print(f"window step {it}, control:",
                      checks.window_diagnostics(low_one, ref_one),
                      file=sys.stderr)
        if tr.get("densify"):
            numbers["densify_missing"] = float(kept is None)
        if kept is not None:
            numbers.update(driver.densify_numbers(
                checks.model_state(kept["pre"]),
                checks.model_state(kept["post"]), cfg, sc, kept["it"]))
        tmp.cleanup()
        return (numbers, low) if control else numbers

    out["reference"] = reference
    return out


def lowered(fn):
    """``fn()`` with every float32 matrix product in TF32."""
    from reference.lower import tf32_matmuls

    with tf32_matmuls():
        return fn()


def _traced_window(trainer, events, cfg, tr, calls, step_module, device):
    from harness.trace import Reading, profiler_events

    n_iters = int(tr["trace_iterations"])
    live = {"rows": dynamic_rows(trainer.model)}

    def on_event():
        live["rows"] = dynamic_rows(trainer.model)

    def rows_of():
        cap = trainer.model.aux.alive.shape[0]
        return trainer.deform_bucket or cap, live["rows"]

    events.on_event = on_event
    deform = DeformCount(step_module, cfg, backward=True, rows_of=rows_of)
    calls.install()
    deform.install()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with record_function("bench.window"):
                for _ in range(n_iters):
                    with record_function("bench.step"):
                        trainer.step()
                trainer.drain()
                sync(device)
    finally:
        calls.uninstall()
        deform.uninstall()
        events.on_event = None
    cpu, dev = profiler_events(prof)
    reading = Reading("train", cpu, dev, n_iters, calls.work(), calls.n,
                      deform.ops, {"forward": "dense_forward_kernel",
                                   "backward": "dense_backward_kernel"})
    calls.release()
    return reading


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
