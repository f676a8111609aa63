"""A serving cell: a closed loop with one client (a viewer, an evaluation).

Set-up writes the seed-made state as a trained model's artifacts, loads
them with ``render_sets.load_trained`` and renders every camera once. The
window sends one frame request at a time, each for the next of the
scene's camera poses and times in order, cycling: ``render_sets.
render_frame`` serves it, the frame is complete when its arrays reach the
host, and the next request is sent then."""

from __future__ import annotations

import gc
import os
import random
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import checks, scenes, state
from harness.trace import CompositeCalls
from harness.train import (
    DeformCount,
    dynamic_rows,
    peak_bytes,
    program_config,
    sync,
)


def served_state(cell, seed: int, device, model_dir: str,
                 cache: str = scenes.CACHE):
    """The cell's config as run, the served state from ``seed``, and the
    seconds spent writing the scene."""
    src, written = scenes.scene_dir(cell, cache)
    cfg = program_config(cell, src, model_dir, seed)
    s = cell.layout.start_state(cfg, cell.scene, seed, int(cfg["num_points"]),
                                0, device)
    return cfg, s, written


def closed_loop(render, n_cameras: int, outputs: dict, checked,
                seconds: float = 0.0, n_frames: int = 0):
    """Request frames one after another, camera after camera in order,
    for ``seconds`` (or ``n_frames`` frames). Returns each frame's latency,
    from its request to its arrays on the host, and the window's length.
    Keeps the outputs of the first rendering of each camera in
    ``checked``."""
    latencies = []
    t0 = time.perf_counter()
    k = 0
    while True:
        i = k % n_cameras
        t = time.perf_counter()
        arrays = render(i)
        latencies.append(time.perf_counter() - t)
        if i in checked and i not in outputs:
            outputs[i] = arrays
        k += 1
        if (n_frames and k >= n_frames) or (
                not n_frames and time.perf_counter() - t0 >= seconds):
            break
    return latencies, time.perf_counter() - t0


class Server:
    """The loaded model and the capacities its frames have grown to."""

    def __init__(self, render_sets, trainer, requests, static):
        self.render_sets, self.trainer = render_sets, trainer
        self.requests, self.static = requests, static

    def __call__(self, i: int) -> dict:
        self.static, arrays, _ = self.render_sets.render_frame(
            self.trainer, self.static, self.requests[i])
        return arrays


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        cache: str = scenes.CACHE) -> dict:
    from gftorf_tpu_torch import render_sets
    from gftorf_tpu_torch.data.scene import take_frame
    from gftorf_tpu_torch.render.kernels import dense, flat

    tr = cell.traffic
    tmp = tempfile.TemporaryDirectory(prefix="gftorf-bench-")
    model_dir = os.path.join(tmp.name, "model")
    cfg, s, written = served_state(cell, seed, device, model_dir, cache)
    iteration = int(tr["iteration"])
    state.write_artifacts(model_dir, s, cfg, iteration, cfg["D"])

    trainer, _, _ = render_sets.load_trained(model_dir, iteration, device=device)
    frames = trainer.scene.train_frames
    ids = frames.frame_id.cpu().tolist()
    requests = [take_frame(frames, i)._replace(
        frame_id=torch.tensor(fid, dtype=torch.int32))
        for i, fid in enumerate(ids)]
    server = Server(render_sets, trainer, requests, trainer.with_capacities(
        trainer._static_for(max(trainer.iteration, 1))))
    for _ in range(int(tr["warm_up_passes"])):
        for i in range(len(requests)):
            server(i)
    sync(device)
    setup_s = time.perf_counter() - t_start - written

    checked = sorted(random.Random(seed).sample(range(len(requests)),
                                                int(tr["checked_frames"])))
    outputs = {}
    out = {"setup_s": setup_s, "scene_write_s": written}
    if trace:
        out["reading"] = _traced_window(
            server, int(tr["trace_frames"]), cfg, render_sets,
            CompositeCalls(dense, flat), device, outputs, checked)
        done = int(tr["trace_frames"])
    else:
        latencies, window = closed_loop(server, len(requests), outputs,
                                        checked, seconds=seconds)
        done = len(latencies)
        out["serve_ms_per_frame"] = 1e3 * window / done
        out["serve_p95_ms"] = 1e3 * float(np.percentile(latencies, 95))
    out["memory_peak_bytes"] = peak_bytes(device)
    out["attempted"] = done
    out["failed"] = sum(not all(np.isfinite(a).all() for a in o.values())
                        for o in outputs.values())
    del trainer, requests, frames, server

    def reference(control=False):
        """The numbers, once the program's state is freed. With
        ``control``, also the control's numbers: the reference with TF32
        matrix products in the program's place."""
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        driver = cell.layout.reference()
        sc = driver.read_scene(cfg["source_path"], cfg, device)
        order = sorted(outputs)

        def frames_of():
            return driver.render(cfg, sc, s.params, s.deform,
                                 s.aux["alive"], iteration, order)

        ref = frames_of()
        numbers = checks.frame_gap([outputs[i] for i in order], ref)
        numbers["frames_missing"] = float(len(checked) - len(order))
        tmp.cleanup()
        if not control:
            return numbers
        from harness.train import lowered

        return numbers, checks.frame_gap(lowered(frames_of), ref)

    out["reference"] = reference
    return out


def _traced_window(server, n_frames, cfg, render_sets, calls, device,
                   outputs, checked):
    from harness.trace import Reading, profiler_events

    trainer = server.trainer
    live = dynamic_rows(trainer.model)
    cap = trainer.model.aux.alive.shape[0]
    deform = DeformCount(render_sets, cfg, backward=False,
                         rows_of=lambda: (trainer.deform_bucket or cap, live))

    def render(i):
        with record_function("bench.frame"):
            return server(i)

    calls.install()
    deform.install()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with record_function("bench.window"):
                closed_loop(render, len(server.requests), outputs, checked,
                            n_frames=n_frames)
                sync(device)
    finally:
        calls.uninstall()
        deform.uninstall()
    cpu, dev = profiler_events(prof)
    reading = Reading("serve", cpu, dev, n_frames, calls.work(),
                      calls.n, deform.ops,
                      {"forward": "dense_forward_kernel"})
    calls.release()
    return reading
