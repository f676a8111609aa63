"""The port's spans (``gftorf_tpu_torch/utils/trace.py``) on the CPU.

One toy Trainer for the module (a 16x16 ftorf scene of 64 Gaussians, 300
points, a D=2 W=16 deform MLP, flow on, one thread): under
``torch.profiler`` a ``Trainer.step()`` and a served frame emit the spans
of ``SPANS`` with their nesting, a forced capacity overflow one
``trainer.replay`` per re-dispatched step; with no profiler the program
opens no ``record_function`` range. An AST scan holds ``SPANS`` to the
``span("...")`` calls of the package. ``iter_time`` sums to the time spent
in ``Trainer.step()``.
"""

import ast
import pathlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gftorf_tpu_torch import render_sets
from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.generate import make_gt_gaussians, write_dataset
from gftorf_tpu_torch.data.scene import take_frame
from gftorf_tpu_torch.train.loop import Trainer
from gftorf_tpu_torch.utils import trace

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "gftorf_tpu_torch"
NAMES = [name for name, _ in trace.SPANS]
STEP_SPANS = ("train_step.forward", "train_step.backward", "train_step.update")


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    src = str(tmp_path_factory.mktemp("trace_scene") / "s")
    g = make_gt_gaussians(torch.Generator().manual_seed(0), num_static=48,
                          num_dynamic=16)
    write_dataset(src, num_frames=8, width=16, height=16, g=g, device="cpu")
    cfg = dict(source_path=src, model_path="", total_num_views=8,
               tof_image_width=16, tof_image_height=16, color_image_width=16,
               color_image_height=16, depth_range=15.0, num_points=300, D=2,
               W=16, iterations=100, warm_up=1, use_quad=True, dynamic=True,
               dataset_type="quad", max_per_tile=512, max_per_tile_limit=1024)
    tr = Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")
    for _ in range(3):  # past the warm-up, the pipeline full
        tr.step()
    yield tr
    torch.set_num_threads(threads)


def spans_of(prof):
    """(name, start_ns, end_ns) of the program's spans, by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in NAMES), key=lambda s: s[1])


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans_of(prof)


def inside(spans, child, parent):
    """Every ``child`` span lies inside some ``parent`` span."""
    kids = [s for s in spans if s[0] == child]
    outer = [s for s in spans if s[0] == parent]
    return bool(kids) and all(any(a <= s[1] and s[2] <= b for _, a, b in outer)
                              for s in kids)


def test_span_is_a_shared_noop_without_profiler():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("trainer.step") is trace.span("render.binning")
    with trace.span("trainer.step"):
        pass


def test_no_record_function_without_profiler(trainer, monkeypatch):
    opened = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function",
                        lambda name: opened.append(name) or real(name))
    trainer.step()
    frame, static = served(trainer)
    render_sets.render_frame(trainer, static, frame)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.step()
    assert "trainer.step" in opened


def test_step_spans_nest(trainer):
    _, spans = profiled(trainer.step)
    names = [s[0] for s in spans]
    assert names.count("trainer.step") == 1
    assert len(spans) <= 20
    for child in ("deform.query", "render.preprocess", "render.binning",
                  "render.composite", "loss.frame"):
        assert inside(spans, child, "train_step.forward"), child
    for child in STEP_SPANS + ("trainer.wait",):
        assert inside(spans, child, "trainer.step"), child
    # Preprocess, then binning, then compositing, in each render.
    order = [n for n in names if n.startswith("render.")]
    assert order == ["render.preprocess", "render.binning",
                     "render.composite"] * (len(order) // 3)


@pytest.mark.parametrize("name", STEP_SPANS)
def test_step_span_names_unchanged(trainer, name):
    _, spans = profiled(trainer.step)
    assert [s[0] for s in spans].count(name) == 1


def test_replays_are_counted(trainer):
    dispatched = []
    real = trainer._dispatch

    def dispatch(*a):
        dispatched.append(a[0])
        return real(*a)

    trainer.drain()
    trainer._dispatch = dispatch
    trainer.tile_cap = 128  # the tile overflows: grow and replay
    try:
        _, spans = profiled(lambda: [trainer.step(), trainer.step(),
                                     trainer.drain()])
    finally:
        del trainer._dispatch
    replayed = len(dispatched) - 2
    assert replayed > 0 and trainer.tile_cap > 128
    assert [s[0] for s in spans].count("trainer.replay") == replayed


def served(trainer):
    frames = trainer.scene.train_frames
    frame = take_frame(frames, 0)._replace(
        frame_id=torch.tensor(int(frames.frame_id[0]), dtype=torch.int32))
    static = trainer.with_capacities(trainer._static_for(trainer.iteration))
    return frame, static


def test_served_frame_spans_nest(trainer):
    frame, static = served(trainer)
    _, spans = profiled(lambda: render_sets.render_frame(trainer, static,
                                                         frame))
    names = [s[0] for s in spans]
    assert names.count("serve.frame") == 1 and len(spans) <= 12
    assert inside(spans, "serve.to_host", "serve.frame")
    for child in ("deform.query", "render.preprocess", "render.binning",
                  "render.composite"):
        assert inside(spans, child, "serve.frame"), child


@pytest.mark.parametrize("lag", [1, 0])
def test_iter_time_sums_to_time_in_step(trainer, lag):
    """Host time between the calls (the sleeps) is no record's."""
    trainer.drain()
    first = trainer.iteration + 1
    spent = 0.0
    kept, trainer.metrics_lag = trainer.metrics_lag, lag
    try:
        for _ in range(6):
            t0 = time.perf_counter()
            trainer.step()
            spent += time.perf_counter() - t0
            time.sleep(0.02)
        trainer.drain()
    finally:
        trainer.metrics_lag = kept
    recs = [h for h in trainer.history if h["iteration"] >= first]
    assert [h["iteration"] for h in recs] == list(range(first, first + 6))
    assert sum(h["iter_time"] for h in recs) == pytest.approx(spent, rel=0.05)


@pytest.fixture(scope="module")
def span_calls():
    """(file, name) of every ``span("...")`` call in the package, and the
    files that name ``record_function``."""
    calls, users = [], []
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        rel = path.relative_to(PACKAGE).as_posix()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                calls.append((rel, node.args[0].value))
            if getattr(node, "id", getattr(node, "attr", None)) == \
                    "record_function" or (isinstance(node, ast.alias)
                                          and node.name == "record_function"):
                users.append(rel)
    return calls, users


def test_every_span_call_is_listed(span_calls):
    calls, users = span_calls
    assert calls and all(name in NAMES for _, name in calls), calls
    assert set(users) == {"utils/trace.py"}
    assert len(set(NAMES)) == len(NAMES)
    assert not any(n.startswith("bench.") for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_listed_span_is_emitted(span_calls, name):
    calls, _ = span_calls
    assert any(n == name for _, n in calls)
