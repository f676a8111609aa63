"""The readings of the program's spans (``harness/spans.py``) and the
per-layer readers built on them, on synthetic traced windows worked by
hand."""

import json
import os

import pytest

from harness import spans, spec
from harness.trace import Reading

# A training window of 10 s and 2 iterations; times in seconds.
TRAIN_CPU = [
    ("bench.window", 0.0, 10.0),
    ("trainer.step", 1.0, 9.0),
    ("train_step.forward", 2.0, 6.0),
    ("deform.query", 2.0, 3.0),  # starts with the forward: the inner one
    ("render.binning", 4.0, 5.0),
    ("aten::mm", 4.2, 4.3),  # not a program span
    ("loss.frame", 5.5, 6.0),
    ("train_step.backward", 6.0, 7.0),
    ("trainer.replay", 7.0, 7.5),
    ("train_step.update", 7.5, 8.0),
    ("trainer.wait", 8.0, 8.5),
]
# Busy 4.75 s; idle [0, 0.5], [2.5, 3.5], [4.5, 6.5], [8.25, 10].
TRAIN_DEV = [("k0", 0.5, 2.5), ("k1", 3.5, 4.5), ("k2", 6.5, 8.25)]
IDLE_BY_OWNER = {None: 0.5 + 1.0, "deform.query": 0.5,
                 "train_step.forward": 0.5 + 0.5, "render.binning": 0.5,
                 "loss.frame": 0.5, "train_step.backward": 0.5,
                 "trainer.wait": 0.25, "trainer.step": 0.5}


def reading(cpu, dev, units=2, kind="train"):
    return Reading(kind, cpu, dev, units, None, {}, 0.0, {})


def program_metrics(kind):
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m["name"] for m in bench["per_layer"]
            if m["source"] == "program_span" and m["name"].startswith(kind)
            and m["name"] not in ("train.host_ms_per_iter",
                                  "train.events_ms_per_iter")]


def test_idle_goes_to_the_innermost_span():
    r = reading(TRAIN_CPU, TRAIN_DEV)
    owned = spans.idle_by_owner(r)
    assert owned == pytest.approx(IDLE_BY_OWNER)
    assert sum(owned.values()) == pytest.approx(r.window_s - r.busy_s)
    assert spans.idle_ms(r, ("deform.query",)) == pytest.approx(250.0)
    assert spans.idle_ms(r, spans.TRAINER) == pytest.approx(375.0)
    assert spans.idle_ms(r, ("train_step.update",)) == 0.0
    assert spans.idle_ms(r, ("trainer.densify",)) is None


def test_latest_started_span_owns_an_overlap():
    # Two spans that overlap without nesting: the later start owns the
    # overlap, the earlier one the rest of itself.
    cpu = [("bench.window", 0.0, 4.0), ("trainer.step", 0.0, 4.0),
           ("deform.query", 1.0, 3.0), ("loss.frame", 2.0, 3.5)]
    owned = spans.idle_by_owner(reading(cpu, [], units=1))
    assert owned == pytest.approx({"trainer.step": 1.5, "deform.query": 1.0,
                                   "loss.frame": 1.5})


def test_self_time_leaves_out_nested_spans():
    r = reading(TRAIN_CPU, TRAIN_DEV)
    # forward 4 s less deform 1, binning 1 and loss 0.5, over 2 iterations
    assert spans.self_ms(r, ("train_step.forward",)) == pytest.approx(750.0)
    # step 8 s less forward 4, backward 1, replay, update and wait 0.5 each
    assert spans.self_ms(r, ("trainer.step",)) == pytest.approx(750.0)
    assert spans.self_ms(r, spans.RENDER) == pytest.approx(500.0)
    assert spans.self_ms(r, ("loss.frame",)) == pytest.approx(250.0)
    assert spans.self_ms(r, ("trainer.reset",)) is None


def test_count_per_kunit():
    r = reading(TRAIN_CPU, TRAIN_DEV)
    assert spans.count_per_kunit(r, ("trainer.replay",)) == pytest.approx(500.0)
    no_replay = [s for s in TRAIN_CPU if s[0] != "trainer.replay"]
    assert spans.count_per_kunit(reading(no_replay, TRAIN_DEV),
                                 ("trainer.replay",)) == 0.0


def test_train_readers_partition_the_idle_time():
    r = reading(TRAIN_CPU, TRAIN_DEV)
    idle = [spec.reader(n)(r) for n in program_metrics("train.")
            if "_idle_" in n]
    assert len(idle) == 7 and None not in idle
    outside = 1e3 * IDLE_BY_OWNER[None] / r.units
    assert sum(idle) + outside == pytest.approx(
        1e3 * (r.window_s - r.busy_s) / r.units)


def test_serve_readers():
    cpu = [("bench.window", 0.0, 4.0), ("bench.frame", 0.0, 4.0),
           ("serve.frame", 0.5, 3.5), ("deform.query", 0.5, 1.0),
           ("render.preprocess", 1.0, 1.5), ("render.composite", 1.5, 2.0),
           ("serve.to_host", 2.0, 3.0)]
    dev = [("k", 0.75, 1.25), ("copy", 2.5, 3.0)]
    r = reading(cpu, dev, units=1, kind="serve")
    values = {n: spec.reader(n)(r) for n in program_metrics("serve.")}
    assert values == pytest.approx({
        "serve.deform_host_ms_per_frame": 500.0,
        "serve.raster_host_ms_per_frame": 1000.0,
        "serve.to_host_ms_per_frame": 1000.0,
        "serve.deform_idle_ms_per_frame": 250.0,
        "serve.raster_idle_ms_per_frame": 750.0,
        "serve.frame_idle_ms_per_frame": 500.0 + 500.0})
    outside = spans.idle_by_owner(r)[None]
    assert sum(v for n, v in values.items() if "_idle_" in n) + 1e3 * outside \
        == pytest.approx(1e3 * (r.window_s - r.busy_s))


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_readers_return_none_without_the_programs_spans(kind):
    # The parent commit's program: the three step spans, nothing else.
    cpu = [("bench.window", 0.0, 10.0), ("bench.step", 1.0, 9.0),
           ("train_step.forward", 2.0, 6.0), ("train_step.backward", 6.0, 7.0),
           ("train_step.update", 7.0, 8.0)]
    r = reading(cpu, TRAIN_DEV, kind=kind)
    names = program_metrics(kind + ".")
    assert names
    assert all(spec.reader(n)(r) is None for n in names)
