"""A whole run of each cell, with the look for a card skipped, at a toy size
on the CPU: ``correct`` holds for the program as it is and comes out false
with the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced), and the control (the reference with TF32 matrix products in the
program's place) reads past the cell's limits."""

import time

import pytest
import torch

from conftest import small_cell
from harness import checks, faults, main

SEED = 2**31 + 77
CPU = torch.device("cpu")


def _run(name, cache, trace=False):
    # A serving window covers every camera, the checked ones among them.
    seconds = 5.0 if name.endswith("serve") else 0.5
    return main.run_cell(small_cell(name), SEED, seconds, trace, CPU,
                         time.perf_counter(), cache=cache)


@pytest.mark.parametrize("name", ["ftorf.train.densify", "torf.train.densify",
                                  "ftorf.train.frozen", "ftorf.serve"])
def test_sound_run_is_correct(name, scene_cache):
    line = _run(name, scene_cache)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["metrics"] and line["attempted"] > 0


def test_traced_run_prints_the_per_layer_metrics(scene_cache):
    line = _run("ftorf.train.densify", scene_cache, trace=True)
    assert line["correct"]
    assert "train.host_ms_per_iter" in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("name", ["ftorf.train.densify", "torf.train.densify",
                                  "ftorf.train.frozen"])
def test_broken_training_step_is_not_correct(name, fault, monkeypatch,
                                             scene_cache):
    faults.TRAIN[fault](monkeypatch.setattr)
    assert not _run(name, scene_cache)["correct"]


def test_altered_frame_is_not_correct(monkeypatch, scene_cache):
    faults.altered_frame(monkeypatch.setattr)
    assert not _run("ftorf.serve", scene_cache)["correct"]


@pytest.mark.parametrize("name", ["ftorf.train.densify", "torf.train.densify",
                                  "ftorf.train.frozen", "ftorf.serve"])
def test_control_fails_the_limits(name, scene_cache, monkeypatch):
    import calibrate
    from harness import scenes

    monkeypatch.setattr(scenes, "CACHE", scene_cache)
    cell = small_cell(name)
    seconds = 5.0 if name.endswith("serve") else 0.5
    line = calibrate.readings(cell, SEED, seconds, True, CPU)
    assert checks.judge(line["numbers"], cell.limits), line["numbers"]
    assert not checks.judge(line["control"], cell.limits), line["control"]
