"""The port's benchmark entry points (``gftorf_tpu_torch/bench.py``,
``bench_train.py``) against the root ``bench.py`` / ``bench_train.py``
on the CPU. About 25 s in one process.

- The workload equals JAX's: the root scripts run with the JAX modules
  they import inside ``main`` (``gftorf_tpu.data.generate.write_dataset``,
  ``gftorf_tpu.train.loop.Trainer``, ``gftorf_tpu.data.synthetic.
  make_scene``) replaced by stubs that record their arguments (and the
  global ``np.random`` state) and stop; the port's entry points run with
  its own modules stubbed the same way; the records must agree field for
  field: the writer's frames and size after ``np.random.seed(7)``, every
  Config field but the two paths (the port writes under its own
  directory), the Trainer built after ``np.random.seed(7)`` without
  start-up artifacts, the rasterizer scene's parameters from seed 0.
- Both modes run end to end at a toy size, and the last line has the
  root scripts' shape: metric name, unit and ``vs_baseline`` formula.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from gftorf_tpu_torch import bench as t_bench
from gftorf_tpu_torch import bench_train as t_bench_train


class Stop(Exception):
    pass


def seeded_state(seed):
    np.random.seed(seed)
    return np.random.get_state()


def same_rng_state(a, b):
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def recorder(calls, name, stop):
    def stub(*args, **kw):
        calls[name] = (args, kw, np.random.get_state())
        if stop:
            raise Stop
    return stub


@pytest.fixture
def jax_calls(monkeypatch):
    """Run the root bench.py's main with argv; returns the stubs' records."""
    import gftorf_tpu.data.generate as jg
    import gftorf_tpu.data.synthetic as js
    import gftorf_tpu.train.loop as jl
    import gftorf_tpu.utils.runtime as jr

    import bench

    isdir = os.path.isdir

    def run(argv):
        calls = {}
        # bench_train.py writes its scene unless /tmp holds one already.
        monkeypatch.setattr(os.path, "isdir", lambda p: False if str(p).startswith(
            "/tmp/bench_train_scene_") else isdir(p))
        monkeypatch.setattr(jr, "enable_compilation_cache", lambda: None)
        monkeypatch.setattr(jg, "write_dataset", recorder(calls, "write", False))
        monkeypatch.setattr(jl, "Trainer", recorder(calls, "trainer", True))
        monkeypatch.setattr(js, "make_scene", recorder(calls, "scene", True))
        monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
        with pytest.raises(Stop):
            bench.main()
        return calls
    return run


@pytest.fixture
def port_calls(monkeypatch, tmp_path):
    import gftorf_tpu_torch.data.generate as tg
    import gftorf_tpu_torch.data.synthetic as ts
    import gftorf_tpu_torch.train.loop as tl

    def run(argv):
        calls = {}
        monkeypatch.setattr(t_bench_train, "BENCH_DIR", str(tmp_path))
        monkeypatch.setattr(tg, "write_dataset", recorder(calls, "write", False))
        monkeypatch.setattr(tl, "Trainer", recorder(calls, "trainer", True))
        monkeypatch.setattr(ts, "make_scene", recorder(calls, "scene", True))
        with pytest.raises(Stop):
            t_bench.main(argv)
        return calls
    return run


@pytest.mark.parametrize("argv", [
    [], ["--iters", "40", "--warm", "12", "--points", "777", "--width", "72",
         "--height", "40", "--set", "lambda_flow=0.02", "--set", "warm_up=5"]],
    ids=["defaults", "overrides"])
def test_train_workload_matches_jax(jax_calls, port_calls, argv):
    j, t = jax_calls(argv), port_calls(argv + ["--device", "cpu"])
    seven = seeded_state(7)
    for calls in (j, t):
        assert same_rng_state(calls["write"][2], seven)
        assert same_rng_state(calls["trainer"][2], seven)
        assert calls["trainer"][1]["startup_artifacts"] is False
    (j_src,), j_kw, _ = j["write"]
    (t_src,), t_kw, _ = t["write"]
    assert t_kw.pop("device").type == "cpu"
    assert t_kw == j_kw and j_kw["num_frames"] == 32
    scene = "scene_{width}x{height}".format(**j_kw)
    j_cfg = dataclasses.asdict(j["trainer"][0][0])
    t_cfg = dataclasses.asdict(t["trainer"][0][0])
    for cfg, src in ((j_cfg, j_src), (t_cfg, t_src)):
        cfg["model"].pop("model_path")
        assert cfg["model"].pop("source_path") == src and src.endswith(scene)
    assert t_cfg == j_cfg
    if argv:
        assert j_cfg["opt"]["lambda_flow"] == 0.02 and j_cfg["opt"]["warm_up"] == 5


def test_rasterizer_workload_matches_jax(jax_calls, port_calls):
    j, t = jax_calls(["--rasterizer"]), port_calls(["--rasterizer", "--device",
                                                     "cpu"])
    (key,), j_kw, _ = j["scene"]
    (gen,), t_kw, _ = t["scene"]
    assert np.array_equal(np.asarray(key), [0, 0]) and gen.initial_seed() == 0
    assert t_kw.pop("device").type == "cpu"
    assert t_kw == j_kw == t_bench.RASTER_SCENE
    assert t_bench.raster_metric(j_kw["width"], j_kw["height"],
                                 j_kw["num_points"]) == \
        "rasterize_fwd_bwd_640x480_100k"


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_bench_runs_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(t_bench_train, "BENCH_DIR", str(tmp_path))
    got = t_bench.main(["--device", "cpu", "--iters", "6", "--warm", "3",
                        "--points", "500", "--width", "64", "--height", "48"])
    assert last_line(capsys) == got
    assert sorted(got) == ["metric", "unit", "value", "vs_baseline"]
    assert (got["metric"], got["unit"]) == ("train_step", "ms/iter")
    assert got["value"] > 0
    assert abs(got["vs_baseline"] - 180.0 / got["value"]) < 1e-2


def test_rasterizer_bench_runs_on_cpu(capsys):
    got = t_bench.main(["--rasterizer", "--device", "cpu", "--points", "2000",
                        "--width", "96", "--height", "64"])
    assert last_line(capsys) == got
    assert sorted(got) == ["metric", "unit", "value", "vs_baseline"]
    assert (got["metric"], got["unit"]) == ("rasterize_fwd_bwd_96x64_2k",
                                            "Mpix/s/chip")
    assert got["value"] > 0
    assert abs(got["vs_baseline"] - got["value"] / 0.9) < 1e-2


def test_bench_needs_cuda_without_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main(["--rasterizer", "--points", "10"])
