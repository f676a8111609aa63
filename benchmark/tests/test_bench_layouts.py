"""Scene layouts (``benchmark/layouts/``): the default layout gives the
bits the harness gave before layouts existed, a layout made of one new
file runs a training and a serving cell with no harness code changed, and
a config that names no layout module stops before set-up."""

import hashlib
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, small_cell
from harness import main, scenes, spec, train
from test_bench_imports import _imports

ROOT = os.path.dirname(BENCH)
CPU = torch.device("cpu")
SEED = 2**31 + 19
# SHA-1 of each scene's files and of each cell's start state and start meta
# at conftest's small size, taken on the harness before layouts existed
# (``tree_digest`` and ``state_digest`` below, ``SEED``).
PARENT = {
    "scene.ftorf": "a2ad5309719ed11e03438d3078a030de2104b14e",
    "scene.torf": "d70add07c24e6c1a2b4062843edbee7852435ed8",
    "state.ftorf.train.densify": "f3697f4110d4b2e2239813ce83b435e9615fc979",
    "state.torf.train.densify": "60043116dc51e044e909db7c2d92300c3244b4ee",
    "state.ftorf.train.frozen": "3eebf3f9143a412398db5e3166f1b1f61f667f70",
    "state.ftorf.serve": "9239f629502233a237243083c56c3b86be85a5d8",
}
CELLS = ["ftorf.train.densify", "torf.train.densify", "ftorf.train.frozen",
         "ftorf.serve"]
FILES_ONLY = "files_only_test_layout"


def file_digest(path):
    if path.endswith(".mat"):  # savemat stamps its header with the time
        import scipy.io

        k = scipy.io.loadmat(path)["K"]
        return hashlib.sha1(np.ascontiguousarray(k).tobytes()
                            + str(k.dtype).encode()).hexdigest()
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def tree_digest(root):
    h = hashlib.sha1()
    for d, _, names in sorted(os.walk(root)):
        for n in sorted(names):
            p = os.path.join(d, n)
            h.update(os.path.relpath(p, root).encode() + b"\0"
                     + file_digest(p).encode())
    return h.hexdigest()


def state_digest(s, meta):
    h = hashlib.sha1()
    for group in (s.params, s.aux, s.deform):
        for k in sorted(group):
            t = group[k].detach().cpu().contiguous()
            h.update(k.encode() + str(t.dtype).encode()
                     + str(tuple(t.shape)).encode())
            h.update(t.numpy().tobytes())
    h.update(json.dumps([s.n, s.step, meta], sort_keys=True).encode())
    return h.hexdigest()


def test_shipped_configs_take_the_default_layout():
    for name in CELLS:
        assert spec.load(name).layout is importlib.import_module("layouts.tof")


@pytest.mark.parametrize("name", CELLS)
def test_default_layout_keeps_the_bits(name, tmp_path_factory):
    cell = small_cell(name)
    cache = str(tmp_path_factory.getbasetemp() / "layout_bits")
    src, _ = scenes.scene_dir(cell, cache)
    assert tree_digest(src) == PARENT["scene." + cell.config_name]
    cfg = train.program_config(cell, src, os.path.join(cache, "model"), SEED)
    if cell.traffic["kind"] == "train":
        start = int(cell.traffic["start_iteration"])
        s = cell.layout.start_state(cfg, cell.scene, SEED,
                                    train.capacity_for(cfg["num_points"]),
                                    start, CPU)
        meta = cell.layout.start_meta(cfg, start)
    else:
        s = cell.layout.start_state(cfg, cell.scene, SEED,
                                    int(cfg["num_points"]), 0, CPU)
        meta = None
    assert state_digest(s, meta) == PARENT["state." + name]


@pytest.mark.parametrize("path", sorted(
    os.path.join(BENCH, "layouts", n)
    for n in os.listdir(os.path.join(BENCH, "layouts")) if n.endswith(".py")),
    ids=os.path.basename)
def test_layouts_import_nothing_of_the_program(path):
    assert "gftorf_tpu_torch" not in set(_imports(path))


@pytest.fixture
def files_only_layout():
    """A layout made of one new file in ``layouts/``: the ``tof`` layout's
    functions under another name, each call recorded."""
    path = os.path.join(spec.LAYOUTS, FILES_ONLY + ".py")
    with open(path, "w") as f:
        f.write('"""The tof layout under another name, its calls recorded."""\n'
                "from layouts import tof\n\nCALLS = []\n\n\n"
                "def write(*a, **kw):\n    CALLS.append('write')\n"
                "    return tof.write(*a, **kw)\n\n\n"
                "def start_state(*a, **kw):\n    CALLS.append('start_state')\n"
                "    return tof.start_state(*a, **kw)\n\n\n"
                "def start_meta(*a, **kw):\n    CALLS.append('start_meta')\n"
                "    return tof.start_meta(*a, **kw)\n\n\n"
                "def reference():\n    CALLS.append('reference')\n"
                "    return tof.reference()\n")
    importlib.invalidate_caches()
    try:
        yield FILES_ONLY
    finally:
        os.remove(path)
        sys.modules.pop("layouts." + FILES_ONLY, None)


def _root_naming(tmp_path, layout):
    """A checkout's root whose ``ftorf`` config file names ``layout``, its
    traffic and limits those of this checkout."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs", "ftorf.json")) as f:
        raw = dict(json.load(f), layout=layout)
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    (tmp_path / "benchmark" / "configs" / "ftorf.json").write_text(
        json.dumps(raw))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("traffic", "workloads"):
        os.symlink(os.path.join(BENCH, sub), tmp_path / "benchmark" / sub)
    return str(tmp_path)


@pytest.mark.parametrize("name", ["ftorf.train.frozen", "ftorf.serve"])
def test_a_layout_of_new_files_runs_a_cell(name, files_only_layout, tmp_path):
    loaded = spec.load(name, root=_root_naming(tmp_path, files_only_layout))
    mod = importlib.import_module("layouts." + files_only_layout)
    assert loaded.layout is mod and "layout" not in loaded.config
    cell = small_cell(name)._replace(layout=loaded.layout)
    seconds = 5.0 if name.endswith("serve") else 0.5
    line = main.run_cell(cell, SEED, seconds, False, CPU, time.perf_counter(),
                         cache=str(tmp_path / "scenes"))
    assert line["correct"], line["checks"]
    assert mod.CALLS[:2] == ["write", "start_state"]
    assert mod.CALLS[-1] == "reference"
    assert ("start_meta" in mod.CALLS) == (name != "ftorf.serve")


def test_an_unknown_layout_stops_before_set_up(tmp_path):
    root = _root_naming(tmp_path, "no_such_layout")
    with pytest.raises(SystemExit) as e:
        spec.load("ftorf.serve", root=root)
    msg = str(e.value)
    assert '"layout"' in msg and "benchmark/configs/ftorf.json" in msg
    assert os.path.join(spec.LAYOUTS, "no_such_layout.py") in msg
    with pytest.raises(SystemExit, match='"layout"'):
        spec.layout("../harness/spec", "a.json")
