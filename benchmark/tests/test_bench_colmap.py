"""The ``colmap`` layout's cell, ``garden.train.densify``, at a toy size on
the CPU: 8 views at 96x64 and 4,000 Gaussians. A whole run is ``correct``
for the program as it is and not with every update 5 % longer."""

import importlib
import time
import types

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from harness import faults, main, spec
from layouts import colmap
from reference import colmap_driver
from reference.lower import tf32_matmuls

SEED = 2**31 + 41
CPU = torch.device("cpu")
SCENE = dict(views=8, width=96, height=64, focal=1160.0 * 96 / 1297,
             images="images_4", points=500)


def toy_cell():
    cell = spec.load("garden.train.densify")
    tr = dict(cell.traffic, start_iteration=7095, warm_up_iterations=8,
              trace_iterations=4, checked_within=1)
    # The start occupancy at the toy's size (the card's tile ceiling would
    # make the CPU's dense tiles 16,384 deep).
    occupancy = dict(cell.config["start_occupancy"], tile_cap=4096,
                     dup_factor=11)
    return cell._replace(config=dict(cell.config, num_points=4000, D=2, W=32,
                                     start_occupancy=occupancy),
                         scene=SCENE, traffic=tr)


def _run(cache):
    # One thread, as the benchmark runs: the other files' timed windows
    # share the machine with this one.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return main.run_cell(toy_cell(), SEED, 0.5, False, CPU,
                             time.perf_counter(), cache=cache)
    finally:
        torch.set_num_threads(threads)


def test_toy_garden_run_is_correct(scene_cache):
    line = _run(scene_cache)
    assert line["correct"], line["checks"]
    assert line["checks"]["densify_missing"]["value"] == 0
    assert line["attempted"] > 0 and line["failed"] == 0


def test_toy_garden_with_a_longer_update_is_not_correct(scene_cache,
                                                        monkeypatch):
    faults.altered_update(monkeypatch.setattr)
    assert not _run(scene_cache)["correct"]


def test_the_cell_takes_the_colmap_layout():
    assert spec.load("garden.train.densify").layout is \
        importlib.import_module("layouts.colmap")


def test_start_meta_carries_the_start_occupancy():
    cfg = spec.load("garden.train.densify").config
    meta = colmap.start_meta(cfg, 7000)
    assert {k: meta[k] for k in cfg["start_occupancy"]} == \
        cfg["start_occupancy"]
    assert set(cfg["start_occupancy"]) == {"tile_cap", "dup_factor",
                                           "flat_stream", "flat_auto"}


def test_the_control_takes_the_cards_tf32_on_a_card():
    """Under the control's mode, a card's steps run the card's TF32
    products with the mode set aside; the CPU keeps the mode; with no
    mode, TF32 stays off."""
    card = types.SimpleNamespace(type="cuda")
    matmul = torch.backends.cuda.matmul
    with tf32_matmuls():
        with colmap_driver._products(card):
            assert _get_current_dispatch_mode() is None and matmul.allow_tf32
        assert not matmul.allow_tf32
        with colmap_driver._products(CPU):
            assert isinstance(_get_current_dispatch_mode(), tf32_matmuls)
    with colmap_driver._products(card):
        assert not matmul.allow_tf32
