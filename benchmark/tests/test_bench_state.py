"""The start-state maker and the files through which the program takes
the state."""

import math
import os

import numpy as np
import pytest
import torch

from conftest import small_cell
from harness import state, train


def _state(seed, cell=None):
    cell = cell or small_cell("ftorf.train.densify")
    cfg = dict(cell.config)
    return state.make_start_state(cfg, train.start_bounds(cfg, cell.scene),
                                  seed, 1024, 3000, torch.device("cpu"))


def test_same_seed_same_state_and_other_seed_other_state():
    a, b, c = _state(2**31 + 5), _state(2**31 + 5), _state(2**31 + 6)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    for k in a.deform:
        assert torch.equal(a.deform[k], b.deform[k])
    assert not torch.equal(a.params["xyz"], c.params["xyz"])


def test_layout_of_the_random_init():
    cell = small_cell("ftorf.train.densify")
    s = _state(7, cell)
    lo, hi = train.start_bounds(cell.config, cell.scene)
    xyz = s.params["xyz"][:s.n].numpy()
    assert s.n == 600 and int(s.aux["alive"].sum()) == 600
    assert (xyz >= lo - 1e-5).all() and (xyz <= hi + 1e-5).all()
    assert not s.params["xyz"][s.n:].any()
    opac = torch.sigmoid(s.params["opacity"][:s.n])
    assert torch.allclose(opac, torch.full_like(opac, 0.1))
    assert (s.params["seg_color"][:s.n, 0] == 1).all()
    assert torch.allclose(s.params["sh_color"][:s.n, 0, 0],
                          torch.tensor(0.5 / state.SH_C0))


def test_nearest_neighbour_distances():
    xyz = torch.tensor([[0.0, 0, 0], [1, 0, 0], [3, 0, 0], [6, 0, 0]])
    got = state.mean_knn_sq_dist(xyz, k=3, block=3)
    want = torch.tensor([(1 + 9 + 36) / 3, (1 + 4 + 25) / 3,
                         (9 + 4 + 9) / 3, (36 + 25 + 9) / 3])
    assert torch.allclose(got, want)


def test_frustum_bounds_of_the_reader_formula():
    lo, hi = state.frustum_bounds(90.0, 90.0, 100, 50, 1.0, 10.0)
    fov_x = 2 * math.atan(100 / 180)
    hfar = 2 * math.tan(fov_x / 2) * 10.0
    assert hi[2] == pytest.approx(10.0) and lo[2] == pytest.approx(1.0)
    assert hi[0] == pytest.approx(hfar * 2 / 2)
    assert hi[1] == pytest.approx(hfar / 2)


def test_checkpoint_loads_into_the_program(tmp_path, scene_cache):
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.train.loop import Trainer

    cell = small_cell("ftorf.train.densify")
    cfg, ckpt, kept, _ = train.start_checkpoint(cell, 11, torch.device("cpu"),
                                             str(tmp_path), scene_cache)
    s = state.make_start_state(cfg, train.start_bounds(cfg, cell.scene), 11,
                               1024, 3095, torch.device("cpu"))
    for k, v in kept.params.items():
        assert torch.equal(v, s.params[k]), k
    t = Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")
    t.load_checkpoint(ckpt)
    assert t.iteration == 3095 and t.active_sh_degree == 3
    for k, v in t.model.params._asdict().items():
        assert torch.equal(v, s.params[k]), k
    for k, v in t.deform.items():
        assert torch.equal(v, s.deform[k]), k
    assert int(t.model.adam.step) == 3095 and int(t.deform_adam.step) == 3095


def test_torf_start_meta_is_past_tof_iters():
    cell = small_cell("torf.train.densify")
    meta = train.start_meta(cell.config, 3000)
    assert meta == {"iteration": 3000, "active_sh_degree": 3,
                    "lambda_color": 1.0, "opacity_reset_interval": 1500}


def test_artifacts_load_as_a_trained_model(tmp_path, scene_cache):
    from gftorf_tpu_torch import render_sets
    from harness import serve

    cell = small_cell("ftorf.serve")
    model_dir = str(tmp_path / "model")
    cfg, s, _ = serve.served_state(cell, 3, torch.device("cpu"), model_dir,
                                scene_cache)
    state.write_artifacts(model_dir, s, cfg, 30000, cfg["D"])
    t, _, it = render_sets.load_trained(model_dir, device="cpu")
    assert it == 30000
    for k, v in t.model.params._asdict().items():
        assert torch.equal(v, s.params[k][:s.n] if v.shape[0] == s.n
                           else s.params[k]), k
    for k, v in t.deform.items():
        assert torch.equal(v, s.deform[k]), k
    assert os.path.isfile(os.path.join(model_dir, "cfg_args_full.json"))
    assert np.load(os.path.join(model_dir, "point_cloud", "iteration_30000",
                                "dc_offset.npy")).shape == (1,)
