"""The port's Trainer (``gftorf_tpu_torch/train/loop.py``) on the CPU.

- The overflow state machine (grow-and-replay, the flat-stream fallback
  and its disengage, shrinking with hysteresis) with stubbed metrics: the
  cases of tests/test_flat_fallback.py and tests/test_shrink.py, run on
  the port's ``Occupancy`` (``train/occupancy.py``), alone or in a Trainer
  whose occupancy was built for a CUDA device.
- Grow-and-replay with real steps (the ``test_trainer_grows_and_replays``
  cases of tests/test_tile_overflow.py and tests/test_dup_overflow.py):
  a replayed run equals, bit for bit, a run that started with the grown
  capacity, and two runs of one config give bitwise-equal losses.
- Parity with the JAX Trainer: both Trainers on one 64x48 scene written by
  the JAX generator, the port's initial state (Gaussians and deform MLP)
  carried from the JAX Trainer by ``weights.py``, ``random_bg_color`` off
  (the two packages' generators differ), 8 iterations across the end of
  warm-up (3) into the dynamic phase, and from iteration 6
  (``densify_until_iter``) the frozen-Gaussian phase in which the deform
  MLP steps. No model event runs (densify starts after the run), because
  a densify threshold can flip on an fp32 rounding; the events are held
  with identical inputs in tests/test_torch_model.py. The camera picks
  (the global ``random``) are the same. Compared: every record's loss and
  l1_p at rtol 1e-4, its point and visible counts exactly, and the final
  state at the step parity's tolerances widened for 8 steps (see
  ``assert_states_close``).
- Checkpoints written by either package resume in the other, to an equal
  state and meta.
"""

import types

import jax
import numpy as np
import pytest
import torch

from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.data.generate import write_dataset
from gftorf_tpu.train.loop import Trainer as JTrainer
from gftorf_tpu_torch.config import Config, TpuParams
from gftorf_tpu_torch.train.loop import Trainer
from gftorf_tpu_torch.train.occupancy import Occupancy
from gftorf_tpu_torch.train.step import METRIC_NAMES
from gftorf_tpu_torch.utils.checkpoint import tree_leaves
from gftorf_tpu_torch.weights import training_state_from_numpy

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("scene") / "s")
    np.random.seed(3)
    write_dataset(src, num_frames=8, width=64, height=48)
    return src


def base_cfg(src, **over):
    d = dict(source_path=src, model_path="", total_num_views=8,
             tof_image_width=64, tof_image_height=48, color_image_width=64,
             color_image_height=48, depth_range=15.0, num_points=500,
             iterations=8, warm_up=100, use_quad=True, dynamic=True,
             dataset_type="quad", max_per_tile=128, max_per_tile_limit=256,
             shrink_window=2)
    d.update(over)
    return d


@pytest.fixture(scope="module")
def trainer_factory(scene_dir):
    def make(**over):
        return Trainer(Config.from_dict(base_cfg(scene_dir, **over)),
                       startup_artifacts=False, device="cpu")

    return make


def run(tr, n):
    outs = []
    for _ in range(n):
        outs += tr.step()
    return outs + tr.drain()


# ------------------------------------- tests/test_flat_fallback.py, stubbed


def _metrics(**over):
    m = {k: 0.0 for k in METRIC_NAMES}
    m.update(loss=0.1, l1_p=0.1, num_points=500.0, visible=400.0,
             num_rendered=1000.0, rendered_max=1000.0)
    m.update(over)
    return m


def _stub_pipeline(tr, tile_need):
    """Replace _dispatch with a stub whose metrics report a tile overflow
    exactly when the dispatched config is dense with max_per_tile below
    ``tile_need``."""

    def dispatch(it, idx, static):
        cfg = static.config_tof
        if cfg.flat_stream or cfg.max_per_tile >= tile_need:
            m = _metrics(tile_max=float(tile_need))
        else:
            m = _metrics(tile_overflow=float(tile_need - cfg.max_per_tile),
                         tile_max=float(tile_need))
        rec = {"it": it, "idx": idx, "static": static,
               "packed": np.array([m[k] for k in METRIC_NAMES], np.float32),
               "prev": (tr.model, tr.deform, tr.deform_adam)}
        tr._pending.append(rec)
        return rec

    tr._dispatch = dispatch


# A device with the flat kernels: the fallback's availability reads only
# its type, so the CPU tests build an Occupancy for it.
CUDA = torch.device("cuda")


def cuda_trainer(make, **over):
    """A CPU Trainer whose occupancy is the one it would have on CUDA."""
    tr = make(**over)
    tr.occupancy = Occupancy(tr.cfg.tpu, CUDA)
    return tr


def test_fallback_availability_follows_the_device(trainer_factory):
    # the CPU truncates like the JAX package on the CPU; CUDA has the
    # flat kernels (the counterpart of "a TPU with Pallas")
    tr = trainer_factory()
    assert not tr.occupancy.flat_fallback_ok
    assert Occupancy(tr.cfg.tpu, CUDA).flat_fallback_ok
    truncate = TpuParams(tile_overflow_fallback="truncate")
    assert not Occupancy(truncate, CUDA).flat_fallback_ok


def test_flat_engages_at_dense_ceiling(trainer_factory):
    tr = cuda_trainer(trainer_factory, max_per_tile=256, max_per_tile_limit=256)
    _stub_pipeline(tr, tile_need=4000)
    tr.iteration = 1
    tr._dispatch(1, 0, tr._static_for(1))
    out = tr._resolve_one()
    assert tr.occupancy.flat_stream and tr.occupancy.flat_auto
    assert out["tile_overflow"] == 0
    st = tr._static_for(2)
    assert st.config_tof.flat_stream and st.config_color.flat_stream


def engage_flat(occ):
    """Engage the automatic fallback as a render past the dense ceiling
    does."""
    assert occ.tile_cap == occ.tile_cap_limit
    assert occ.grow(_metrics(tile_overflow=1.0, tile_max=4000.0), 4096) == [
        f"flat_stream=True (deepest tile 4000 exceeds the dense ceiling "
        f"{occ.tile_cap_limit}; exact stream fallback)"]
    assert occ.flat_stream and occ.flat_auto


@pytest.mark.parametrize("need,engaged", [(100, False), (700, True)])
def test_flat_disengage_hysteresis(trainer_factory, need, engaged):
    """The scene thins (need 100): back to dense; need just under the
    ceiling (no 1.5x headroom): stays flat, no flapping."""
    tr = cuda_trainer(trainer_factory, max_per_tile=1280,
                      max_per_tile_limit=1280)
    engage_flat(tr.occupancy)
    _stub_pipeline(tr, tile_need=need)
    for it in (1, 2):
        tr.iteration = it
        tr._dispatch(it, 0, tr._static_for(it))
        tr._resolve_one()
    assert tr.occupancy.flat_stream == engaged
    if not engaged:
        assert not tr.occupancy.flat_auto
        assert tr.occupancy.tile_cap == 256  # 100*1.35 -> 135 -> 256
        assert not tr._static_for(3).config_tof.flat_stream


def test_truncate_optin_warns(trainer_factory, capsys):
    tr = cuda_trainer(trainer_factory, tile_overflow_fallback="truncate",
                      max_per_tile=256, max_per_tile_limit=256)
    assert not tr.occupancy.flat_fallback_ok
    _stub_pipeline(tr, tile_need=4000)
    tr.iteration = 1
    tr._dispatch(1, 0, tr._static_for(1))
    out = tr._resolve_one()
    assert not tr.occupancy.flat_stream and out["tile_overflow"] > 0
    assert "WARNING: tile overflow" in capsys.readouterr().out


def test_grow_below_ceiling(trainer_factory):
    tr = cuda_trainer(trainer_factory, max_per_tile=128,
                      max_per_tile_limit=1024)
    _stub_pipeline(tr, tile_need=300)
    tr.iteration = 1
    tr._dispatch(1, 0, tr._static_for(1))
    out = tr._resolve_one()
    assert not tr.occupancy.flat_stream and out["tile_overflow"] == 0
    assert tr.occupancy.tile_cap == 512  # 300*1.35 -> 405 -> 512


def test_checkpoint_roundtrips_flat_state(trainer_factory, tmp_path):
    tr = cuda_trainer(trainer_factory, max_per_tile=256,
                      max_per_tile_limit=256)
    engage_flat(tr.occupancy)
    tr.iteration = 7
    path = str(tmp_path / "ck.npz")
    tr.save_checkpoint(path)
    tr2 = cuda_trainer(trainer_factory)
    tr2.load_checkpoint(path)
    assert tr2.occupancy.flat_stream and tr2.occupancy.flat_auto
    assert tr2.iteration == 7
    tr3 = trainer_factory(tile_overflow_fallback="truncate")
    tr3.load_checkpoint(path)
    assert not tr3.occupancy.flat_stream


# ------------------------------------------ tests/test_shrink.py, stubbed


def make_occupancy(tile_cap=2048, dup_factor=24, window=4, flat_stream=False):
    return Occupancy(TpuParams(
        max_per_tile=tile_cap, max_per_tile_limit=max(tile_cap, 16384),
        max_per_tile_floor=256, dup_factor=dup_factor, dup_factor_floor=2,
        shrink_window=window, flat_stream=flat_stream), torch.device("cpu"))


def trainer_rows(render_bucket, capacity):
    """``Trainer.render_rows`` of a Trainer at this bucket and capacity:
    the rows it hands the occupancy."""
    alive = torch.zeros((capacity,), dtype=torch.bool)
    return Trainer.render_rows.fget(types.SimpleNamespace(
        render_bucket=render_bucket,
        model=types.SimpleNamespace(aux=types.SimpleNamespace(alive=alive))))


def feed(occ, tile_max, rendered_max, n, rows):
    for _ in range(n):
        occ.note(1, {"tile_max": float(tile_max),
                     "rendered_max": float(rendered_max)}, rows)


@pytest.mark.parametrize("kw,feeds,want", [
    # 300*1.35 -> 512 lanes; 8000*1.35/4096 -> factor 3; window reset
    (dict(), [(300, 8000, 4)], (512, 3)),
    # inside the 1.5x gap: hold
    (dict(tile_cap=1024, dup_factor=12), [(700, 26000, 4)], (1024, 12)),
    # floors
    (dict(tile_cap=1024, dup_factor=12, capacity=65536), [(1, 1, 4)], (256, 2)),
    # the window's max, not its last value
    (dict(dup_factor=12), [(1900, 100, 1), (10, 100, 3)], (2048, 2)),
    # render-bucket rows, not capacity rows
    (dict(render_bucket=1024, capacity=65536), [(2000, 4000, 4)], (2048, 6)),
    # disabled window
    (dict(window=0), [(1, 1, 10)], (2048, 24)),
    # flat stream: no tile-depth capacity to shrink, dup_factor still shrinks
    (dict(flat_stream=True), [(300, 8000, 4)], (2048, 3)),
])
def test_shrink(kw, feeds, want):
    kw = dict(kw)
    bucket, capacity = kw.pop("render_bucket", 0), kw.pop("capacity", 4096)
    occ = make_occupancy(**kw)
    rows = trainer_rows(bucket, capacity)
    for tile_max, rendered_max, n in feeds:
        feed(occ, tile_max, rendered_max, n, rows)
    assert (occ.tile_cap, occ.dup_factor) == want
    if kw.get("window", 4) and not kw.get("flat_stream"):
        assert occ._steps == 0


def test_growth_sizes_to_need():
    occ = make_occupancy(tile_cap=1024, dup_factor=4)
    grew = occ.grow(_metrics(tile_overflow=1.0, tile_max=1243.0,
                             dup_overflow=1.0, rendered_max=float(324046 // 8)), 4096)
    assert occ.tile_cap == 1792  # 1243*1.35 -> 1679 -> 1792
    assert occ.dup_factor == 14  # ceil(1.35*40505/4096)
    assert grew == ["max_per_tile=1792 (dropped 1 instances)", "dup_factor=14"]


# ------------------------------------------- grow-and-replay, real steps


@pytest.mark.parametrize("over,grown", [
    (dict(max_per_tile=128, max_per_tile_limit=4096), "tile_cap"),
    (dict(dup_factor=1, dup_factor_limit=96, max_per_tile=1024,
          max_per_tile_limit=16384), "dup_factor"),
])
def test_trainer_grows_and_replays(trainer_factory, tmp_path, over, grown):
    """A step that overflows rolls back, grows the capacity and replays the
    same (it, idx, seed): one record per iteration, no overflow left, and
    the losses equal (bitwise) a run that started with the grown capacity;
    the grown capacity survives a checkpoint."""
    kw = dict(num_points=3000, iterations=6, shrink_window=0, **over)
    tr = trainer_factory(**kw)
    start = getattr(tr.occupancy, grown)
    outs = run(tr, 6)
    assert [o["iteration"] for o in outs] == list(range(1, 7))
    assert all(np.isfinite(o["loss"]) for o in outs)
    assert getattr(tr.occupancy, grown) > start
    assert all(o["tile_overflow"] == 0 and not o["dup_overflow"] for o in outs)
    cap_key = "max_per_tile" if grown == "tile_cap" else "dup_factor"
    tr2 = trainer_factory(**dict(kw, **{cap_key: getattr(tr.occupancy, grown)}))
    outs2 = run(tr2, 6)
    assert [o["loss"] for o in outs2] == [o["loss"] for o in outs]
    ck = str(tmp_path / "ck.npz")
    tr.save_checkpoint(ck)
    tr3 = trainer_factory(**kw)
    tr3.load_checkpoint(ck)
    assert getattr(tr3.occupancy, grown) == getattr(tr.occupancy, grown)


def test_runs_are_bitwise_repeatable_with_random_bg(trainer_factory):
    kw = dict(random_bg_color=True, iterations=4, warm_up=2, max_per_tile=1024)
    a = [o["loss"] for o in run(trainer_factory(**kw), 4)]
    b = [o["loss"] for o in run(trainer_factory(**kw), 4)]
    assert a == b and all(np.isfinite(a))


# --------------------------------------------------- parity with JAX


def parity_cfg(src):
    return base_cfg(src, iterations=8, warm_up=3, densify_until_iter=6,
                    densify_from_iter=100, lambda_flow=0.0, max_per_tile=512,
                    max_per_tile_limit=4096, random_bg_color=False,
                    num_points=600)


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def port_state_from_jax(tr_j, deform_cfg):
    m = tr_j.model
    as_np = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}  # noqa: E731
    d = tr_j.deform
    dl = lambda p: (list(p.hidden_w), list(p.hidden_b), dict(p.head_w),  # noqa: E731
                    dict(p.head_b))
    return training_state_from_numpy(
        as_np(m.params), as_np(m.aux),
        (as_np(m.adam.mu), as_np(m.adam.nu), int(m.adam.step)),
        dl(d), (dl(tr_j.deform_adam.mu), dl(tr_j.deform_adam.nu),
                int(tr_j.deform_adam.step)),
        tr_j.iteration, deform_cfg, device="cpu")


# The deform MLP steps at iterations 6-8 (densify_until_iter = 6): Adam
# moves an element by about its lr per step whatever the gradient's size,
# so where the gradient is near zero in both packages the sign of fp32
# noise decides the step, and the weights agree only to 2 * lr per step.
DEFORM_STEPS, DEFORM_LR = 3, 8e-4
STATE_RTOL, STATE_ATOL_FRAC = 1e-3, 5e-3


def assert_states_close(tr_t, tr_j, exact=False):
    """The port's Trainer state against the JAX Trainer's, leaf by leaf in
    the checkpoint order: equal when ``exact`` (a resumed state). Else
    bools and ints equal, the deform MLP's weights within 2 * lr per
    deform step, and the Gaussians and every Adam moment at rtol 1e-3 plus
    5e-3 of the leaf's largest magnitude (the step parity's atol-of-max
    form, tests/torch_port_util.py, widened for 8 steps)."""
    port = tr_t._checkpoint_tree()
    ref = {"model": tr_j.model, "deform": tr_j.deform,
           "deform_adam": tr_j.deform_adam}
    for group in ("deform", "deform_adam", "model"):
        t = [np.asarray(x) for x in tree_leaves(port[group])]
        j = jax_leaves(ref[group])
        assert len(t) == len(j), group
        for i, (a, b) in enumerate(zip(t, j)):
            where = f"{group} leaf {i}"
            assert a.shape == b.shape and a.dtype == b.dtype, where
            if exact or b.dtype != np.float32:
                np.testing.assert_array_equal(a, b, err_msg=where)
            elif group == "deform":
                np.testing.assert_allclose(a, b, rtol=0, err_msg=where,
                                           atol=2 * DEFORM_STEPS * DEFORM_LR)
            else:
                scale = float(np.abs(b).max()) if b.size else 0.0
                np.testing.assert_allclose(a, b, rtol=STATE_RTOL, err_msg=where,
                                           atol=STATE_ATOL_FRAC * scale)


@pytest.fixture(scope="module")
def parity(scene_dir):
    cfg = parity_cfg(scene_dir)
    tr_j = JTrainer(JConfig.from_dict(cfg), startup_artifacts=False)
    tr_t = Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")
    st = port_state_from_jax(tr_j, tr_t.deform_cfg)
    tr_t.model, tr_t.deform, tr_t.deform_adam = st.model, st.deform, st.deform_adam
    tr_t._update_deform_bucket()
    assert (tr_t.render_bucket, tr_t.deform_bucket) == (tr_j.render_bucket,
                                                         tr_j.deform_bucket)
    # The JAX run draws its camera picks first; the port's Trainer seeded
    # random the same way at init, so reseed it for the port's run.
    import random

    outs_j = run(tr_j, 8)
    random.seed(cfg.get("seed", 0))
    outs_t = run(tr_t, 8)
    return tr_j, tr_t, outs_j, outs_t, cfg


def test_trainer_records_match_jax(parity):
    _, _, outs_j, outs_t, _ = parity
    assert [o["iteration"] for o in outs_t] == list(range(1, 9))
    for a, b in zip(outs_t, outs_j):
        assert (a["iteration"], a["idx"], a["num_points"], a["tile_overflow"],
                a["dup_overflow"]) == (b["iteration"], b["idx"], b["num_points"],
                                       b["tile_overflow"], b["dup_overflow"])
        assert abs(a["visible"] - b["visible"]) <= 1, (a, b)
        for k in ("loss", "l1_p", "ema_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, err_msg=k)


def test_trainer_state_matches_jax(parity):
    tr_j, tr_t, _, _, _ = parity
    assert tr_t.iteration == tr_j.iteration == 8
    assert_states_close(tr_t, tr_j)


def test_checkpoints_resume_across_packages(parity, tmp_path):
    tr_j, tr_t, _, _, cfg = parity
    meta_keys = ("iteration", "active_sh_degree", "lambda_color",
                 "opacity_reset_interval")
    occ_keys = ("tile_cap", "dup_factor", "flat_stream", "flat_auto")

    def jax_meta(tr):
        return ([getattr(tr, k) for k in meta_keys]
                + [tr.tile_cap, tr.dup_factor, tr.flat_stream, tr._flat_auto])

    def port_meta(tr):
        return ([getattr(tr, k) for k in meta_keys]
                + [getattr(tr.occupancy, k) for k in occ_keys])

    # JAX -> port
    pj = str(tmp_path / "jax.npz")
    tr_j.save_checkpoint(pj)
    into_t = Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")
    into_t.load_checkpoint(pj)
    assert_states_close(into_t, tr_j, exact=True)
    assert port_meta(into_t) == jax_meta(tr_j)
    # port -> JAX
    pt = str(tmp_path / "port.npz")
    tr_t.save_checkpoint(pt)
    into_j = JTrainer(JConfig.from_dict(cfg), startup_artifacts=False)
    into_j.load_checkpoint(pt)
    assert_states_close(tr_t, into_j, exact=True)
    assert jax_meta(into_j) == port_meta(tr_t)
    # and the port resumes its own checkpoint to an equal state
    again = Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")
    again.load_checkpoint(pt)
    for a, b in zip(tree_leaves(again._checkpoint_tree()),
                    tree_leaves(tr_t._checkpoint_tree())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
