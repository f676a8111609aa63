"""The port's Trainer against the JAX Trainer across densify and reset events
(29-35 s on an 8-core Intel Xeon CPU in one process by pytest's count,
35-41 s with the interpreter's start; the JAX Trainer's compiles take 20 s
of it).

Both Trainers run the ftorf scene of tests/test_torch_trainer.py (8 frames
at 64x48 written after ``np.random.seed(3)``, here by the port's writer,
which takes 1 s where the JAX package's takes 8) from the JAX Trainer's
initial state, carried to the port as
``test_torch_trainer.port_state_from_jax`` carries it, for 10 iterations:

- densify after iterations 2, 4, 6 and 8 (``densify_from_iter`` 1, every
  2); the first overfills the capacity of 600 rows, so ``_densify`` grows
  it to 1,024 and runs again (grow-and-replay inside the event);
- the opacity reset at 5, after which densify prunes by world size too
  (``size_thr`` 10 from iteration 6, loop.py:639);
- the freeze at 9 (``densify_until_iter``): iterations 9 and 10 run with
  the Gaussians frozen.

The initial log-scales are spread (three times their spread about their
median, centred on ``percent_dense * extent``, each axis offset) so that
clones, splits and both world-size prunes have candidates and the
rotations a gradient, and ``densify_grad_threshold`` is 1e-5, so that
about a tenth of the seen rows is densified. The scene is static
(``dynamic`` off): the JAX Trainer compiles its step for each structural
variant (three here), and a run with the deform MLP did not fit the time;
nor did a torf case.

The draws are the same in both runs: random backgrounds off, the camera
picks from Python's ``random`` reseeded before the port's run, and the
split noise of each densify try, ``jax.random.normal(fold_in(key,
1_000_000 + it), (2, C, 3))`` at that try's capacity C, handed to the
port's ``densify_and_prune`` in place of its generator.

Compared (each densify try recorded by the wrappers of
chip_parity20k.py and tools/parity_events_jax.py):

1. each iteration's record: ``idx``, ``num_points``, ``tile_overflow``,
   ``dup_overflow`` equal, the loss at rtol 1e-4;
2. the statistics each try reads: ``denom`` and ``max_radii2d`` equal,
   except at no more than ``CUTOFF_PIXELS`` (pixel, Gaussian) pairs whose
   alpha lies within rounding of the 1/255 cutoff; ``xyz_grad_accum``
   within the state tolerance of test_torch_trainer.py, and on every row
   whose ``denom`` agrees within ``STATE_RTOL`` of itself plus of the
   threshold's accumulator (``accum_band``);
3. each try's clone, split and prune masks and the capacity after
   growth equal. Beside each decision the test measures each candidate's
   margin to its threshold in the units of the input it reads, and
   asserts that it exceeds the band that the tolerances of 2 (and
   ``PARAM_ATOL`` for the raw opacity and log-scale, themselves asserted
   within it) allow. A candidate whose inputs are bitwise equal in both
   packages has no band: the reset leaves every row that gets no gradient
   at exactly ``inverse_sigmoid(0.01)``, whose sigmoid rounds below
   ``min_opacity`` 0.01 in both packages;
4. the final state, through ``test_torch_trainer.assert_states_close``.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.train import loop as jloop
from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.generate import write_dataset
from gftorf_tpu_torch.train import loop
from test_torch_trainer import (
    LOSS_RTOL,
    STATE_ATOL_FRAC,
    STATE_RTOL,
    assert_states_close,
    base_cfg,
    port_state_from_jax,
    run,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_parity20k as cp  # noqa: E402
import parity_events_jax as pj  # noqa: E402

ITERS = 10
EVENTS = dict(densify_from_iter=1, densification_interval=2,
              opacity_reset_interval=5, densify_until_iter=9)
GRAD_THRESHOLD = 1e-5
SCALE_SPREAD = 3.0
# Per-axis log-scale offsets: KNN's initial Gaussians are isotropic, and
# the rotation gradient of an isotropic Gaussian is zero but for rounding.
AXIS_LOG_OFFSETS = np.array([-0.8, -0.4, 0.0], np.float32)
CAPACITY = 600
# (iteration, capacity) of every densify try: the first overfills 600 rows.
TRIES = [(2, 600), (2, 1024), (4, 1024), (6, 1024), (8, 1024)]
# Raw opacity (a logit) and largest log-scale: the packages' largest
# difference at a try was 4.8e-07 here.
PARAM_ATOL = 1e-3
# (pixel, Gaussian) pairs at the 1/255 alpha cutoff allowed per try: none
# occurred here; a fault that adds a pixel to each Gaussian that touches
# more than 50 in a step adds 8, 8, 6, 1 and 0 to the five tries.
CUTOFF_PIXELS = 3


def events_cfg(src):
    return base_cfg(src, iterations=ITERS, dynamic=False, warm_up=ITERS,
                    lambda_flow=0.0, max_per_tile=512, max_per_tile_limit=4096,
                    random_bg_color=False, num_points=600, capacity=CAPACITY,
                    shrink_window=0, densify_grad_threshold=GRAD_THRESHOLD,
                    **EVENTS)


def spread_scales(tr_j):
    """The JAX Trainer's live log-scales spread SCALE_SPREAD times about
    their median, centred on the clone/split threshold."""
    import jax.numpy as jnp

    p, alive = tr_j.model.params, np.asarray(tr_j.model.aux.alive)
    sc = np.asarray(p.scaling)
    mid = np.median(sc[alive].max(axis=-1))
    thr = np.log(tr_j.opt.percent_dense * tr_j.scene.scene_extent)
    new = np.where(alive[:, None],
                   thr + SCALE_SPREAD * (sc - mid) + AXIS_LOG_OFFSETS, sc)
    tr_j.model = tr_j.model._replace(
        params=p._replace(scaling=jnp.asarray(new.astype(np.float32))))


class counted:
    """Count the calls of ``owner.name`` (the Trainers' opacity resets)."""

    def __init__(self, owner, name):
        self.owner, self.name, self.its = owner, name, []

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)

        def wrapped(tr, *a):
            self.its.append(tr.iteration)
            return real(tr, *a)

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("scene") / "s")
    np.random.seed(3)
    write_dataset(src, num_frames=8, width=64, height=48, device="cpu")
    cfg = events_cfg(src)
    tr_j = jloop.Trainer(JConfig.from_dict(cfg), startup_artifacts=False)
    spread_scales(tr_j)
    tr_t = loop.Trainer(Config.from_dict(cfg), startup_artifacts=False,
                        device="cpu")
    st = port_state_from_jax(tr_j, tr_t.deform_cfg)
    tr_t.model, tr_t.deform, tr_t.deform_adam = st.model, st.deform, st.deform_adam
    tr_t._update_deform_bucket()

    with pj.record_jax_events(tr_j) as ev_j, \
            counted(jloop.Trainer, "_reset_opacity") as resets_j:
        outs_j = run(tr_j, ITERS)

    def noise(it, cap):
        return torch.as_tensor(np.asarray(pj.split_draw(cfg.get("seed", 0), it, cap)))

    random.seed(cfg.get("seed", 0))
    with cp.record_events(tr_t, noise) as ev_t, \
            counted(loop.Trainer, "_reset_opacity") as resets_t:
        outs_t = run(tr_t, ITERS)
    return dict(tr_j=tr_j, tr_t=tr_t, outs_j=outs_j, outs_t=outs_t, ev_j=ev_j,
                ev_t=ev_t, resets=(resets_t.its, resets_j.its),
                extent=float(tr_j.scene.scene_extent), opt=tr_j.opt)


def test_event_schedule(events):
    """Every event of the run happened in both Trainers, in order: the
    grow inside the first densify, the reset, the size switch, the freeze."""
    for ev in (events["ev_t"], events["ev_j"]):
        assert [(e["it"], e["capacity"]) for e in ev] == TRIES
        assert [e["size_thr"] for e in ev] == [0.0] * 3 + [10.0] * 2
        assert ev[0]["dropped"] > 0 and all(e["dropped"] == 0 for e in ev[1:])
    assert events["resets"] == ([5], [5])
    for tr in (events["tr_t"], events["tr_j"]):
        assert tr.iteration == ITERS and tr.model.aux.alive.shape[0] == 1024


def test_event_records_match_jax(events):
    outs_t, outs_j = events["outs_t"], events["outs_j"]
    assert [o["iteration"] for o in outs_t] == list(range(1, ITERS + 1))
    for a, b in zip(outs_t, outs_j):
        keys = ("iteration", "idx", "num_points", "tile_overflow", "dup_overflow")
        assert [a[k] for k in keys] == [b[k] for k in keys], (a, b)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
    # the events moved the count: grown, split, pruned after the reset
    pts = [o["num_points"] for o in outs_j]
    assert len(set(pts)) >= 4, pts


def _tries(events):
    for i, (t, j) in enumerate(zip(events["ev_t"], events["ev_j"])):
        yield f"try {i} (iteration {t['it']}, capacity {t['capacity']})", t, j


def test_statistics_before_each_event(events):
    """denom and max_radii2d exact but for pixels at the alpha cutoff;
    xyz_grad_accum at the state tolerance, and per row where denom agrees."""
    for where, t, j in _tries(events):
        np.testing.assert_array_equal(t["alive"], j["alive"], err_msg=where)
        np.testing.assert_array_equal(t["max_radii2d"], j["max_radii2d"],
                                      err_msg=where)
        cutoff = int(np.abs(t["denom"] - j["denom"]).sum())
        assert cutoff <= CUTOFF_PIXELS, (where, cutoff)
        a, b = t["xyz_grad_accum"], j["xyz_grad_accum"]
        np.testing.assert_allclose(a, b, rtol=STATE_RTOL, err_msg=where,
                                   atol=STATE_ATOL_FRAC * float(np.abs(b).max()))
        same = t["denom"] == j["denom"]
        row = accum_band(b, j["denom"], GRAD_THRESHOLD)
        assert (np.abs(a - b) <= row)[same].all(), (
            where, np.abs(a - b)[same].max(), row[same].min())
        for k in ("opacity", "max_scaling"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{where}: {k}")


def accum_band(accum, denom, thr):
    """What a row's ``xyz_grad_accum`` may differ by: STATE_RTOL of itself
    and of the threshold's accumulator (``thr * denom``), so that the mean
    gradient ``accum / denom`` is held to STATE_RTOL of itself plus of the
    threshold."""
    return STATE_RTOL * (np.abs(accum) + thr * denom)


def margins(t, j, thr, extent, opt):
    """Each rule's candidates: (name, margin, band, inputs bitwise equal),
    margins in the units of the input the rule reads (JAX's values)."""
    alive = j["alive"]
    a, d = j["xyz_grad_accum"], j["denom"]
    dd = np.abs(t["denom"] - d)
    seen = alive & (d > 0)
    band = accum_band(a, d, thr) + thr * dd
    out = [("grad", np.abs(a - thr * d)[seen], band[seen],
            ((t["xyz_grad_accum"] == a) & (dd == 0))[seen])]
    f32 = np.float32
    raw = {"opacity": (j["opacity"], t["opacity"]),
           "max_scaling": (j["max_scaling"], t["max_scaling"])}
    high = j["clone"] | j["split"]
    rules = [("clone/split", "max_scaling",
              np.log(f32(opt.percent_dense) * f32(extent)), high),
             ("opacity", "opacity", np.log(f32(opt.min_opacity)
                                           / (1 - f32(opt.min_opacity))), alive)]
    if t["size_thr"] > 0:
        rules += [("size>0.05", "max_scaling", np.log(f32(0.05) * f32(extent)), alive),
                  ("size<0.001", "max_scaling", np.log(f32(0.001) * f32(extent)),
                   alive)]
    for name, key, at, rows in rules:
        x, y = raw[key]
        out.append((name, np.abs(x - at)[rows], np.full(rows.sum(), PARAM_ATOL),
                    (x == y)[rows]))
    return out


def test_decisions_match_jax_outside_the_band(events):
    """Each try's masks and dropped count equal JAX's, and no candidate of
    any rule lies inside the band its inputs' tolerance allows."""
    opt, extent = events["opt"], events["extent"]
    report = []
    for where, t, j in _tries(events):
        for k in ("clone", "split", "prune"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{where}: {k}")
        assert (t["dropped"], t["alive_after"]) == (j["dropped"], j["alive_after"])
        for name, margin, band, equal in margins(t, j, opt.densify_grad_threshold,
                                                 extent, opt):
            inside = (margin <= band) & ~equal
            report.append((where, name, margin.size, int(equal.sum()),
                           float((margin / band)[~equal].min())
                           if (~equal).any() else None))
            assert not inside.any(), (where, name, margin[inside], band[inside])
    # every rule had candidates decided on differing inputs somewhere
    assert {r[1] for r in report if r[4] is not None} >= {
        "grad", "clone/split", "opacity", "size>0.05", "size<0.001"}, report


def test_decisions_cover_every_rule(events):
    """The run clones, splits and prunes by opacity and by world size."""
    ev = events["ev_j"]
    assert sum(int(e["clone"].sum()) for e in ev) > 0
    assert sum(int(e["split"].sum()) for e in ev) > 0
    pruned = [int((e["prune"] & ~e["split"]).sum()) for e in ev]
    assert pruned[-2] > 0, pruned  # after the reset


def test_event_state_matches_jax(events):
    assert_states_close(events["tr_t"], events["tr_j"])
