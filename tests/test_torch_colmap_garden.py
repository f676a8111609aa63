"""The port's COLMAP colour path at a toy size on the CPU, against the
benchmark's ``colmap`` layout and its plain reference (``benchmark/``).

A scene of 8 views at 96x64 written by ``layouts/colmap.py::write`` reads
back alike through the port's ``read_colmap_scene`` and the reference's
``reference/colmap_scene.py``. A toy ``garden`` config (4,000 Gaussians,
SH 3, seeded random weights from the layout's start state) takes one
``train_step``, dense and with the flat stream forced on, against
``reference/colmap_driver.py`` on the same state, black background and
camera: the loss, every leaf's gradient and the Adam step within the
float32 tolerances below. A profiled flat step emits ``composite.flat``
(``flat.backward`` opens on a CUDA tensor only: the card's traced run reads
it), and the Trainer's records carry the occupancy counters. About 15 s.
"""

import os
import statistics
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
sys.path.insert(0, BENCH)

from harness import checks, spec, train  # noqa: E402
from layouts import colmap  # noqa: E402
from reference import colmap_driver, colmap_scene  # noqa: E402

from gftorf_tpu_torch.config import Config  # noqa: E402
from gftorf_tpu_torch.data.readers import read_colmap_scene  # noqa: E402
from gftorf_tpu_torch.train.loop import Trainer  # noqa: E402
from gftorf_tpu_torch.train.step import train_step  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 57
SCENE = dict(views=8, width=96, height=64, focal=1160.0 * 96 / 1297,
             images="images_4", points=500)
IT = 7001
# float32 tolerances, each over the larger of the leaf's reference norm and
# the median leaf's (``checks.leaf_gaps``): the loss's relative gap, the
# gradient's and the Adam step's norm.
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-3
OCCUPANCY = dict(tile_cap=4096, dup_factor=11)


@pytest.fixture(scope="module")
def cell():
    c = spec.load("garden.train.densify")
    # The card's start occupancy at the toy's size: the checkpoint's tile
    # ceiling and dup_factor, where the config's are 1024 and 12.
    occupancy = dict(c.config["start_occupancy"], **OCCUPANCY)
    return c._replace(config=dict(c.config, num_points=4000, D=2, W=32,
                                  start_occupancy=occupancy),
                      scene=SCENE)


@pytest.fixture(scope="module")
def setup(cell, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("garden"))
    cfg, ckpt, _, _ = train.start_checkpoint(cell, SEED, CPU, tmp,
                                             cache=os.path.join(tmp, "cache"))
    tr = Trainer(Config.from_dict(cfg), startup_artifacts=False, device=CPU)
    tr.load_checkpoint(ckpt)
    sc = colmap_driver.read_scene(cfg["source_path"], cfg, CPU)
    return cfg, tr, sc


def test_scene_reads_back_alike(setup):
    cfg, tr, sc = setup
    src = cfg["source_path"]
    data = read_colmap_scene(src, Config.from_dict(cfg).model, True)
    assert len(data.train_cameras) == len(sc.frames) == 7
    assert data.scene_extent == pytest.approx(sc.extent, rel=1e-12)
    for cam, frame in zip(data.train_cameras, sc.frames):
        assert np.array_equal(np.moveaxis(cam.image, -1, 0),
                              frame.image.numpy())
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = cam.R.T, cam.T
        assert np.abs(w2c - frame.color.view.numpy()).max() < 1e-6
        c = frame.color
        assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height) == (
            pytest.approx(c.fx, rel=1e-12), pytest.approx(c.fy, rel=1e-12),
            c.cx, c.cy, c.width, c.height)
    written = colmap.sample_surfaces(
        SCENE["points"], torch.Generator().manual_seed(colmap.SCENE_SEED),
        CPU)[1]
    assert np.abs(data.points - written.numpy()).max() < 1e-6
    png = os.path.join(src, "images_4", "frame_00001.png")
    assert np.array_equal(colmap_scene.read_png(png),
                          (sc.frames[0].image.numpy().transpose(1, 2, 0)
                           * 255.0).round().astype(np.uint8))


def test_resume_takes_the_start_occupancy(setup):
    """The start checkpoint carries the occupancy that the Trainer saves and
    resumes: the tile ceiling and dup_factor; the flat stream stays off on
    the CPU, which has no flat fallback."""
    _, tr, _ = setup
    occ = tr.occupancy
    assert (occ.tile_cap, occ.dup_factor) == (OCCUPANCY["tile_cap"],
                                              OCCUPANCY["dup_factor"])
    assert occ.flat_stream is False


def _step(cfg, tr, sc, flat):
    tr.occupancy.flat_stream = flat
    tr.active_sh_degree = 3
    static = tr.with_capacities(tr._static_for(IT))
    assert static.scene_type == "colmap" and static.single_camera
    state = checks.plain_state(tr.model, tr.deform, tr.deform_adam)
    model, _, _, packed = train_step(static, tr.model, tr.deform,
                                     tr.deform_adam, tr.scene.train_frames,
                                     2, IT, None, frame_id=2)
    loss, grads, _, _, _, _ = colmap_driver.loss_and_grads(cfg, sc, state, IT,
                                                           2)
    ref, ref_loss = colmap_driver.train_step(cfg, sc, state, IT, 2)
    return state, model, float(packed[0]), ref, ref_loss, grads


def _gap(prog, ref):
    """Each leaf's ||prog - ref|| over the larger of its ||ref|| and the
    median leaf's (of the leaves whose norm is not zero)."""
    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    med = statistics.median(v for v in map(norm, ref.values()) if v > 0)
    return {k: norm(prog[k] - ref[k]) / max(norm(ref[k]), med) for k in ref}


@pytest.mark.parametrize("flat", [False, True], ids=["dense", "flat"])
def test_colour_step_holds_to_the_reference(setup, flat):
    cfg, tr, sc = setup
    state, model, loss, ref, ref_loss, grads = _step(cfg, tr, sc, flat)
    assert abs(loss - ref_loss) <= LOSS_TOL * ref_loss
    alive = state["aux"]["alive"]
    prog_g = {k: v / (1.0 - checks.ADAM_B1)
              for k, v in model.adam.mu._asdict().items()}
    ref_g = {}
    for k, g in grads.items():
        if g.ndim and g.shape[0] == alive.shape[0]:
            g = torch.where(alive.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
        ref_g[k] = g
    assert max(_gap(prog_g, ref_g).values()) <= GRAD_TOL
    # The step's norm a leaf, as the benchmark's ``change_gap`` compares it:
    # Adam's first step moves each element by its rate times the sign of
    # its gradient, which rounding flips where the gradient is near zero.
    p0 = state["params"]
    moved = {k: float(torch.linalg.vector_norm((v - p0[k]).double()))
             for k, v in model.params._asdict().items()}
    ref_moved = {k: float(torch.linalg.vector_norm((v - p0[k]).double()))
                 for k, v in ref["params"].items()}
    assert checks.leaf_gap(moved, ref_moved, sorted(moved)) <= STEP_TOL
    for k in ("xyz_grad_accum", "denom"):
        got = getattr(model.aux, k) - state["aux"][k]
        want = ref["aux"][k] - state["aux"][k]
        assert torch.linalg.vector_norm(got - want) <= 1e-5 * \
            torch.linalg.vector_norm(want)


def test_flat_step_opens_its_span_and_records_occupancy(setup):
    _, tr, _ = setup
    tr.occupancy.flat_stream, tr.active_sh_degree = True, 3
    tr.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
        recs = tr.drain()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("composite.flat") == 2  # binning and compositing
    assert "flat.backward" not in names  # a CUDA tensor's span only
    rec = recs[-1]
    assert rec["flat"] is True and rec["rendered"] > 0
    assert 0 < rec["tile_max"] <= rec["rendered"]


def test_dense_step_opens_no_flat_span(setup):
    _, tr, _ = setup
    tr.occupancy.flat_stream = False
    tr.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
        recs = tr.drain()
    assert "composite.flat" not in [e.name() for e in
                                    prof.profiler.kineto_results.events()]
    assert recs[-1]["flat"] is False
