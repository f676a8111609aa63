"""The port's data layer (``gftorf_tpu_torch/data``: readers, colmap
parsing via the readers, Scene, the dataset writer) against the JAX
package on the CPU.

The readers are numpy in both packages, so ``SceneData`` must be equal
(the global ``np.random`` is seeded the same before each read, as the
Trainer seeds it). The stacked ``FrameData`` must be equal too: the
integers and images exactly, the camera tensors (which each package forms
in float32 from the same float64 matrices) at rtol 1e-6. The metadata
files ``write_scene_metadata`` writes must be byte-equal. The port's
writer, given the ground-truth Gaussians the JAX writer drew, renders
each file within atol 2e-5 / rtol 1e-4 of JAX's (the render parity of
tests/test_torch_render.py) and writes the same files.
"""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.config import ModelParams as JModel
from gftorf_tpu.data import readers as JR
from gftorf_tpu.data import generate as JG
from gftorf_tpu.data import scene as JS
from gftorf_tpu.data.generate import write_dataset as j_write
from gftorf_tpu_torch.config import Config as TConfig
from gftorf_tpu_torch.config import ModelParams as TModel
from gftorf_tpu_torch.data import readers as TR
from gftorf_tpu_torch.data import scene as TS
from gftorf_tpu_torch.data.generate import write_dataset as t_write
from test_reader_fixtures import FRAMES, ftorf_real_dir, torf_real_dir  # noqa: F401

W, H = 40, 32
FRAME_RTOL = 1e-6
WRITER_ATOL, WRITER_RTOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Datasets written by the JAX generator, with the Gaussians it drew."""
    root = tmp_path_factory.mktemp("data")
    out = {}
    for name, kw in (("ftorf", dict(num_frames=8)),
                     ("torf", dict(num_frames=8, torf_layout=True)),
                     ("room", dict(num_frames=4, layout="room"))):
        d = str(root / name)
        g = j_write(d, width=W, height=H, seed=3, **kw)
        out[name] = (d, {k: (v if isinstance(v, str) else np.asarray(v))
                         for k, v in g.items()}, kw)
    return out


def model_args(src, **kw):
    base = dict(source_path=src, total_num_views=8, tof_image_width=W,
                tof_image_height=H, color_image_width=W, color_image_height=H,
                num_points=300, total_num_spiral_views=4, dynamic=True,
                dataset_type="quad")
    base.update(kw)
    return JModel(**base), TModel(**base)


def read_both(path, **kw):
    jargs, targs = model_args(path, **kw)
    np.random.seed(7)
    jd = JR.read_scene(path, jargs, jargs.eval)
    np.random.seed(7)
    td = TR.read_scene(path, targs, targs.eval)
    return jd, td


def assert_value_equal(t, j, where):
    if isinstance(j, np.ndarray) or isinstance(t, np.ndarray):
        assert t is not None and j is not None, where
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=where)
    else:
        assert t == j, where


def assert_scene_data_equal(td, jd):
    for f in dataclasses.fields(JR.SceneData):
        jv, tv = getattr(jd, f.name), getattr(td, f.name)
        if f.name.endswith("cameras"):
            assert len(tv) == len(jv), f.name
            for i, (tc, jc) in enumerate(zip(tv, jv)):
                for cf in dataclasses.fields(JR.CameraRecord):
                    assert_value_equal(getattr(tc, cf.name), getattr(jc, cf.name),
                                       f"{f.name}[{i}].{cf.name}")
        else:
            assert_value_equal(tv, jv, f.name)


def assert_frames_equal(tf, jf):
    def walk(t, j, where):
        if isinstance(j, tuple):
            for name, a, b in zip(j._fields, t, j):
                walk(a, b, f"{where}.{name}")
            return
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, where
        if where.split(".")[1].startswith("cam_"):
            np.testing.assert_allclose(t, j, rtol=FRAME_RTOL, atol=0, err_msg=where)
        else:
            np.testing.assert_array_equal(t, j, err_msg=where)

    walk(tf, jf, "frames")


@pytest.mark.parametrize("name,kw", [
    ("ftorf", {}), ("ftorf", dict(init_method="phase", dynamic=False)),
    ("ftorf", dict(init_static_dynamic_separation=True)),
    ("torf", {}), ("torf", dict(eval=True, dynamic=False)),
    ("torf", dict(init_method="phase")),
])
def test_readers_match(datasets, name, kw):
    d = datasets[name][0]
    assert TR.detect_scene_type(d) == JR.detect_scene_type(d)
    jd, td = read_both(d, **kw)
    assert_scene_data_equal(td, jd)


@pytest.mark.parametrize("name", ["ftorf", "torf"])
def test_scene_frames_match(datasets, name):
    jargs, targs = model_args(datasets[name][0], eval=True)
    np.random.seed(1)
    js = JS.Scene(JConfig(model=jargs), init_model=False)
    np.random.seed(1)
    ts = TS.Scene(TConfig(model=targs), init_model=False, device="cpu")
    assert_frames_equal(ts.train_frames, js.train_frames)
    assert_frames_equal(ts.test_frames, js.test_frames)
    assert (ts.test_frames is ts.train_frames) == (js.test_frames is js.train_frames)
    for attr in ("scene_type", "scene_extent", "cameras_extent", "num_train",
                 "num_spiral", "color_size", "tof_size", "cameras_identical",
                 "tof_permutation", "tof_inverse_permutation"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    if js.num_spiral:
        assert_frames_equal(ts.spiral_frames, js.spiral_frames)
    one = TS.take_frame(ts.train_frames, 3)
    assert int(one.frame_id) == 3
    for tof in (False, True):
        jc, tc = js.raster_config(tof, 3), ts.raster_config(tof, 3)
        for f in dataclasses.fields(tc):
            if hasattr(jc, f.name):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name


@pytest.mark.parametrize("name", ["ftorf", "torf"])
def test_scene_metadata_files_equal(datasets, tmp_path, name):
    jargs, targs = model_args(datasets[name][0])
    np.random.seed(2)
    js = JS.Scene(JConfig(model=jargs), init_model=False)
    np.random.seed(2)
    ts = TS.Scene(TConfig(model=targs), init_model=False, device="cpu")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    JS.write_scene_metadata(js, jdir)
    TS.write_scene_metadata(ts, tdir)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "input.ply" in names
    for f in names:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f),
                           shallow=False), f
    TS.write_scene_bounds_png(ts, tdir)
    assert os.path.getsize(os.path.join(tdir, "scene_bounds.png")) > 0


@pytest.mark.parametrize("name", ["ftorf", "torf", "room"])
def test_writer_matches_jax_given_its_gaussians(datasets, tmp_path, name):
    jdir, g, kw = datasets[name]
    tdir = str(tmp_path / name)
    t_write(tdir, width=W, height=H, seed=3, g=g, device="cpu", **kw)
    jfiles = sorted(os.path.relpath(os.path.join(r, f), jdir)
                    for r, _, fs in os.walk(jdir) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(r, f), tdir)
                    for r, _, fs in os.walk(tdir) for f in fs)
    assert tfiles == jfiles
    for f in jfiles:
        a, b = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=WRITER_ATOL, rtol=WRITER_RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("layout", ["blobs", "room", "slide"])
def test_writer_draws_its_own_scene(tmp_path, layout):
    """Without ``g`` the port draws a scene of the JAX package's layout from
    a torch generator: the same keys and shapes, deterministic per seed,
    and a dataset both packages' readers read alike."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    g1 = t_write(d1, num_frames=4, width=W, height=H, layout=layout, seed=5,
                 device="cpu")
    g2 = t_write(d2, num_frames=4, width=W, height=H, layout=layout, seed=5,
                 device="cpu")
    ref = {"blobs": JG.make_gt_gaussians, "room": JG.make_room_gaussians,
           "slide": JG.make_slide_gaussians}[layout](jax.random.PRNGKey(0))
    assert set(ref) == set(g1)
    for k in ref:
        if isinstance(ref[k], str):
            assert g1[k] == ref[k]
        else:
            # the room's half wall keeps the rows its jitter puts left of
            # x = -0.25, so its row count depends on the draw
            assert tuple(g1[k].shape)[1:] == tuple(np.shape(ref[k]))[1:], k
    for k in g1:
        if torch.is_tensor(g1[k]):
            assert torch.equal(g1[k], g2[k]), k
    a = np.load(os.path.join(d1, "synthetic_tof", "0002.npy"))
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    jd, td = read_both(d1, total_num_views=4)
    assert_scene_data_equal(td, jd)


# --------------------------------------------- tests/test_reader_fixtures.py


def fixture_args(**kw):
    base = dict(total_num_views=FRAMES, tof_image_width=40, tof_image_height=32,
                color_image_width=40, color_image_height=32,
                init_method="random", num_points=256, total_num_spiral_views=4)
    base.update(kw)
    return JModel(**base), TModel(**base)


@pytest.mark.parametrize("kw", [dict(dataset_type="real"),
                                dict(dataset_type="real", init_method="phase")])
def test_torf_real_fixture_matches(torf_real_dir, kw):  # noqa: F811
    d = torf_real_dir[0]
    jargs, targs = fixture_args(**kw)
    np.random.seed(0)
    jd = JR.read_torf_scene(d, jargs, eval_split=False)
    np.random.seed(0)
    td = TR.read_torf_scene(d, targs, eval_split=False)
    assert_scene_data_equal(td, jd)
    with pytest.raises(FileNotFoundError):
        TR.read_torf_scene(d, fixture_args(dataset_type="synthetic")[1],
                           eval_split=False)


@pytest.mark.parametrize("kw", [{}, dict(tof_permutation="3,2,1,0", quad_scale=1.0)])
def test_ftorf_real_fixture_matches(ftorf_real_dir, kw):  # noqa: F811
    jargs, targs = fixture_args(**kw)
    np.random.seed(0)
    jd = JR.read_ftorf_scene(ftorf_real_dir, jargs)
    np.random.seed(0)
    td = TR.read_ftorf_scene(ftorf_real_dir, targs)
    assert_scene_data_equal(td, jd)
    assert np.all(td.train_cameras[5].image == 0.0)
