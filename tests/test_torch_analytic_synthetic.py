"""The port's data generators against the JAX package's, on the CPU.

``data/analytic.py`` is deterministic, so both packages' ``write_dataset``
must write byte-identical ``.npy`` files and equal ``meta.json`` (ftorf and
torf layouts, 48x32, 4 frames), and the port's Trainer must read and train
on the port's scene. ``data/synthetic.py::make_scene`` draws from a
``torch.Generator``: its camera and RasterConfig must equal the JAX
package's for the same arguments, and its arrays must render the same
frame through both packages' ``rasterize`` (atol 1e-4, rtol 1e-3).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.data import analytic as j_analytic
from gftorf_tpu.data.synthetic import make_scene as j_make_scene
from gftorf_tpu.render.rasterize import rasterize as j_rasterize
from gftorf_tpu.render.settings import CameraSpec as JCamera
from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data import analytic as t_analytic
from gftorf_tpu_torch.data.synthetic import make_scene as t_make_scene
from gftorf_tpu_torch.render.rasterize import rasterize as t_rasterize
from gftorf_tpu_torch.train.loop import Trainer

ATOL, RTOL = 1e-4, 1e-3
W, H, FRAMES = 48, 32, 4


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("analytic")
    out = {}
    for layout in ("ftorf", "torf"):
        for pkg, mod in (("j", j_analytic), ("t", t_analytic)):
            d = str(root / f"{pkg}_{layout}")
            mod.write_dataset(d, layout="room", num_frames=FRAMES, width=W,
                              height=H, torf_layout=layout == "torf",
                              supersample=2)
            out[pkg, layout] = d
    return out


def files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("layout", ["ftorf", "torf"])
def test_analytic_files_are_identical(scenes, layout):
    j, t = scenes["j", layout], scenes["t", layout]
    names = files(j)
    assert files(t) == names and "meta.json" in names
    for n in names:
        with open(os.path.join(j, n), "rb") as a, open(os.path.join(t, n), "rb") as b:
            assert a.read() == b.read(), n
    with open(os.path.join(t, "meta.json")) as f:
        assert json.load(f)["generator"] == "analytic"


def test_analytic_frame_functions_equal_jax():
    args = dict(width=W, height=H, fx=0.9 * W, fy=0.9 * W, cx=W / 2, cy=H / 2,
                depth_range=15.0, phase_offset=0.0, dc_offset=0.1)
    for layout, t in (("room", 0.3), ("slide", 0.7)):
        a = t_analytic.render_frame_analytic(layout, t, **args)
        b = j_analytic.render_frame_analytic(layout, t, **args)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_trainer_reads_port_analytic_scene(scenes, tmp_path):
    cfg = Config.from_dict(dict(
        source_path=scenes["t", "ftorf"], model_path=str(tmp_path / "m"),
        total_num_views=FRAMES, tof_image_width=W, tof_image_height=H,
        color_image_width=W, color_image_height=H, depth_range=15.0,
        num_points=300, iterations=3, warm_up=1, D=2, W=32, use_quad=True,
        dynamic=True, dataset_type="quad"))
    tr = Trainer(cfg, startup_artifacts=False, device="cpu")
    assert tr.scene.scene_type == "ftorf" and tr.scene.num_train == FRAMES
    # What the JAX reader makes of the JAX package's (identical) files.
    from gftorf_tpu.config import Config as JFileConfig
    from gftorf_tpu.data.readers import read_scene as j_read_scene

    jcfg = JFileConfig.from_dict(dict(cfg.to_dict(), source_path=scenes["j", "ftorf"]))
    jdata = j_read_scene(scenes["j", "ftorf"], jcfg.model, jcfg.model.eval)
    for a, b in zip(tr.scene.data.train_cameras, jdata.train_cameras):
        for k in ("tof_image", "distance_image", "quads", "image"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    recs = []
    for _ in range(3):
        recs += tr.step()
    recs += tr.drain()
    assert [r["iteration"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_points=400, width=64, height=40, sh_degree=1, isotropic=True,
         use_view_dependent_phase=True, max_per_tile=1024, dup_factor=8),
])
def test_make_scene_matches_jax(kw):
    t = t_make_scene(torch.Generator().manual_seed(0), device="cpu", **kw)
    j = j_make_scene(jax.random.PRNGKey(0), **kw)
    for name in JCamera._fields:
        np.testing.assert_array_equal(getattr(t.camera, name).numpy(),
                                      np.asarray(getattr(j.camera, name)),
                                      err_msg=name)
    jcfg = {f.name: getattr(j.config, f.name) for f in dataclasses.fields(j.config)}
    tcfg = {f.name: getattr(t.config, f.name) for f in dataclasses.fields(t.config)}
    assert tcfg == {k: v for k, v in jcfg.items() if k != "use_pallas"}
    n = kw.get("num_points", 256)
    for name, shape in (("means3d", (n, 3)), ("scales", (n, 3)),
                        ("rotations", (n, 4)), ("opacities", (n,))):
        assert getattr(t, name).shape == getattr(j, name).shape == shape
    assert float(t.phase_offset) == float(j.phase_offset)
    assert float(t.dc_offset) == float(j.dc_offset)
    z = t.means3d[:, 2]
    assert bool((z >= 1.0).all() & (z <= 8.0).all())
    assert bool((t.opacities >= 0.2).all() & (t.opacities <= 0.95).all())
    if kw.get("isotropic"):
        assert bool((t.scales == t.scales[:, :1]).all())

    # The port's arrays through both packages' rasterize.
    names = ("means3d", "scales", "rotations", "opacities", "shs", "shs_p",
             "phase_offset", "dc_offset")
    cfg = t.config
    bg = np.zeros((7, cfg.height, cfg.width), np.float32)
    t_out = t_rasterize(*(getattr(t, k) for k in names),
                        torch.zeros((n, 2)), torch.from_numpy(bg),
                        camera=t.camera, config=cfg,
                        active_sh_degree=cfg.sh_degree)
    j_out = j_rasterize(*(jnp.asarray(getattr(t, k).numpy()) for k in names),
                        jnp.zeros((n, 2)), jnp.asarray(bg), camera=j.camera,
                        config=j.config, active_sh_degree=cfg.sh_degree)
    assert int(t_out.tile_overflow) == 0 and not bool(t_out.dup_overflow)
    for k in ("color", "phasor", "depth", "acc", "depth_distortion"):
        np.testing.assert_allclose(getattr(t_out, k).numpy(),
                                   np.asarray(getattr(j_out, k)),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert float(t_out.acc.max()) > 0.5
