"""The port's render path on the CPU against the JAX package's.

Tiny models are trained with the JAX Trainer and saved with the JAX
exporter (as tests/test_render_cli.py does): an F-ToRF quad scene and a
ToRF scene with a spiral path, 48x32, 10 iterations. Copies of each model
directory are rendered by ``gftorf_tpu.render_sets`` / ``render.py`` /
``render_traj.py`` and by the port (``python -m gftorf_tpu_torch.render``,
``gftorf_tpu_torch.render_sets``, ``gftorf_tpu_torch.render_traj``) on the
CPU, and the trees are compared: PNGs differ by at most 1 level on at most
1 % of a channel's pixels, ``.npy`` maps and proxy point positions agree
within the frame tolerance (atol 1e-4, rtol 1e-3), proxy colours and
panel layouts exactly.
"""

import json
import os
import shutil
import sys
from unittest import mock

import imageio.v2 as imageio
import numpy as np
import pytest
import scipy.ndimage
import torch

from gftorf_tpu import render_sets as j_rs
from gftorf_tpu import video_panel as j_vp
from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.data.generate import write_dataset
from gftorf_tpu.train.debug import dump_debug_images as j_dump
from gftorf_tpu.train.export import save_scene_artifacts as j_save
from gftorf_tpu.train.export import write_proxy_pcds as j_proxy
from gftorf_tpu.train.loop import Trainer as JTrainer
from gftorf_tpu.utils.ply import read_ply
from gftorf_tpu_torch import render_sets as t_rs
from gftorf_tpu_torch import render_traj as t_traj
from gftorf_tpu_torch import video_panel as t_vp
from gftorf_tpu_torch.render.__main__ import main as t_render_main
from gftorf_tpu_torch.train.debug import dump_debug_images as t_dump
from gftorf_tpu_torch.train.export import write_proxy_pcds as t_proxy

ATOL, RTOL = 1e-4, 1e-3
PNG_LEVELS, PNG_FRAC = 1, 0.01
W, H, ITERS = 48, 32, 10
# tmp_debug_<ch>[_gt|_error] of a quad scene: 10 channels, 23 directories.
N_DEBUG_DIRS = 23
BLOCKED = ("imageio", "imageio.v2", "imageio.v3", "cv2", "matplotlib",
           "matplotlib.pyplot", "matplotlib.cm", "matplotlib.colors", "PIL",
           "PIL.Image", "PIL.ImageDraw")


def _train(root, name, **extra):
    """A JAX-trained, JAX-saved model directory; returns (model, scene)."""
    scene = str(root / f"scene_{name}")
    model = str(root / f"model_{name}")
    write_dataset(scene, num_frames=4, width=W, height=H,
                  torf_layout=extra.pop("torf_layout", False))
    cfg = JConfig.from_dict(dict(
        source_path=scene, model_path=model, total_num_views=4,
        tof_image_width=W, tof_image_height=H, color_image_width=W,
        color_image_height=H, depth_range=15.0, num_points=500,
        iterations=ITERS, warm_up=1000, densify_from_iter=1000,
        densify_until_iter=5, lambda_color=0.5, **extra))
    cfg.save(cfg.model.model_path)
    trainer = JTrainer(cfg)
    for _ in range(ITERS):
        trainer.step()
    trainer.drain()
    j_save(trainer, ITERS)
    return model, scene


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


class _Spy:
    """Wrap ``owner.name`` (a function or a method), recording the
    arguments of every call (a method's with its ``self``)."""

    def __init__(self, owner, name):
        self.calls, self.orig = [], getattr(owner, name)
        self.patch = mock.patch.object(owner, name, autospec=True,
                                       side_effect=self._call)

    def _call(self, *args, **kwargs):
        self.calls.append(args)
        return self.orig(*args, **kwargs)

    def __enter__(self):
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The two models rendered by both packages, the trajectories' line
    segments of both, and a model whose render overflows a tile."""
    import render_traj as j_traj
    from PIL import ImageDraw

    root = tmp_path_factory.mktemp("render")
    ftorf, ftorf_scene = _train(root, "ftorf", use_quad=True,
                                dataset_type="quad")
    torf, _ = _train(root, "torf", torf_layout=True, use_quad=False,
                     dynamic=True, dataset_type="synthetic",
                     total_num_spiral_views=6)
    out = {"scene": ftorf_scene, "trained": ftorf}
    for name, src in (("ftorf", ftorf), ("torf", torf)):
        out[f"j_{name}"] = _copy(src, root / f"j_{name}")
        out[f"t_{name}"] = _copy(src, root / f"t_{name}")
        out[f"blocked_{name}"] = _copy(src, root / f"blocked_{name}")

    # JAX: render.py's path (render_sets, then the proxy clouds), the
    # trajectories with their trail segments recorded.
    for name in ("ftorf", "torf"):
        j_rs.render_sets(out[f"j_{name}"], ITERS, max_frames=2)
    trainer, _, it = j_rs.load_trained(out["j_ftorf"], ITERS)
    j_proxy(trainer, it, max_frames=2)
    with _Spy(ImageDraw.ImageDraw, "line") as spy:
        j_traj.main(["--model_path", out["j_ftorf"], "--num_tracks", "8"])
    out["j_segments"] = [call[1] for call in spy.calls]

    # The port: its CLI on the ftorf copy (with the proxy clouds),
    # render_sets on the torf copy, the trajectories.
    t_render_main(["--model_path", out["t_ftorf"], "--max_frames", "2",
                   "--proxy_pcd", "--device", "cpu"])
    t_rs.render_sets(out["t_torf"], ITERS, max_frames=2, device="cpu")
    with _Spy(t_traj, "draw_line") as spy:
        t_traj.main(["--model_path", out["t_ftorf"], "--num_tracks", "8",
                     "--device", "cpu"])
    out["t_segments"] = [call[1:3] for call in spy.calls]
    return out


def files(d, sub=""):
    base = os.path.join(d, sub)
    return sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, _, fs in os.walk(base) for f in fs)


def assert_png_close(a, b, what):
    diff = np.abs(a.astype(int) - b.astype(int))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert diff.max() <= PNG_LEVELS, (what, diff.max())
    assert (diff > 0).mean() <= PNG_FRAC, (what, (diff > 0).mean())


def assert_trees_close(j_dir, t_dir):
    """Every PNG and .npy file of the JAX tree in the port's, close."""
    names = files(j_dir)
    assert files(t_dir) == names
    pngs = [n for n in names if n.endswith(".png")]
    npys = [n for n in names if n.endswith(".npy")]
    assert pngs
    for n in pngs:
        assert_png_close(imageio.imread(os.path.join(t_dir, n)),
                         imageio.imread(os.path.join(j_dir, n)), n)
    for n in npys:
        np.testing.assert_allclose(np.load(os.path.join(t_dir, n)),
                                   np.load(os.path.join(j_dir, n)),
                                   atol=ATOL, rtol=RTOL, err_msg=n)


@pytest.mark.parametrize("name", ["ftorf", "torf"])
def test_render_tree_matches_jax(models, name):
    """renders_10/ and input/ equal render.py's, file for file."""
    j, t = models[f"j_{name}"], models[f"t_{name}"]
    for sub in ("renders_10", "input"):
        assert_trees_close(os.path.join(j, sub), os.path.join(t, sub))
    splits = sorted(os.listdir(os.path.join(t, "renders_10")))
    want = ["test"] + (["freezeframe_spiral", "renders_spiral"]
                       if name == "torf" else [])
    assert splits == sorted(want)
    gifs = [f for f in os.listdir(os.path.join(t, "renders_10", "test"))
            if f.endswith(".gif")]
    assert len(gifs) == (9 if name == "ftorf" else 8)
    # The panel: the same file name, frame count and frame shape.
    for d in (j, t):
        assert os.path.isfile(os.path.join(d, "iteration_10_video_panel.gif"))
    jp = imageio.mimread(os.path.join(j, "iteration_10_video_panel.gif"))
    tp = imageio.mimread(os.path.join(t, "iteration_10_video_panel.gif"))
    assert len(tp) == len(jp) == 2
    assert tp[0].shape[:2] == jp[0].shape[:2]


def test_spiral_and_freezeframe_frames_differ(models):
    base = os.path.join(models["t_torf"], "renders_10")
    for split in ("renders_spiral", "freezeframe_spiral"):
        a, b = (imageio.imread(os.path.join(base, split, "depth", f"{i:04d}.png"))
                for i in (0, 1))
        assert a.shape[:2] == (H, W) and np.any(a != b), split


def test_proxy_pcds_match_jax(models):
    j = os.path.join(models["j_ftorf"], "proxy_pcd")
    t = os.path.join(models["t_ftorf"], "proxy_pcd")
    assert files(t) == files(j)
    for fid in (0, 1):
        a = read_ply(os.path.join(t, f"frame_{fid}", "input.ply"))
        b = read_ply(os.path.join(j, f"frame_{fid}", "input.ply"))
        assert list(a) == list(b) and len(a["x"]) == 2 * W * H
        for k in a:
            if a[k].dtype == np.uint8 or not a[k].any():
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL,
                                           err_msg=k)
        with open(os.path.join(t, f"frame_{fid}", "cameras.json")) as f:
            cams_t = json.load(f)
        with open(os.path.join(j, f"frame_{fid}", "cameras.json")) as f:
            assert cams_t == json.load(f)


def test_trajectories_match_jax(models):
    """Track coordinates (1e-4), the depth frames, and trails that lie
    within a pixel of their segments."""
    j = os.path.join(models["j_ftorf"], "traj_10")
    t = os.path.join(models["t_ftorf"], "traj_10")
    assert files(t) == files(j)
    js, ts = models["j_segments"], models["t_segments"]
    assert len(ts) == len(js) > 0
    for (p0, p1), seg in zip(ts, js):
        np.testing.assert_allclose(np.concatenate([p0, p1]),
                                   np.ravel(seg), atol=1e-4, rtol=0)
    for sub in ["depth_quad"] + [f"depth_q{k}" for k in range(4)] + [
            f"quad_q{k}" for k in range(4)]:
        for n in files(j, sub):
            assert_png_close(imageio.imread(os.path.join(t, sub, n)),
                             imageio.imread(os.path.join(j, sub, n)), sub + n)
    for n in files(t, "traj"):
        trail = imageio.imread(os.path.join(t, "traj", n))
        depth = imageio.imread(os.path.join(t, "depth_quad", n))
        ys, xs = np.nonzero((trail != depth).any(-1))
        segs = [(np.asarray(a), np.asarray(b)) for a, b in ts]
        for y, x in zip(ys, xs):
            p = np.array([x, y], float)
            dist = min(np.linalg.norm(p - (a + np.clip(
                np.dot(p - a, b - a) / max(np.dot(b - a, b - a), 1e-12), 0, 1)
                * (b - a))) for a, b in segs)
            assert dist <= 1.0, (n, x, y, dist)
    for panel in ("website_panel", "quad_panel"):
        a = imageio.mimread(os.path.join(models["t_ftorf"],
                                         f"iteration_10_{panel}.gif"))
        b = imageio.mimread(os.path.join(models["j_ftorf"],
                                         f"iteration_10_{panel}.gif"))
        assert len(a) == len(b) and a[0].shape[:2] == b[0].shape[:2], panel


def _panel_frames(module, attr, fn, *args, **kwargs):
    with _Spy(module, attr) as spy:
        fn(*args, **kwargs)
    return np.stack(spy.calls[0][1])


def _panels_without_text(make_j, make_t):
    """Each package's panel frames with and without text and arrows."""
    import cv2

    j = make_j()
    t = make_t()
    with mock.patch.object(cv2, "putText"), mock.patch.object(cv2, "arrowedLine"):
        j0 = make_j()
    with mock.patch.object(t_vp, "put_text"), mock.patch.object(t_vp, "draw_down_arrow"):
        t0 = make_t()
    return j, t, j0, t0


def _assert_panel_match(j, t, j0, t0, what):
    """Outside the pixels either package's text or arrows touch (grown by
    a pixel), the panels are equal; every text blob of the JAX panel has
    port text within 12 pixels of it."""
    assert t.shape == j.shape, (what, t.shape, j.shape)
    text_j = (j != j0).any(-1).any(0)
    text_t = (t != t0).any(-1).any(0)
    mask = scipy.ndimage.binary_dilation(text_j | text_t, iterations=1)
    np.testing.assert_array_equal(t[:, ~mask], j[:, ~mask], err_msg=what)
    labels, n = scipy.ndimage.label(text_j, structure=np.ones((3, 3)))
    assert n > 0
    for sl in scipy.ndimage.find_objects(labels):
        box = tuple(slice(max(s.start - 12, 0), s.stop + 12) for s in sl)
        assert text_t[box].any(), (what, sl)


@pytest.mark.parametrize("name", ["ftorf", "torf"])
def test_video_panel_layout_matches_jax(models, name, tmp_path):
    """Both packages compose the panel from the port's render tree."""
    d = _copy(models[f"t_{name}"], tmp_path / "m")
    j, t, j0, t0 = _panels_without_text(
        lambda: _panel_frames(j_vp, "_write_video", j_vp.create_video_panel,
                              d, ITERS, scene_type=name),
        lambda: _panel_frames(t_vp, "write_video", t_vp.create_video_panel,
                              d, ITERS, scene_type=name))
    _assert_panel_match(j, t, j0, t0, name)
    # The label strips: the band above the image in every (uniform) cell.
    top = t_vp._LABEL_H + t_vp._MARGIN
    cell_h, cell_w = H + top + t_vp._MARGIN, W + 2 * t_vp._MARGIN
    strips = np.zeros(t.shape[1:3], bool)
    for y in range(0, t.shape[1], cell_h):
        strips[y:y + top] = True
    np.testing.assert_array_equal(t[:, ~strips], j[:, ~strips])
    for y in range(0, t.shape[1], cell_h):
        for x in range(0, t.shape[2], cell_w):
            assert (t[:, y:y + top, x:x + cell_w] < 100).any(), (y, x)


@pytest.mark.parametrize("panel", ["website", "quad_cadence"])
def test_traj_panels_layout_matches_jax(models, panel, tmp_path):
    d = _copy(models["t_ftorf"], tmp_path / "m")
    fn = f"create_{panel}_panel"
    j, t, j0, t0 = _panels_without_text(
        lambda: _panel_frames(j_vp, "_write_video", getattr(j_vp, fn), d, ITERS),
        lambda: _panel_frames(t_vp, "write_video", getattr(t_vp, fn), d, ITERS))
    _assert_panel_match(j, t, j0, t0, panel)


def test_tile_overflow_jax_truncates_port_does_not(models, tmp_path):
    """A model whose config's max_per_tile (128) is below its deepest
    tile: render.py drops instances (tile_overflow > 0 in JAX's frame), the
    port grows the cap by the Trainer's rule and renders the frame that
    a large enough cap gives."""
    import jax

    from gftorf_tpu.data.scene import take_frame
    from gftorf_tpu.train.evaluate import eval_frame

    d = {}
    for pkg in ("j", "t"):
        d[pkg] = _copy(models["trained"], tmp_path / pkg)
        path = os.path.join(d[pkg], "cfg_args_full.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["max_per_tile"] = 128
        with open(path, "w") as f:
            json.dump(cfg, f)
    trainer, _, it = j_rs.load_trained(d["j"], ITERS)
    static = trainer._static_for(it)
    _, _, out = eval_frame(static, trainer.model.params, trainer.deform,
                           trainer.model.aux.alive,
                           take_frame(trainer.scene.test_frames, 0))
    assert int(jax.device_get(out.tile_overflow)) > 0
    j_rs.render_sets(d["j"], ITERS, skip_video=True, max_frames=2)
    t_rs.render_sets(d["t"], ITERS, skip_video=True, max_frames=2,
                     device="cpu")
    full = os.path.join(models["j_ftorf"], "renders_10", "test", "depth")
    for i in range(2):
        ref = np.load(os.path.join(full, f"{i:04d}.npy"))
        got = np.load(os.path.join(d["t"], "renders_10", "test", "depth",
                                   f"{i:04d}.npy"))
        cut = np.load(os.path.join(d["j"], "renders_10", "test", "depth",
                                   f"{i:04d}.npy"))
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
        assert np.abs(cut - ref).max() > 1e-2
    # The port's record of the frame: the overflow it met and the cap it
    # rendered at.
    tr, _, _ = t_rs.load_trained(d["t"], ITERS, device="cpu")
    st, _, rec = t_rs.render_frame(tr, tr._static_for(ITERS),
                                   t_rs.take_frame(tr.scene.test_frames, 0))
    assert rec["tile_overflow"] > 0 and rec["tile_overflow_final"] == 0
    assert st.config_tof.max_per_tile >= rec["tile_max"] > 128


def test_debug_dumps_match_jax(models, tmp_path):
    """dump_debug_images on the same loaded state: every tmp_debug_*
    image at the PNG tolerance."""
    d = {}
    for pkg in ("j", "t"):
        d[pkg] = _copy(models["trained"], tmp_path / pkg)
    jt, _, _ = j_rs.load_trained(d["j"], ITERS)
    tt, _, _ = t_rs.load_trained(d["t"], ITERS, device="cpu")
    for idx in (0, 3):
        j_dump(jt, idx, ITERS)
        t_dump(tt, idx, ITERS)
    dirs = sorted(x for x in os.listdir(d["j"]) if x.startswith("tmp_debug_"))
    assert len(dirs) == N_DEBUG_DIRS
    assert sorted(x for x in os.listdir(d["t"])
                  if x.startswith("tmp_debug_")) == dirs
    for sub in dirs:
        names = files(d["j"], sub)
        assert files(d["t"], sub) == names and len(names) == 2
        for n in names:
            assert_png_close(imageio.imread(os.path.join(d["t"], sub, n)),
                             imageio.imread(os.path.join(d["j"], sub, n)),
                             sub + n)


def test_train_cli_debug_writes_dumps(models, tmp_path):
    """--debug true: the port's train CLI dumps at iteration 1 and every
    debug_interval, labelled with the Trainer's iteration."""
    from gftorf_tpu_torch.train.__main__ import main

    with open(os.path.join(models["trained"], "cfg_args_full.json")) as f:
        cfg = json.load(f)
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = str(tmp_path / "out")
    tr = main(["--config", path, "--model_path", out, "--device", "cpu",
               "--iterations", "4", "--debug", "true", "--debug_interval", "2",
               "--test_iterations", "0", "--save_iterations", "4", "--quiet"])
    dumped = sorted(x for x in os.listdir(out) if x.startswith("tmp_debug_"))
    assert len(dumped) == N_DEBUG_DIRS
    labels = sorted({int(n.split("_")[0]) for n in files(out, "tmp_debug_depth")})
    lag = tr.metrics_lag
    assert labels == sorted({1 + lag, min(2 + lag, 4), 4})


def test_render_cli_runs_as_module(models, tmp_path):
    """``python -m gftorf_tpu_torch.render --device cpu`` in a process of
    its own writes render.py's test split."""
    import subprocess

    d = _copy(models["trained"], tmp_path / "m")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-m", "gftorf_tpu_torch.render",
                    "--model_path", d, "--device", "cpu", "--max_frames", "1",
                    "--skip_video"], cwd=root, check=True, timeout=300,
                   capture_output=True)
    want = sorted(n for n in files(models["t_ftorf"], "renders_10")
                  if n.endswith(("0000.png", "0000.npy")))
    assert files(d, "renders_10") == want


def test_render_cli_needs_cuda_without_device(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_render_main(["--model_path", models["trained"]])


def test_write_video_mp4_probe(tmp_path, monkeypatch):
    """An mp4 where imageio's ffmpeg writer opens (a stub here), a GIF
    where it does not or imageio is missing."""
    from gftorf_tpu_torch.utils import image_io

    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(3)]
    written = {}

    class StubWriter:
        def append_data(self, f):
            written.setdefault("frames", []).append(f)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            open(written["path"], "wb").write(b"mp4")

    def get_writer(path, fps):
        written.update(path=path, fps=fps)
        return StubWriter()

    monkeypatch.setattr(imageio, "get_writer", get_writer)
    out = image_io.write_video(str(tmp_path / "clip"), frames, fps=12.0)
    assert out.endswith(".mp4") and os.path.exists(out)
    assert written["fps"] == 12.0 and len(written["frames"]) == 3

    def no_backend(path, fps):
        raise ValueError("no ffmpeg backend")

    monkeypatch.setattr(imageio, "get_writer", no_backend)
    out = image_io.write_video(str(tmp_path / "clip2"), frames, fps=12.0)
    assert out.endswith(".gif") and len(imageio.mimread(out)) == 3
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    out = image_io.write_video(str(tmp_path / "clip3"), frames, fps=12.0)
    assert out.endswith(".gif")


def test_render_path_without_image_libraries(models, monkeypatch):
    """With imageio, cv2, matplotlib and PIL unimportable, render_sets,
    render_traj, write_proxy_pcds and dump_debug_images write their whole
    trees (GIF panels in place of mp4)."""
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    for name in ("ftorf", "torf"):
        d = models[f"blocked_{name}"]
        t_rs.render_sets(d, ITERS, max_frames=2, device="cpu")
        ref = models[f"t_{name}"]
        for sub in ("renders_10", "input"):
            assert files(d, sub) == files(ref, sub)
    d = models["blocked_ftorf"]
    t_traj.main(["--model_path", d, "--num_tracks", "8", "--device", "cpu"])
    assert files(d, "traj_10") == files(models["t_ftorf"], "traj_10")
    tr, _, it = t_rs.load_trained(d, ITERS, device="cpu")
    t_proxy(tr, it, max_frames=2)
    assert files(d, "proxy_pcd") == files(models["t_ftorf"], "proxy_pcd")
    t_dump(tr, 0, ITERS)
    assert len([x for x in os.listdir(d) if x.startswith("tmp_debug_")]) == N_DEBUG_DIRS
    panels = sorted(f for f in os.listdir(d) if f.startswith("iteration_10_"))
    assert panels == ["iteration_10_quad_panel.gif",
                      "iteration_10_video_panel.gif",
                      "iteration_10_website_panel.gif"]
