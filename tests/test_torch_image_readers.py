"""The port's readers at scale factors other than 1, and its COLMAP and
Blender readers, against the JAX package's, on the CPU; and the port's
start-up path with cv2, PIL, matplotlib and imageio unimportable.

The JAX readers resize with cv2 and open COLMAP and Blender images with
PIL; the port resizes with ``utils/resize.py`` and decodes PNGs with
``utils/image_io.py``. Everything must come out bitwise equal:

- a ToRF capture whose colour stream is twice the ToF camera's size
  (written twice from one seed and layout, the colour of the larger write
  copied over the smaller), read at ``color_scale_factor`` 0.5 as the
  shipped ``configs/torf.json`` reads 640x480: ``SceneData`` and the
  stacked frames (after ``build_frame``'s uint8 round trip);
- an F-ToRF capture at ``tof_scale_factor`` 0.5, whose distance maps are
  shrunk with INTER_NEAREST and every ToF map brought back to the colour
  size by ``build_frame`` (INTER_AREA enlarging);
- COLMAP (text model) with PNG images, and with a JPEG, which both
  packages open with PIL; Blender with RGBA and palette PNGs.

``SceneData`` is compared with ``tests/test_torch_data.py``'s exact
``assert_scene_data_equal``, frames with its ``assert_frames_equal``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.config import ModelParams as JModel
from gftorf_tpu.data import readers as JR
from gftorf_tpu.data import scene as JS
from gftorf_tpu_torch.config import Config as TConfig
from gftorf_tpu_torch.config import ModelParams as TModel
from gftorf_tpu_torch.data import readers as TR
from gftorf_tpu_torch.data import scene as TS
from gftorf_tpu_torch.data.generate import write_dataset
from test_torch_data import assert_frames_equal, assert_scene_data_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FRAMES = 40, 32, 8
BLOCKED = ("cv2", "PIL", "matplotlib", "imageio")


def write_torf_capture(d, rel_x=0.1):
    """A ToRF capture with ToF at W x H and colour at 2W x 2H: two writes
    of one seed and layout, the larger's colour stream and intrinsics
    copied into the smaller; a relative pose offsets the colour camera."""
    big = d + "_2x"
    write_dataset(d, num_frames=FRAMES, width=W, height=H, torf_layout=True,
                  seed=3, device="cpu")
    write_dataset(big, num_frames=FRAMES, width=2 * W, height=2 * H,
                  torf_layout=True, seed=3, device="cpu")
    for name in ("tof_extrinsics", "color_extrinsics"):
        np.testing.assert_array_equal(
            np.load(os.path.join(d, "cams", f"{name}.npy")),
            np.load(os.path.join(big, "cams", f"{name}.npy")))
    shutil.rmtree(os.path.join(d, "color"))
    shutil.copytree(os.path.join(big, "color"), os.path.join(d, "color"))
    shutil.copy(os.path.join(big, "cams", "color_intrinsics.npy"),
                os.path.join(d, "cams", "color_intrinsics.npy"))
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [rel_x, 0.0, 0.0]
    np.save(os.path.join(d, "cams", "relative_pose.npy"), rel)
    shutil.rmtree(big)
    return d


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    torf = write_torf_capture(str(root / "torf"))
    ftorf = str(root / "ftorf")
    write_dataset(ftorf, num_frames=FRAMES, width=W, height=H, seed=4,
                  device="cpu")
    return {"torf": torf, "ftorf": ftorf}


def both_args(src, **kw):
    base = dict(source_path=src, total_num_views=FRAMES, tof_image_width=W,
                tof_image_height=H, color_image_width=W, color_image_height=H,
                num_points=300, total_num_spiral_views=4, dynamic=True,
                dataset_type="quad")
    base.update(kw)
    return JModel(**base), TModel(**base)


def read_and_stack(path, **kw):
    """Both packages' SceneData and Scenes (frames stacked) of one capture."""
    jargs, targs = both_args(path, **kw)
    np.random.seed(5)
    jd = JR.read_scene(path, jargs, jargs.eval)
    np.random.seed(5)
    td = TR.read_scene(path, targs, targs.eval)
    js = JS.Scene(JConfig(model=jargs), load_data=jd, init_model=False)
    ts = TS.Scene(TConfig(model=targs), load_data=td, init_model=False,
                  device="cpu")
    return jd, td, js, ts


def assert_scenes_equal(jd, td, js, ts):
    assert_scene_data_equal(td, jd)
    assert_frames_equal(ts.train_frames, js.train_frames)
    assert_frames_equal(ts.test_frames, js.test_frames)
    if js.num_spiral:
        assert_frames_equal(ts.spiral_frames, js.spiral_frames)


TORF_HALF = dict(color_image_width=2 * W, color_image_height=2 * H,
                 color_scale_factor=0.5)


@pytest.mark.parametrize("kw", [{}, dict(init_method="phase", eval=True,
                                         dynamic=False)],
                         ids=["random", "phase_static_eval"])
def test_torf_colour_at_half_scale_matches_jax(captures, kw):
    src = np.load(os.path.join(captures["torf"], "color", "0000.npy"))
    assert src.shape == (2 * H, 2 * W, 3)
    jd, td, js, ts = read_and_stack(captures["torf"], **TORF_HALF, **kw)
    for c in td.train_cameras + td.test_cameras:
        assert c.image.shape == (H, W, 3) and (c.width, c.height) == (W, H)
    assert_scenes_equal(jd, td, js, ts)
    assert not ts.cameras_identical and ts.color_size == (H, W)


def test_ftorf_tof_at_half_scale_matches_jax(captures):
    jd, td, js, ts = read_and_stack(captures["ftorf"], tof_scale_factor=0.5)
    c = td.train_cameras[0]
    assert c.distance_image.shape == (H // 2, W // 2)  # INTER_NEAREST
    assert c.tof_image.shape == (H // 2, W // 2, 3)
    assert c.quads.shape == (4, H // 2, W // 2)
    assert tuple(ts.train_frames.gt_phasor.shape[2:]) == (H, W)  # enlarged
    assert_scenes_equal(jd, td, js, ts)


# -------------------------------------------------------- COLMAP, Blender


def write_colmap(d, ext_of=lambda i: ".png"):
    """A text COLMAP model of three PINHOLE views and PIL-written images
    (RGB, RGBA, RGB) of 24x20 pixels."""
    rng = np.random.default_rng(8)
    sparse = os.path.join(d, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(d, "images"))
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write("1 PINHOLE 24 20 30.0 28.0 12.0 10.0\n")
        f.write("2 SIMPLE_PINHOLE 24 20 26.0 12.0 10.0\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        for i in range(3):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.normal(size=3)
            name = f"view{i:02d}{ext_of(i)}"
            f.write(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))} "
                    f"{1 + i % 2} {name}\n")
            f.write("1.0 2.0 -1 3.5 4.5 0\n")
            mode, ch = (("RGBA", 4) if i == 1 else ("RGB", 3))
            img = rng.integers(0, 256, (20, 24, ch), dtype=np.uint8)
            img[:10] = img[:1]  # smooth rows: PIL picks different filters
            Image.fromarray(img, mode).save(os.path.join(d, "images", name))
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for k in range(20):
            xyz = rng.normal(size=3)
            rgb = rng.integers(0, 256, 3)
            f.write(f"{k + 1} {' '.join(map(str, xyz))} "
                    f"{' '.join(map(str, rgb))} 0.5 1 0\n")
    return d


def write_blender(d):
    """transforms_{train,test}.json and RGBA and palette PNGs (with
    transparency) of 24x20 pixels."""
    rng = np.random.default_rng(9)
    for split, n in (("train", 3), ("test", 2)):
        os.makedirs(os.path.join(d, split))
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3) * 2.0
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            img = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
            img[:8, :, 3] = 0
            im = Image.fromarray(img, "RGBA")
            if i % 2:
                im = im.convert("RGB").convert(
                    "P", palette=Image.Palette.ADAPTIVE, colors=64)
                im.save(os.path.join(d, split, f"r_{i}.png"), transparency=5)
            else:
                im.save(os.path.join(d, split, f"r_{i}.png"))
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return d


def color_only_args(src, **kw):
    return both_args(src, tof_image_width=24, tof_image_height=20,
                     color_image_width=24, color_image_height=20,
                     total_num_views=3, **kw)


@pytest.mark.parametrize("jpeg", [False, True], ids=["png", "jpeg"])
def test_colmap_reader_matches_jax(tmp_path, jpeg):
    d = write_colmap(str(tmp_path / "colmap"),
                     (lambda i: ".jpg" if i == 2 else ".png") if jpeg
                     else (lambda i: ".png"))
    assert TR.detect_scene_type(d) == JR.detect_scene_type(d) == "colmap"
    jargs, targs = color_only_args(d, eval=True)
    jd = JR.read_colmap_scene(d, jargs, eval_split=True, llffhold=2)
    td = TR.read_colmap_scene(d, targs, eval_split=True, llffhold=2)
    assert len(td.train_cameras) == 1 and len(td.test_cameras) == 2
    assert_scene_data_equal(td, jd)
    js = JS.Scene(JConfig(model=jargs), load_data=jd, init_model=False)
    ts = TS.Scene(TConfig(model=targs), load_data=td, init_model=False,
                  device="cpu")
    assert_frames_equal(ts.train_frames, js.train_frames)
    assert_frames_equal(ts.test_frames, js.test_frames)


@pytest.mark.parametrize("bg", [0.0, 1.0])
@pytest.mark.parametrize("eval_split", [False, True])
def test_blender_reader_matches_jax(tmp_path, bg, eval_split):
    d = write_blender(str(tmp_path / "blender"))
    assert TR.detect_scene_type(d) == JR.detect_scene_type(d) == "blender"
    jargs, targs = color_only_args(d, bg_color=[bg] * 7)
    np.random.seed(6)
    jd = JR.read_blender_scene(d, jargs, eval_split)
    np.random.seed(6)
    td = TR.read_blender_scene(d, targs, eval_split)
    assert_scene_data_equal(td, jd)
    rgba = td.train_cameras[0].image  # top rows fully transparent
    assert rgba.shape == (20, 24, 3) and (rgba[:8] == bg).all()


# ------------------------------------------ without cv2, PIL, matplotlib


def test_startup_without_image_libraries(captures, tmp_path):
    """In a process where cv2, PIL, matplotlib and imageio cannot be
    imported, the port reads the ToRF capture at colour scale 0.5, starts
    its Trainer for one iteration on the CPU and writes the start-up
    artifacts, scene_bounds.png among them; a COLMAP model with a JPEG
    raises the documented ImportError naming the image."""
    colmap = write_colmap(str(tmp_path / "colmap"),
                          lambda i: ".jpg" if i == 2 else ".png")
    cfg = dict(source_path=captures["torf"], total_num_views=FRAMES,
               tof_image_width=W, tof_image_height=H, dataset_type="quad",
               depth_range=15.0, num_points=300, iterations=1, D=2, W=32,
               dynamic=True, **TORF_HALF)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = str(tmp_path / "out")
    script = textwrap.dedent(f"""
        import sys
        for m in {BLOCKED!r}:
            sys.modules[m] = None
        from gftorf_tpu_torch.config import ModelParams
        from gftorf_tpu_torch.data.readers import read_colmap_scene
        from gftorf_tpu_torch.train.__main__ import main
        tr = main(["--config", {cfg_path!r}, "--model_path", {out!r},
                   "--device", "cpu", "--quiet", "--test_iterations", "0"])
        print("ITERATIONS", tr.iteration, tr.scene.color_size)
        try:
            read_colmap_scene({colmap!r}, ModelParams(), eval_split=False)
        except ImportError as e:
            print("IMPORT_ERROR", e)
        print("LOADED", sorted(m for m in {BLOCKED!r} if sys.modules.get(m)))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert f"ITERATIONS 1 ({H}, {W})" in lines, proc.stdout[-2000:]
    err = [ln for ln in lines if ln.startswith("IMPORT_ERROR")]
    assert err and "view02.jpg" in err[0] and "PIL" in err[0], proc.stdout[-2000:]
    assert "LOADED []" in lines
    assert "warn" not in proc.stdout + proc.stderr
    for name in ("scene_bounds.png", "cameras.json", "input.ply",
                 "cfg_args_full.json"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    with open(os.path.join(out, "scene_bounds.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
