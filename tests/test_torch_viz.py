"""The port's visualisation, image files and viewer against the JAX
package's, on the CPU.

``utils/viz.py``'s magma maps must equal the JAX package's (matplotlib's
``cm.magma``) bit for bit, ``flow_to_image`` within 1 level; PNGs that
``utils/image_io.write_png`` writes decode exactly with imageio, and
``read_png`` reads them back and refuses 16-bit PNGs; a ``write_gif`` file
decodes with imageio to its frame count and shape, each frame within the
palette's step of its source. The SIBR viewer's round trip runs against
the port's module, with a numpy and a torch ``render_fn``.
"""

import json
import socket
import struct
import threading
import time

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from gftorf_tpu.utils import viz as J
from gftorf_tpu_torch import viewer
from gftorf_tpu_torch.render_traj import clip_segment, draw_line
from gftorf_tpu_torch.utils import image_io
from gftorf_tpu_torch.utils import viz as T

EDGES = np.array([0.0, 1.0, 255 / 256, 1 / 256, -0.5, 1.5, np.nan])


@pytest.fixture(scope="module")
def rng_images():
    rng = np.random.default_rng(0)
    depth = rng.uniform(-1.0, 14.0, (32, 48)).astype(np.float32)
    depth[0, :4] = [np.nan, np.inf, -np.inf, 0.0]
    return dict(
        rng=rng,
        depth=depth,
        phasor=rng.normal(size=(32, 48, 3)).astype(np.float32),
        flow=rng.normal(size=(32, 48, 2)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_magma_table_equals_matplotlib(dtype):
    from matplotlib import cm

    x = np.concatenate([np.random.default_rng(1).random(100_000), EDGES])
    x = x.astype(dtype)
    np.testing.assert_array_equal(T.magma(x), cm.magma(x)[..., :3])


@pytest.mark.parametrize("depth_range", [15.0, 7.5])
def test_depth_viz_equals_jax(rng_images, depth_range):
    d = rng_images["depth"]
    np.testing.assert_array_equal(T.depth_to_disp_viz(d, depth_range),
                                  J.depth_to_disp_viz(d, depth_range))
    for name in ("sliding_cube", "data_color_x", "room"):
        bounds = T.paper_viz_bounds(name)
        assert bounds == J.paper_viz_bounds(name)
        np.testing.assert_array_equal(
            T.depth_to_disp_viz_window(d, *bounds[:2]),
            J.depth_to_disp_viz_window(d, *bounds[:2]))
    assert T.PAPER_VIZ_BOUNDS == J.PAPER_VIZ_BOUNDS


def test_phasor_and_normalise_equal_jax(rng_images):
    ph = rng_images["phasor"]
    for a, b in zip(T.phasor2real_img_amp(ph), J.phasor2real_img_amp(ph)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T.phase2real_img(ph[..., :2]), J.phase2real_img(ph[..., :2])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.to8b(ph), J.to8b(ph))
    np.testing.assert_array_equal(T.normalize_im(ph), J.normalize_im(ph))
    gts = [ph[..., 0], ph[..., 1] * 3]
    np.testing.assert_array_equal(T.normalize_im_gt(ph[..., 2], gts),
                                  J.normalize_im_gt(ph[..., 2], gts))


def test_flow_to_image_within_a_level(rng_images):
    from matplotlib import colors

    f = rng_images["flow"]
    for ref in (None, 2.0 * f):
        a = T.flow_to_image(f, ref).astype(int)
        b = J.flow_to_image(f, ref).astype(int)
        assert np.abs(a - b).max() <= 1
    hsv = rng_images["rng"].random((500, 3))
    hsv[::5, 1] = 0.0
    np.testing.assert_array_equal(T.hsv_to_rgb(hsv), colors.hsv_to_rgb(hsv))
    with pytest.raises(ValueError):
        T.hsv_to_rgb(np.array([[0.5, 1.5, 0.5]]))


@pytest.mark.parametrize("shape", [(32, 48), (32, 48, 3), (1, 1), (7, 300, 3)])
def test_write_png_decodes_exactly(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


def test_read_png_refuses_other_pngs(tmp_path):
    # An 8-bit RGBA PNG is read (the general decoder, tests/test_torch_png.py)
    img = np.random.default_rng(3).integers(0, 256, (16, 16, 4), dtype=np.uint8)
    path = str(tmp_path / "rgba.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(image_io.read_png(path), img)
    path = str(tmp_path / "wide.png")
    imageio.imwrite(path, (np.arange(256, dtype=np.uint16) * 257).reshape(16, 16))
    with pytest.raises(ValueError, match="16-bit"):
        image_io.read_png(path)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(str(tmp_path / "not.png"))
    with pytest.raises(ValueError):
        image_io.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("shape,n", [((32, 48, 3), 3), ((32, 48), 2),
                                     ((240, 320, 3), 16)])
def test_write_gif_decodes_within_a_palette_step(tmp_path, shape, n):
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    path = str(tmp_path / "a.gif")
    image_io.write_gif(path, frames, 0.08)
    got = imageio.mimread(path)
    assert len(got) == n
    # Half a step of the 6x7x6 cube per channel: 25.5, 21.25, 25.5 levels.
    half_step = 255.0 / (2 * (np.array([6, 7, 6]) - 1))
    for g, f in zip(got, frames):
        assert g.shape[:2] == shape[:2]
        src = f if f.ndim == 3 else np.repeat(f[..., None], 3, -1)
        err = np.abs(g[..., :3].astype(float) - src)
        assert (err <= np.ceil(half_step)).all()
    from PIL import Image

    with Image.open(path) as im:
        assert im.info["duration"] == 80 and im.info["loop"] == 0


def test_trail_lines_clip_and_stay_on_their_segment():
    img = np.zeros((32, 48, 3), np.uint8)
    draw_line(img, (-1e9, 5.0), (1e9, 5.0), (255, 0, 0))
    assert (img[5, :, 0] == 255).all() and img[:5].max() == 0
    assert clip_segment(-5.0, -5.0, -1.0, -2.0, 48, 32) is None
    assert clip_segment(np.nan, 0.0, 3.0, 3.0, 48, 32) is None
    img[:] = 0
    a, b = np.array([3.2, 4.7]), np.array([40.1, 29.9])
    draw_line(img, a, b, (0, 255, 0))
    ys, xs = np.nonzero(img[..., 1])
    p = np.stack([xs, ys], -1).astype(float)
    t = np.clip((p - a) @ (b - a) / ((b - a) @ (b - a)), 0, 1)
    assert np.linalg.norm(p - (a + t[:, None] * (b - a)), axis=-1).max() <= 1.0
    assert img[5, 3, 1] == 255 and img[30, 40, 1] == 255


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_viewer_roundtrip(kind):
    """tests/test_viewer.py's round trip on the port's module; the torch
    render_fn returns a (3, H, W) tensor as the port's renderer does."""
    srv = viewer.ViewerServer("127.0.0.1", 0)
    port = srv.listener.getsockname()[1]
    got = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        msg = dict(
            resolution_x=8, resolution_y=6, train=True, keep_alive=True,
            scaling_modifier=1.25, shs_python=False, rot_scale_python=False,
            fov_y=0.8, fov_x=1.0, z_near=0.01, z_far=100.0,
            view_matrix=list(np.eye(4).flatten()),
            view_projection_matrix=list(np.eye(4).flatten()),
        )
        b = json.dumps(msg).encode()
        s.sendall(struct.pack("<I", len(b)) + b)
        need = 8 * 6 * 3
        buf = b""
        while len(buf) < need + 4:
            buf += s.recv(4096)
        got["frame"] = buf[:need]
        (vlen,) = struct.unpack("<I", buf[need:need + 4])
        while len(buf) < need + 4 + vlen:
            buf += s.recv(4096)
        got["verify"] = buf[need + 4:need + 4 + vlen].decode("ascii")
        s.close()

    t = threading.Thread(target=client)
    t.start()
    reqs = []

    def render(req):
        reqs.append(req)
        if kind == "numpy":
            return np.full((req.height, req.width, 3), 0.5)
        img = torch.full((3, req.height, req.width), 0.5)
        img[0] = 1.5  # clipped to 1
        return img

    deadline = time.time() + 5
    while srv.conn is None and time.time() < deadline:
        srv.poll()
        time.sleep(0.01)
    assert srv.serve_step(render, "/scene/path")
    t.join(timeout=5)
    assert not t.is_alive()
    srv.listener.close()

    assert got["verify"] == "/scene/path"
    want = bytes([127]) * (8 * 6 * 3) if kind == "numpy" else bytes(
        [255, 127, 127]) * (8 * 6)
    assert got["frame"] == want
    req = reqs[0]
    assert (req.width, req.height) == (8, 6)
    assert req.scaling_modifier == 1.25
    # SIBR -> ours column sign flips on the view matrix (y, z)
    np.testing.assert_array_equal(req.world_view, np.diag([1.0, -1.0, -1.0, 1.0]))
