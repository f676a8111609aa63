"""``gftorf_tpu_torch/utils/jpeg.py`` against PIL, bitwise, on JPEGs that
PIL writes here (Pillow with libjpeg-turbo); and a COLMAP scene of JPEGs
read by the port with PIL blocked against the JAX reader with PIL.
About 10 s in one process.

Images are a smooth pattern plus noise from a numpy seed, so every
block holds AC terms. Cases: 1x1, 7x5, 37x23 and 160x120 pixels at
qualities 10, 75 and 100 in 4:4:4, 4:2:2, 4:2:0 and greyscale (the 1x1 and
7x5 chroma planes are at most 2 samples wide, where libjpeg replicates in
place of its fancy upsampling); optimized Huffman tables; restart markers
every few MCUs and every MCU row; an EXIF APP1 segment. A progressive
file and a CMYK file must raise an error naming the file.

    PYTHONPATH=. python tests/test_torch_jpeg.py

prints the decode time of a 640x480 4:2:0 JPEG on the machine it runs on.
"""

import io
import os
import sys
import time

import numpy as np
import pytest
from PIL import Image

from gftorf_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg

SIZES = [(1, 1), (7, 5), (37, 23), (160, 120)]
QUALITIES = [10, 75, 100]
# (PIL mode, Pillow's subsampling: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0)
MODES = {"444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2),
         "grey": ("L", None)}


def sample_image(width, height, mode, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = np.stack([128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0),
                     128 + 80 * np.sin((xx + yy) / 11.0),
                     128 + 60 * np.cos(xx / 5.0)], -1)
    a = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(a if mode == "RGB" else a[..., 0], mode)


def jpeg_bytes(width, height, mode_key, **kw):
    mode, sub = MODES[mode_key]
    if sub is not None:
        kw["subsampling"] = sub
    buf = io.BytesIO()
    sample_image(width, height, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_decodes_as_pil(data):
    ref = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode_key", list(MODES))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_baseline_matches_pil(size, quality, mode_key):
    assert_decodes_as_pil(jpeg_bytes(*size, mode_key, quality=quality))


@pytest.mark.parametrize("mode_key", list(MODES))
@pytest.mark.parametrize("option", [
    {"optimize": True},
    {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1},
    {"exif": b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00"},
], ids=["optimize", "restart_blocks", "restart_rows", "exif"])
def test_options_match_pil(option, mode_key):
    data = jpeg_bytes(37, 23, mode_key, quality=75, **option)
    if "restart_marker_blocks" in option or "restart_marker_rows" in option:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0
    if "exif" in option:
        assert b"\xff\xe1" in data
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("what", ["progressive", "cmyk"])
def test_unsupported_raises_naming_file(tmp_path, what):
    path = str(tmp_path / f"{what}.jpg")
    img = sample_image(37, 23, "RGB")
    if what == "progressive":
        img.save(path, "JPEG", progressive=True)
        match = "progressive"
    else:
        img.convert("CMYK").save(path, "JPEG")
        match = "4 components"
    with pytest.raises(ValueError, match=match) as err:
        read_jpeg(path)
    assert path in str(err.value)


def test_colmap_scene_of_jpegs_without_pil(tmp_path, monkeypatch):
    """A COLMAP model whose images are all JPEG (4:2:0, 4:2:2, 4:4:4):
    the port's reader with PIL unimportable gives the SceneData and frames
    of the JAX reader with PIL."""
    from gftorf_tpu.config import Config as JConfig
    from gftorf_tpu.data import readers as JR
    from gftorf_tpu.data import scene as JS
    from gftorf_tpu_torch.config import Config as TConfig
    from gftorf_tpu_torch.data import readers as TR
    from gftorf_tpu_torch.data import scene as TS
    from test_torch_data import assert_frames_equal, assert_scene_data_equal
    from test_torch_image_readers import color_only_args, write_colmap

    d = write_colmap(str(tmp_path / "colmap"))
    for i, sub in enumerate((2, 1, 0)):  # each view's PNG becomes a JPEG
        png = os.path.join(d, "images", f"view{i:02d}.png")
        Image.open(png).convert("RGB").save(png[:-4] + ".jpg", "JPEG",
                                            quality=90, subsampling=sub)
        os.remove(png)
    listing = os.path.join(d, "sparse", "0", "images.txt")
    with open(listing) as f:
        text = f.read().replace(".png", ".jpg")
    with open(listing, "w") as f:
        f.write(text)
    jargs, targs = color_only_args(d, eval=True)
    jd = JR.read_colmap_scene(d, jargs, eval_split=True, llffhold=2)
    for m in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, m, None)
    td = TR.read_colmap_scene(d, targs, eval_split=True, llffhold=2)
    ts = TS.Scene(TConfig(model=targs), load_data=td, init_model=False,
                  device="cpu")
    monkeypatch.undo()
    assert_scene_data_equal(td, jd)
    js = JS.Scene(JConfig(model=jargs), load_data=jd, init_model=False)
    assert_frames_equal(ts.train_frames, js.train_frames)
    assert_frames_equal(ts.test_frames, js.test_frames)


def decode_ms(fn, data, reps=5):
    fn(data)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(data)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


if __name__ == "__main__":
    data = jpeg_bytes(640, 480, "420", quality=75)
    port = decode_ms(decode_jpeg, data)
    pil = decode_ms(lambda b: np.asarray(Image.open(io.BytesIO(b))), data)
    print(f"640x480 4:2:0 quality 75 ({len(data)} bytes), median of 5: "
          f"utils/jpeg.py {port:.1f} ms, PIL {pil:.2f} ms")
