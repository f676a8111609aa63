"""Comparison video panels: per-channel rows of annotated clips
(Input | Ours | Spiral | FreezeFrameSpiral), the website panel and the
quad-cadence staircase panel.

Port of ``gftorf_tpu/video_panel.py`` (the reference's moviepy panels,
render.py:226-285 and render_ftorf_viz_traj.py:409-680) in numpy alone:
the layout, margins, strip heights, looping and frame counts are the JAX
package's; labels and captions are drawn with the 5x7 bitmap font below
in place of ``cv2.putText``, and clips are read and panels written by
``utils/image_io.py`` (an mp4 where imageio and ffmpeg import, else a GIF).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from gftorf_tpu_torch.utils.image_io import read_png, write_video

_LABEL_H = 16
_MARGIN = 6

# The classic 5x7 font, printable ASCII from " " to "~": five column
# bytes a glyph, bit 0 the top row.
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "0c5252523e" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "08082a1c08")
_GLYPH_W, _GLYPH_H, _ADVANCE = 5, 7, 6


def _glyph(ch: str) -> np.ndarray:
    """(7, 5) bool mask of one character (unknown characters as '?')."""
    code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
    cols = np.frombuffer(_FONT, np.uint8)[5 * (code - 32):5 * (code - 31)]
    return ((cols[None, :] >> np.arange(_GLYPH_H)[:, None]) & 1).astype(bool)


def text_size(text: str):
    """(width, height) in pixels of ``text`` in the bitmap font."""
    return max(len(text) * _ADVANCE - 1, 0), _GLYPH_H


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """Draw ``text`` into the (H, W, 3) uint8 ``img`` in place, with its
    baseline (the row under the glyphs) at ``org = (x, y)``, as
    ``cv2.putText`` places text; clipped at the image's edges."""
    x0, y = org
    h, w = img.shape[:2]
    for k, ch in enumerate(text):
        ys, xs = np.nonzero(_glyph(ch))
        ys, xs = ys + y - _GLYPH_H, xs + x0 + k * _ADVANCE
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color


def _annotate(img: np.ndarray, label: str) -> np.ndarray:
    """White margin + label strip above the clip (the reference's
    moviepy margin + TextClip overlay, render_ftorf_viz_traj.py:409-477:
    top margin 22 with an annotation, plain 10px margins without)."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w = img.shape[:2]
    top = _LABEL_H + _MARGIN if label else _MARGIN
    out = np.full((h + top + _MARGIN, w + 2 * _MARGIN, 3), 255, np.uint8)
    out[top:top + h, _MARGIN:_MARGIN + w] = img
    if label:
        put_text(out, label, (_MARGIN, _LABEL_H - 2), (0, 0, 0))
    return out


def _load_clip(folder: str) -> Optional[List[np.ndarray]]:
    if not os.path.isdir(folder):
        return None
    files = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    if not files:
        return None
    return [read_png(os.path.join(folder, f)) for f in files]


def _placeholder(shape, label):
    img = np.full(shape, 230, np.uint8)
    put_text(img, label, (4, shape[0] // 2), (90, 90, 90))
    return img


def _bordered_placeholder(h, w, lines):
    """White tile with a 2px gray border and centered gray caption
    line(s) — the reference's 'Unknown' / 'N of 4' + 'quads acquired'
    placeholder cells (render_ftorf_viz_traj.py:426-452, twoRows)."""
    img = np.full((h, w, 3), 255, np.uint8)
    img[:2, :] = img[-2:, :] = 128
    img[:, :2] = img[:, -2:] = 128
    n = len(lines)
    for i, text in enumerate(lines):
        tw, th = text_size(text)
        y = h // 2 + int((i - (n - 1) / 2) * (th + 8)) + th // 2
        put_text(img, text, (max((w - tw) // 2, 2), y), (150, 150, 150))
    return img


def _vline_cell(height, width=10, line_width=3):
    """A white column with a black vertical separator line, the
    reference's get_vline (render_ftorf_viz_traj.py:479-486)."""
    img = np.full((height, width, 3), 255, np.uint8)
    x0 = (width - line_width) // 2
    img[:, x0:x0 + line_width] = 0
    return img


def draw_down_arrow(img: np.ndarray, x: int, top: int, tip: int) -> None:
    """A black downward arrow in place: a 2-pixel shaft from ``top`` to
    ``tip`` and a head of two 45-degree strokes 12 pixels long (the JAX
    package's cv2.arrowedLine with a 12-pixel tip)."""
    img[top:tip + 1, x - 1:x + 1] = 0
    for k in range(int(12 / np.sqrt(2)) + 1):
        if tip - k >= top:
            img[tip - k, [x - 1 - k, x - k, x - 1 + k, x + k]] = 0


def _time_axis_strip(panel_h, row_h, labels, width=72):
    """Left-hand time-axis strip: 'Time' caption, a downward arrow, and
    one label per row — the reference's draw_time_axis_as_image /
    make_time_axis_video (render_ftorf_viz_traj.py:488-521)."""
    img = np.full((panel_h, width, 3), 255, np.uint8)
    put_text(img, "Time", (2, 14), (0, 0, 0))
    draw_down_arrow(img, int(width * 0.8), 6, panel_h - 6)
    for i, label in enumerate(labels):
        y = int((i + 0.5) * row_h)
        put_text(img, label, (2, y + 4), (0, 0, 0))
    return img


def create_website_panel(model_path: str, iteration: int,
                         traj_dir: Optional[str] = None,
                         fps: float = 10.0) -> Optional[str]:
    """The paper/website comparison panel (render_ftorf_viz_traj.py:
    528-600): [C-ToF input depth | baseline methods | Ours 4x-interp
    depth | Ours 3D-trajectory overlay]. Baseline clips are read from
    model_path/baselines/<name>/ when present (PNGs as ``image_io``
    writes them), else placeholder tiles — the reference hard-codes paths
    to TöRF/F-TöRF/DeformableGS renders that only exist after running
    those codebases."""
    traj_dir = traj_dir or os.path.join(model_path, f"traj_{iteration}")
    cells = [
        (os.path.join(model_path, "input", "depth"), "C-ToF"),
        (os.path.join(model_path, "baselines", "torf"), "ToRF"),
        (os.path.join(model_path, "baselines", "ftorf"), "F-ToRF"),
        (os.path.join(traj_dir, "depth_quad"), "Ours (4x interp)"),
        (os.path.join(traj_dir, "traj"), "Ours (3D trajectories)"),
    ]
    clips, n_frames, shape = [], 0, None
    for folder, label in cells:
        clip = _load_clip(folder)
        if clip:
            clip = [_annotate(f, label) for f in clip]
            n_frames = max(n_frames, len(clip))
            shape = clip[0].shape
        clips.append((clip, label))
    if n_frames == 0:
        return None
    frames = []
    for t in range(n_frames):
        row = []
        for i, (clip, label) in enumerate(clips):
            if i == 3:
                # Separator between the input/baseline group and the
                # Ours group (render_ftorf_viz_traj.py:563-566).
                row.append(_vline_cell(shape[0]))
            if clip:
                row.append(clip[t % len(clip)])
            else:
                row.append(_placeholder(shape, f"{label}: n/a"))
        h = max(r.shape[0] for r in row)
        row = [np.pad(r, ((0, h - r.shape[0]), (0, 0), (0, 0)),
                      constant_values=255) for r in row]
        frames.append(np.concatenate(row, axis=1))
    out = write_video(
        os.path.join(model_path, f"iteration_{iteration}_website_panel"),
        frames, fps,
    )
    print(f"[website_panel]: {out}")
    return out


_QUAD_NAMES = ["0", "pi/2", "pi", "3pi/2"]


def create_quad_cadence_panel(model_path: str, iteration: int,
                              traj_dir: Optional[str] = None,
                              fps: float = 2.5) -> Optional[str]:
    """The raw-quads staircase panel (render_ftorf_viz_traj.py:592-680):
    4 rows, one per quad slot. Row k shows the GT quad captured at slot
    k on the diagonal of a 4-column group ('Unknown' bordered
    placeholders elsewhere — only one quad type is acquired per frame),
    a 'k+1 of 4 / quads acquired' cell, a vertical separator, then the
    rendered quad and depth for that slot. A time-axis strip with per-row
    labels runs down the left (:488-521). Captions annotate row 1 only,
    like the reference's font_size=20 header row.
    """
    traj_dir = traj_dir or os.path.join(model_path, f"traj_{iteration}")

    gt_clips = [_load_clip(os.path.join(model_path, "input", f"quad_q{k}"))
                for k in range(4)]
    ren_clips = [_load_clip(os.path.join(traj_dir, f"quad_q{k}"))
                 for k in range(4)]
    dep_clips = [_load_clip(os.path.join(traj_dir, f"depth_q{k}"))
                 for k in range(4)]
    have = [c for c in gt_clips + ren_clips + dep_clips if c]
    if not have:
        return None
    h, w = have[0][0].shape[:2]
    n_frames = max(len(c) for c in have)

    rows = []
    for k in range(4):
        first = k == 0
        cells = []
        # GT group: captured quad on the diagonal, Unknown elsewhere.
        for q in range(4):
            label = f"Quad {_QUAD_NAMES[q]}" if first else ""
            if q == k and gt_clips[k]:
                cells.append((gt_clips[k], label, None))
            else:
                cells.append((None, label, ["Unknown"]))
        cells.append((None, "C-ToF Depth" if first else "",
                      [f"{k + 1} of 4", "quads acquired"]))
        cells.append("vline")
        cells.append((ren_clips[k],
                      f"Ours (Rendered Quad {_QUAD_NAMES[k]})"
                      if first else "", ["n/a"]))
        cells.append((dep_clips[k], "Ours (Depth)" if first else "",
                      ["n/a"]))
        rows.append(cells)

    panel_frames = []
    for t in range(n_frames):
        row_imgs = []
        for cells in rows:
            imgs = []
            for cell in cells:
                if cell == "vline":
                    imgs.append(None)  # sized after the row height known
                    continue
                clip, label, ph_lines = cell
                if clip:
                    img = clip[t % len(clip)]
                    if img.shape[:2] != (h, w):
                        img = np.asarray(img)[:h, :w]
                else:
                    img = _bordered_placeholder(h, w, ph_lines)
                imgs.append(_annotate(img, label))
            rh = max(i.shape[0] for i in imgs if i is not None)
            imgs = [_vline_cell(rh) if i is None else np.pad(
                i, ((0, rh - i.shape[0]), (0, 0), (0, 0)),
                constant_values=255) for i in imgs]
            row_imgs.append(np.concatenate(imgs, axis=1))
        wmax = max(r.shape[1] for r in row_imgs)
        row_imgs = [np.pad(r, ((0, 0), (0, wmax - r.shape[1]), (0, 0)),
                           constant_values=255) for r in row_imgs]
        body = np.concatenate(row_imgs, axis=0)
        axis = _time_axis_strip(body.shape[0], row_imgs[0].shape[0],
                                [f"t{k}" for k in range(4)])
        panel_frames.append(np.concatenate([axis, body], axis=1))

    out = write_video(
        os.path.join(model_path, f"iteration_{iteration}_quad_panel"),
        panel_frames, fps,
    )
    print(f"[quad_panel]: {out}")
    return out


def create_video_panel(model_path: str, iteration: int, fps: float = 10.0,
                       input_folder: str = "input",
                       renders_base: Optional[str] = None,
                       scene_type: str = "torf") -> Optional[str]:
    """Compose the per-channel comparison grid across splits.

    Rows: one per channel (color/real/imag only for non-ftorf scenes,
    matching render.py:227-252). Columns: input GT, test renders, and
    for torf scenes the spiral + freeze-frame-spiral sweeps. Splits of
    different lengths loop (shorter clips repeat).
    """
    renders_base = renders_base or os.path.join(
        model_path, f"renders_{iteration}"
    )
    channels = ["depth", "depth_tof", "amp"]
    if scene_type != "ftorf":
        channels = ["color"] + channels + ["real", "imag"]

    columns = [(os.path.join(model_path, input_folder), "Input")]
    columns.append((os.path.join(renders_base, "test"), "Ours"))
    if scene_type == "torf":
        columns.append(
            (os.path.join(renders_base, "renders_spiral"), "Ours_Spiral")
        )
        columns.append(
            (os.path.join(renders_base, "freezeframe_spiral"),
             "Ours_FreezeFrame")
        )

    rows = []
    n_frames = 0
    for ch in channels:
        cells = []
        for folder, label in columns:
            clip = _load_clip(os.path.join(folder, ch))
            if clip:
                cells.append(([_annotate(f, f"{label}({ch})") for f in clip]))
                n_frames = max(n_frames, len(clip))
        if cells:
            rows.append(cells)
    if not rows or n_frames == 0:
        return None

    # Uniform cell size per row; stack rows vertically (white bg).
    panel_frames = []
    for t in range(n_frames):
        row_imgs = []
        for cells in rows:
            imgs = [c[t % len(c)] for c in cells]
            h = max(i.shape[0] for i in imgs)
            w = max(i.shape[1] for i in imgs)
            padded = []
            for i in imgs:
                p = np.full((h, w, 3), 255, np.uint8)
                p[: i.shape[0], : i.shape[1]] = i
                padded.append(p)
            row_imgs.append(np.concatenate(padded, axis=1))
        wmax = max(r.shape[1] for r in row_imgs)
        full = []
        for r in row_imgs:
            p = np.full((r.shape[0], wmax, 3), 255, np.uint8)
            p[:, : r.shape[1]] = r
            full.append(p)
        panel_frames.append(np.concatenate(full, axis=0))

    out = write_video(
        os.path.join(model_path, f"iteration_{iteration}_video_panel"),
        panel_frames, fps,
    )
    print(f"[video_panel]: {out}")
    return out
