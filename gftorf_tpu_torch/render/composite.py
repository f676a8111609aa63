"""Compositing constants and the tile-to-image layout.

Port of the shared parts of ``gftorf_tpu/render/composite.py``: the
reference's blend thresholds (forward.cu:539-546) and the (T, PIX, ch)
tile-major to (ch, H, W) image reshuffle. The compositor itself lives in
``render/kernels/dense.py``.
"""

from __future__ import annotations

import torch

from gftorf_tpu_torch.render.settings import RasterConfig

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4


def tiles_to_image(tile_img: torch.Tensor, config: RasterConfig) -> torch.Tensor:
    """(T, PIX[, ch]) tile-major pixels -> (ch, H, W) image."""
    if tile_img.ndim == 2:
        tile_img = tile_img[..., None]
    ch = tile_img.shape[-1]
    gw, gh = config.grid_w, config.grid_h
    th, tw = config.tile_h, config.tile_w
    img = (
        tile_img.reshape(gh, gw, th, tw, ch)
        .permute(4, 0, 2, 1, 3)
        .reshape(ch, gh * th, gw * tw)
    )
    return img[:, : config.height, : config.width]
