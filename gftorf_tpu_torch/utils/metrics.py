"""Image-quality metrics: PSNR, SSIM, LPIPS (the lpipsPyTorch formulation).

Port of ``gftorf_tpu/utils/metrics.py``. LPIPS needs pretrained AlexNet
features, which are not downloaded here: ``lpips()`` loads them from a
local npz (``GFTORF_LPIPS_WEIGHTS`` or ``weights_path``; the layout of
tools/convert_lpips_weights.py: ``conv{i}_w/b`` and ``lin{i}_w``), and the
evaluation reports ``lpips: null`` without one. The arithmetic is the
standard LPIPS: AlexNet trunk, per-channel unit normalization, 1x1 linear
heads, spatial mean.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from gftorf_tpu_torch.train.losses import psnr, ssim  # noqa: F401 (re-export)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_PADS = (2, 2, 1, 1, 1)
_STRIDES = (4, 1, 1, 1, 1)
_POOLS = (True, True, False, False, False)


def _alexnet_features(x, params):
    """AlexNet feature trunk (5 relu stages) from packed weights."""
    feats = []
    for i in range(5):
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=_STRIDES[i], padding=_PADS[i]))
        feats.append(x)
        if _POOLS[i]:
            x = F.max_pool2d(x, 3, 2)
    return feats


def lpips_weights_path(weights_path: Optional[str] = None) -> Optional[str]:
    """The LPIPS weights npz, or None when there is none."""
    path = weights_path or os.environ.get("GFTORF_LPIPS_WEIGHTS", "")
    return path if path and os.path.exists(path) else None


def lpips_available(weights_path: Optional[str] = None) -> bool:
    return lpips_weights_path(weights_path) is not None


def lpips(img1: torch.Tensor, img2: torch.Tensor,
          weights_path: Optional[str] = None) -> torch.Tensor:
    """LPIPS distance between (3, H, W) images in [0, 1], on their device."""
    path = lpips_weights_path(weights_path)
    if path is None:
        raise FileNotFoundError(
            "LPIPS needs pretrained feature weights; convert them with "
            "tools/convert_lpips_weights.py and set GFTORF_LPIPS_WEIGHTS")
    dev = img1.device
    with np.load(path) as data:
        params = {k: torch.as_tensor(data[k], dtype=torch.float32, device=dev)
                  for k in data.files}
    shift = torch.tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=dev)[None, :, None, None]

    def norm_input(img):
        return (img[None] * 2.0 - 1.0 - shift) / scale

    total = torch.zeros((), device=dev)
    for i, (a, b) in enumerate(zip(_alexnet_features(norm_input(img1), params),
                                   _alexnet_features(norm_input(img2), params))):
        a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(min=1e-10)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(min=1e-10)
        total = total + ((a - b) ** 2 * params[f"lin{i}_w"]).sum(1).mean()
    return total
