"""Evaluation losses (utils/loss_utils.py, utils/image_utils.py).

Port of ``l1_loss``, ``l2_loss`` and ``psnr`` from
``gftorf_tpu/train/losses.py``; the weighted losses and SSIM come with
the training slice.
"""

from __future__ import annotations

import torch


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


def psnr(pred, gt):
    """PSNR over the whole image (image_utils.py:17-19)."""
    mse = ((pred - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
