"""Training and evaluation losses (utils/loss_utils.py, utils/image_utils.py).

Port of ``gftorf_tpu/train/losses.py``. SSIM uses the standard 11x11
Gaussian window (sigma 1.5) with zero same-padding, in either of the JAX
package's two lowerings, chosen by the caller: ``"banded"`` (the default:
two products with banded window matrices) or ``"conv"`` (two 1-D
depthwise convolutions). The JAX package reads ``GFTORF_SSIM_IMPL`` at
import; the port takes the lowering as an argument (``ssim_impl``), which
the training step carries in its static configuration.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SSIM_IMPLS = ("banded", "conv")


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


def weighted_l1_loss(pred, gt, w, num_phasor_channels):
    """Amplitude-normalized phasor L1 (loss_utils.py:23-25): the weight is
    the norm over all channels of the prediction (detached)."""
    weight = w + torch.sqrt((pred ** 2).sum(0)).detach()
    n = num_phasor_channels
    return ((pred[:n] - gt[:n]) / weight).abs().mean()


def weighted_l1_loss_quad(pred, gt, w):
    weight = w + pred.detach().abs()
    return ((pred - gt) / weight).abs().mean()


def weighted_l2_loss_quad(pred, gt, w):
    weight = w + pred.detach().abs()
    return (((pred - gt) / weight) ** 2).mean()


def psnr(pred, gt):
    """PSNR over the whole image (image_utils.py:17-19)."""
    mse = ((pred - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.cache
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma**2)
    )
    return (g / g.sum()).astype(np.float32)


def _band(n: int, w1: torch.Tensor) -> torch.Tensor:
    """(n, n) banded matrix whose product is the zero-padded 1-D window."""
    window = w1.shape[0]
    idx = torch.arange(n, device=w1.device)
    off = idx[:, None] - idx[None, :] + window // 2  # (out, in) tap index
    inside = (off >= 0) & (off < window)
    return torch.where(inside, w1[torch.where(inside, off, 0)], 0.0)


def ssim(img1, img2, window_size: int = 11, impl: str = "banded"):
    """Mean SSIM over a (C, H, W) image pair."""
    if impl not in SSIM_IMPLS:
        raise ValueError(f"ssim impl {impl!r}: one of {SSIM_IMPLS}")
    w1 = torch.tensor(_gaussian_1d(window_size), device=img1.device)
    pad = window_size // 2
    c, h, w = img1.shape

    if impl == "conv":
        kh = w1[None, None, :, None].expand(c, 1, window_size, 1)
        kw = w1[None, None, None, :].expand(c, 1, 1, window_size)

        def conv(x):
            y = F.conv2d(x[None], kh, padding=(pad, 0), groups=c)
            return F.conv2d(y, kw, padding=(0, pad), groups=c)[0]
    else:
        bh, bw = _band(h, w1), _band(w, w1)

        def conv(x):
            y = torch.einsum("ij,cjw->ciw", bh, x)
            return torch.einsum("kw,ciw->cik", bw, y)

    return _ssim_from_window_sums(img1, img2, conv)


def _ssim_from_window_sums(img1, img2, conv):
    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return ssim_map.mean()
