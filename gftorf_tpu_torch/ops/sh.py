"""Real spherical-harmonics evaluation (degrees 0..4).

Port of ``gftorf_tpu/ops/sh.py``: the reference's hardcoded real-SH
polynomials (utils/sh_utils.py:57-124, forward.cu:20-125) with the usual
3DGS sign conventions; the caller adds the +0.5 offset.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions: (..., 3) -> (..., (degree+1)**2)."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree > 3:
        out += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate (..., C, M) SH coefficients at (..., 3) unit directions;
    returns (..., C) with no +0.5 offset and no clamping."""
    basis = sh_basis(degree, dirs)
    k = num_sh_coeffs(degree)
    return (sh[..., :k] @ basis[..., None])[..., 0]


def rgb2sh(rgb):
    return (rgb - 0.5) / SH_C0


def sh2rgb(sh):
    return sh * SH_C0 + 0.5


# Phase/amplitude use the same affine packing as RGB in the reference.
def pa2sh(pa):
    return (pa - 0.5) / SH_C0


def sh2pa(sh):
    return sh * SH_C0 + 0.5
