"""The control's precision: every float32 matrix product in TF32.

On an H100 with ``allow_tf32`` a float32 GEMM rounds its inputs to TF32
(an 8-bit exponent and a 10-bit mantissa) and accumulates in float32.
``tf32_matmuls`` does the same to every matrix product that the code under
it dispatches, forward and backward, on any device: each float32 input of
``mm``, ``addmm``, ``bmm`` and ``baddbmm`` is rounded to the nearest TF32
value (ties to even) before the product."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ATEN = torch.ops.aten
# Each product's factors (the bias of addmm and baddbmm is added in float32).
_FACTORS = {_ATEN.mm.default: (0, 1), _ATEN.bmm.default: (0, 1),
            _ATEN.addmm.default: (1, 2), _ATEN.baddbmm.default: (1, 2)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


class tf32_matmuls(TorchDispatchMode):
    """A dispatch mode under which float32 matrix products take TF32
    inputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        factors = _FACTORS.get(func, ())
        args = tuple(round_tf32(a) if i in factors and a.dtype == torch.float32
                     else a for i, a in enumerate(args))
        return func(*args, **kwargs)
