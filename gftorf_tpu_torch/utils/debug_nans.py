"""The train CLI's ``--debug_nans``: raise at the first operation that
makes a NaN, forward or backward.

The counterpart of ``jax_debug_nans`` (``train.py:106-109``), which
re-runs a jitted program op by op once its output holds a NaN and raises
``FloatingPointError`` at the primitive that made it. Here every operation
runs eagerly, so each is checked as it runs:

- a ``TorchDispatchMode`` looks at the floating outputs of every aten op
  and raises ``FloatingPointError`` naming the op; ops that allocate
  without writing (``empty*``, ``new_empty*``) and non-blocking copies
  (written after the op returns, from a source already checked) are
  skipped;
- the kernel wrappers (``render/kernels/dense.py``, ``flat.py``) check
  their outputs right after each launch while ``active()``: a kernel
  launched through ctypes writes memory the dispatcher never sees;
- autograd's anomaly mode (``check_nan=True``) checks every backward
  function's outputs, whichever thread runs the backward; its NaN error is
  raised as a ``FloatingPointError`` too.

As in JAX the check is for NaN, not inf. The switch changes no result: the
ops run as they would without it, and only read their outputs. Each check
waits for the device, so a run is slow: for debugging only.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Ops whose outputs are uninitialised memory until something writes them.
UNWRITTEN_PREFIXES = ("empty", "new_empty")
# How anomaly mode words a backward function's NaN output.
ANOMALY_NAN = "returned nan values"

_depth = 0


def active() -> bool:
    """True inside ``nan_checks()`` (in any thread)."""
    return _depth > 0


def check_output(what: str, *tensors) -> None:
    """Raise ``FloatingPointError`` naming ``what`` if a floating tensor of
    ``tensors`` holds a NaN; does nothing outside ``nan_checks()``."""
    if _depth and _has_nan(tensors):
        raise FloatingPointError(f"NaN in the output of {what}")


def _has_nan(outputs) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type != "meta"
               and (t.is_floating_point() or t.is_complex())
               and bool(torch.isnan(t).any())
               for t in tree_leaves(outputs))


def _non_blocking(func, args, kwargs) -> bool:
    """A non-blocking copy, whose output is written after the op returns
    (the Trainer's metrics to pinned memory): its source was checked when
    an op made it."""
    if func.overloadpacket is torch.ops.aten.copy_:
        return bool(kwargs.get("non_blocking", len(args) > 2 and args[2]))
    if func.overloadpacket is torch.ops.aten._to_copy:
        return bool(kwargs.get("non_blocking", False))
    return False


class NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first aten op whose floating
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (not func.__name__.startswith(UNWRITTEN_PREFIXES)
                and not _non_blocking(func, args, kwargs) and _has_nan(out)):
            raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_checks():
    """Check every op, kernel launch and backward function run inside the
    block for NaN outputs (module docstring)."""
    global _depth
    anomaly = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    _depth += 1
    try:
        with NanCheckMode():
            yield
    except RuntimeError as e:
        if ANOMALY_NAN in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        _depth -= 1
        torch.autograd.set_detect_anomaly(*anomaly)
