"""Device selection shared by the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and there is
    none, so nothing carries on quietly on the CPU; the CPU is used only
    when the caller passes ``device="cpu"``. On the card, fp32 matmuls and
    convolutions are pinned to full fp32 (no TF32), which is the JAX
    package's precision.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(device, *tensors: torch.Tensor) -> torch.device:
    """Resolve ``device`` and require every given tensor to lie on it."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(
                f"tensor on {t.device} but the call runs on {dev}; move the "
                "inputs or pass the matching device"
            )
    return dev


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]
