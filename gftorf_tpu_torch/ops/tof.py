"""Continuous-wave time-of-flight phasor math.

Port of ``gftorf_tpu/ops/tof.py``. The rasterizer composites 7 channels
per Gaussian (forward.cu:361-407):

    phase  = dist_to_light * (4*pi / depth_range) + phase_offset
             (+ view-dependent phase from SH, optional)
    factor = 1 / dist_to_light^2
    [cos(p)*A*f, sin(p)*A*f, A*f,
     (cos(p)+dc)*A*f, (-cos(p)+dc)*A*f, (sin(p)+dc)*A*f, (-sin(p)+dc)*A*f]

``depth_from_tof`` inverts a composited phasor back to depth
(scene/torf_utils.py:53-64).
"""

from __future__ import annotations

import math

import torch

TOF_PHASOR_CHANNELS = 7  # real, imag, amp, quad cos, -cos, sin, -sin


def dist_to_phase_scale(depth_range):
    """Phase per unit distance: 4*pi/depth_range (forward.cu:752)."""
    return 4.0 * math.pi / depth_range


def phasor_channels(dist_to_light, phase_sh, amplitude, depth_range,
                    phase_offset, dc_offset,
                    use_view_dependent_phase: bool) -> torch.Tensor:
    """Per-Gaussian (..., 7) ToF phasor features, with the 1/d^2 falloff.

    Args:
        dist_to_light: (...,) distance to the co-located light/sensor.
        phase_sh: (...,) view-dependent phase from SH (DC removed).
        amplitude: (...,) non-negative amplitude from SH.
        depth_range / phase_offset / dc_offset: scalars.
    """
    phase = dist_to_light * dist_to_phase_scale(depth_range) + phase_offset
    if use_view_dependent_phase:
        phase = phase + phase_sh
    factor = 1.0 / (dist_to_light * dist_to_light)
    af = amplitude * factor
    c = torch.cos(phase)
    s = torch.sin(phase)
    return torch.stack(
        [
            c * af,
            s * af,
            af * torch.ones_like(c),
            (c + dc_offset) * af,
            (-c + dc_offset) * af,
            (s + dc_offset) * af,
            (-s + dc_offset) * af,
        ],
        dim=-1,
    )


def depth_from_tof(tof: torch.Tensor, depth_range, phase_offset=0.0) -> torch.Tensor:
    """Depth from a channel-last (..., C>=2) phasor with real/imag in
    channels 0/1, including the 2*pi wrap of negative phases
    (torf_utils.py:53-64)."""
    real = torch.where(tof[..., 0].abs() < 1e-6,
                       torch.full_like(tof[..., 0], 1e-6), tof[..., 0])
    phase = torch.atan2(tof[..., 1], real) - phase_offset
    phase = torch.where(phase < 0.0, phase + 2.0 * math.pi, phase)
    return (phase / (4.0 * math.pi)) * depth_range


def tof_from_depth(depth, amp, depth_range, phase_offset=0.0) -> torch.Tensor:
    """Synthesize a (..., 3) real/imag/amp phasor image from depth and
    amplitude (torf_utils.py:66-69)."""
    depth = torch.as_tensor(depth)
    phase = depth * (4.0 * math.pi / depth_range) + phase_offset
    amp = torch.as_tensor(amp, dtype=phase.dtype, device=phase.device)
    return torch.stack([amp * torch.cos(phase), amp * torch.sin(phase),
                        amp * torch.ones_like(phase)], dim=-1)
