"""Host-side learning-rate schedules and per-iteration hyper assembly.

Port of ``gftorf_tpu/train/schedule.py``: get_expon_lr_func
(utils/general_utils.py:41-75) and the per-group schedule wiring of
GaussianModel.training_setup / update_learning_rate
(scene/gaussian_model.py:247-313). The reference overwrites the dc and
rest lrs of the phase/amp groups with the same scheduled value each
iteration (:300-307), so only the color features keep the rest/20 rule.
The training step evaluates the same schedules itself
(``train/step.py::_gaussian_lrs_at``); these are the host's copies.
"""

from __future__ import annotations

import math

import numpy as np

from gftorf_tpu_torch.config import OptimizationParams
from gftorf_tpu_torch.models.gaussians import GaussianParams


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000):
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay_rate = 1.0
    ms = max_steps if max_steps != 0 else 1
    t = min(max(step / ms, 0.0), 1.0)
    return delay_rate * math.exp(
        math.log(lr_init) * (1 - t) + math.log(lr_final) * t
    ) if lr_init > 0 or lr_final > 0 else 0.0


def build_gaussian_lrs(
    opt: OptimizationParams,
    iteration: int,
    scene_extent: float,
    sh_degree: int,
    isotropic: bool,
) -> GaussianParams:
    """Per-leaf learning rates for the single fused Adam (floats, and an
    (M, 1) array for the SH color coefficients)."""
    m = (sh_degree + 1) ** 2
    ext = scene_extent

    xyz_lr = expon_lr(
        iteration, opt.position_lr_init * ext, opt.position_lr_final * ext,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    phase_lr = expon_lr(
        iteration, opt.feature_phase_lr_init * ext,
        opt.feature_phase_lr_final * ext,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    amp_lr = expon_lr(
        iteration, opt.feature_amp_lr_init * ext**2, opt.feature_amp_lr_final,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    # Color: DC at feature_lr, rest at /20 (gaussian_model.py:252-253).
    color_lr = np.full((m, 1), opt.feature_lr / 20.0, np.float32)
    color_lr[0, 0] = opt.feature_lr

    rotation_lr = 0.0 if isotropic else opt.rotation_lr

    if iteration > opt.optimize_offset_start:
        po_lr, dc_lr = opt.phase_offset_lr, opt.dc_offset_lr
    else:
        po_lr, dc_lr = 0.0, 0.0

    return GaussianParams(
        xyz=xyz_lr,
        sh_color=color_lr,
        sh_phase=phase_lr,
        sh_amp=amp_lr,
        scaling=opt.scaling_lr,
        rotation=rotation_lr,
        opacity=opt.opacity_lr,
        seg_color=0.0,
        phase_offset=po_lr,
        dc_offset=dc_lr,
    )


def deform_lr_at(opt: OptimizationParams, iteration: int) -> float:
    """Deform schedule is stepped with (iteration - warm_up)
    (train.py:147, deform_model.py:30-33)."""
    return expon_lr(
        iteration - opt.warm_up, opt.deform_lr_init, opt.deform_lr_final,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps - opt.warm_up,
    )
