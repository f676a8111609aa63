"""One training step of the port against one of the JAX package: ToRF,
frozen Gaussians and the deform pause.

The comparison and its tolerances are those of
tests/test_torch_train_step.py (see tests/torch_port_util.py). Cases:

 - a two-camera ToRF step (color 64x48 with 16x32 tiles, ToF 48x32 with
   16x16 tiles, two phasor channels) on a shuffled row layout, so that
   both compactions are the gather/scatter buckets; the color, ToF, depth,
   depth-distortion, opacity-entropy and scale terms are all on, and the
   ToF render carries the dd channel through both kernels' gates;
 - the same static at an iteration inside the 200-iteration deform pause
   after an opacity reset, where the deform Adam step is skipped;
 - frozen Gaussians (past densify_until_iter): only the deform MLP
   trains, the Gaussian state passes through, and the flow channels are
   gated at run time (flow_frame None) on an integration frame.
"""

import numpy as np
import pytest

from gftorf_tpu_torch.train.step import (
    METRIC_NAMES,
    _deform_lr_at,
    _gaussian_lrs_at,
)
from torch_port_util import (
    assert_step_matches,
    frame_pair,
    run_step_pair,
    statics,
    train_state_arrays,
)

DEPTH, WIDTH = 2, 32
SCHED = dict(
    warm_up=2000, flow_start=2000, tof_iters=2000, opacity_reset_interval=3000,
    densify_until_iter=15000, position_lr_init=1.6e-4, position_lr_final=1.6e-6,
    deform_lr_init=8e-4, deform_lr_final=1.6e-6, scaling_lr=0.001,
    dd_window=(0, 20000), oe_window=(2000, 20000), scale_window=(0, 20000),
    weights=dict(color=0.0, tof=1.0, dssim=0.2, depth=0.1, dd=0.05, flow=0.5,
                 oe=0.01, scale=0.1, mlp_reg=0.0),
)


def _torf_static():
    rc = dict(width=64, height=48, tile_h=16, tile_w=32, max_per_tile=512,
              need_dd=False, need_distribution=False)
    rt = dict(width=48, height=32, tile_h=16, tile_w=16, max_per_tile=512,
              need_dd=True, need_distribution=False)
    return statics(
        "torf", rc, rt, DEPTH, WIDTH, sched=SCHED, render_regions=("dynamic",),
        num_phasor_channels=2, color_on=True, depth_on=True, dd_on=True,
        oe_on=True, scale_on=True, deform_clip=0.5, scene_extent=2.0,
        bg_color=(0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2),
        compact_layout=False, render_bucket=320, deform_bucket=192,
    )


@pytest.mark.parametrize("it", [2101, 3100], ids=["step", "deform_pause"])
def test_torf_two_camera_step_matches_jax(it):
    jstatic, tstatic = _torf_static()
    arrays = train_state_arrays(9, 300, 400, DEPTH, WIDTH, sorted_layout=False)
    pairs = [frame_pair(40 + fid, fid, (64, 48), (48, 32), (fid, fid + 50))
             for fid in (3, 5)]
    jout, tout = run_step_pair(jstatic, tstatic, arrays, pairs, 1, it)
    _, tm = assert_step_matches(jout, tout, _gaussian_lrs_at(tstatic, it),
                                _deform_lr_at(tstatic, it))
    m = dict(zip(METRIC_NAMES, tm))
    assert m["loss"] > 0 and m["l1_color"] > 0 and m["compact_overflow"] == 0
    model, deform, deform_adam, _ = tout
    assert float(model.adam.mu.sh_color.abs().max()) > 0
    paused = it == 3100  # 3100 % (3000 // 2) <= 200
    assert int(deform_adam.step) == (0 if paused else 1)
    assert (float(deform_adam.mu["heads.xyz.weight"].abs().max()) > 0) != paused


def test_frozen_gaussians_train_the_deform_mlp_only():
    rc = dict(width=64, height=48, tile_h=16, tile_w=32, max_per_tile=512,
              need_dd=False, need_distribution=False)
    sched = dict(SCHED, densify_until_iter=2050, tof_iters=2_000_000)
    jstatic, tstatic = statics(
        "ftorf", rc, rc, DEPTH, WIDTH, sched=sched, single_camera=True,
        use_quad=True, color_on=False, flow_on=True, flow_frame=None,
        frozen_gauss=True, compact_layout=True, render_bucket=320,
        deform_bucket=160, tof_inverse_permutation=(1, 2, 3, 0),
    )
    arrays = train_state_arrays(13, 300, 384, DEPTH, WIDTH)
    pairs = [frame_pair(60 + fid, fid, (64, 48), (64, 48), (fid, fid), flow=True)
             for fid in (4, 5)]
    jout, tout = run_step_pair(jstatic, tstatic, arrays, pairs, 0, 2101)
    _, tm = assert_step_matches(jout, tout, _gaussian_lrs_at(tstatic, 2101),
                                _deform_lr_at(tstatic, 2101))
    assert dict(zip(METRIC_NAMES, tm))["flow_l2"] > 0
    model, _, deform_adam, _ = tout
    np.testing.assert_array_equal(model.params.xyz.numpy(), arrays["params"]["xyz"])
    assert int(model.adam.step) == 0 and int(deform_adam.step) == 1
    assert float(deform_adam.mu["heads.xyz.weight"].abs().max()) > 0
