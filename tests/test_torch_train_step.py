"""One training step of the port against one of the JAX package: F-ToRF.

From the same state (numpy, from a seed), the same stacked frames and the
same iteration, ``gftorf_tpu.train.step.train_step`` (jitted, on the CPU,
its XLA compositor) and ``gftorf_tpu_torch.train.step.train_step`` (the
plain compositor on the CPU) must agree: the packed metrics at rtol 1e-5,
both Adam states (mu, the gradient, at atol 1e-4 * max|leaf| and rtol
1e-3; nu at rtol 2e-3), the densify stats (denom and max_radii2d exactly)
and the new parameters at atol 2 lr (see tests/torch_port_util.py). The
random background is off and the background constant and non-zero, so
no random stream enters; Adam starts from zero moments. The port's step
must leave its inputs bitwise unchanged.

Cases: a single-camera quad step on an integration frame (flow channels
and the flow loss on) and on a lerp frame (flow off statically), both in
the sorted layout with the static-slice compactions, outside and inside
the sync window (``sync_phase`` and ``deform_sync``). The two-camera ToRF
step, the gather-bucket compaction, the frozen Gaussians and the deform
pause are in tests/test_torch_train_step_torf.py.
"""

import numpy as np
import pytest
import torch

from gftorf_tpu_torch.train.step import (
    METRIC_NAMES,
    _deform_lr_at,
    _gaussian_lrs_at,
    train_step,
)
from gftorf_tpu_torch.models.deform import DeformConfig
from gftorf_tpu_torch.weights import training_state_to_numpy
from torch_port_util import (
    assert_step_matches,
    frame_pair,
    run_step_pair,
    stack_frames,
    statics,
    torch_train_state,
    train_state_arrays,
)

SIZE = (64, 48)
DEPTH, WIDTH = 2, 32
N_ALIVE, CAPACITY = 300, 384
IT = 2101
SCHED = dict(
    warm_up=2000, flow_start=2000, tof_iters=2_000_000,
    position_lr_init=1.6e-4, position_lr_final=1.6e-6,
    deform_lr_init=8e-4, deform_lr_final=1.6e-6, scaling_lr=0.001,
    weights=dict(color=0.0, tof=1.0, dssim=0.2, depth=0.0, dd=0.0, flow=0.5,
                 oe=0.0, scale=0.0, mlp_reg=0.01),
)


def _static(flow_frame, **kw):
    rc = dict(width=SIZE[0], height=SIZE[1], tile_h=16, tile_w=32,
              max_per_tile=512, need_dd=False, need_distribution=False)
    return statics(
        "ftorf", rc, rc, DEPTH, WIDTH, sched=SCHED, single_camera=True,
        use_quad=True, use_wl1p=True, color_on=False, flow_on=True,
        flow_frame=flow_frame, mlp_reg_on=True, active_sh_degree=2,
        tof_inverse_permutation=(2, 0, 3, 1), tof_permutation=(1, 3, 0, 2),
        bg_color=(0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2), deform_clip=0.5,
        compact_layout=True, render_bucket=320, deform_bucket=160, **kw,
    )


@pytest.mark.parametrize("flow_frame", [True, False],
                         ids=["integration_frame", "lerp_frame"])
def test_ftorf_step_matches_jax(flow_frame):
    jstatic, tstatic = _static(flow_frame)
    arrays = train_state_arrays(5, N_ALIVE, CAPACITY, DEPTH, WIDTH)
    pairs = [frame_pair(20 + fid, fid, SIZE, SIZE, (fid, fid), flow=True)
             for fid in (6, 8)]
    idx = 1 if flow_frame else 0
    jout, tout = run_step_pair(jstatic, tstatic, arrays, pairs, idx, IT)
    jm, tm = assert_step_matches(jout, tout, _gaussian_lrs_at(tstatic, IT),
                                 _deform_lr_at(tstatic, IT))
    names = dict(zip(METRIC_NAMES, tm))
    assert names["loss"] > 0 and names["tile_overflow"] == 0
    assert (names["flow_l2"] > 0) == flow_frame
    # every leaf the ToF loss reaches has a gradient (mu != 0); the color
    # loss is off in F-ToRF training and the phase is not view-dependent,
    # so sh_color and sh_phase get none
    model = tout[0]
    for leaf in ("xyz", "sh_amp", "scaling", "rotation", "opacity"):
        assert float(np.abs(getattr(model.adam.mu, leaf).numpy()).max()) > 0, leaf
    assert float(tout[2].mu["heads.xyz.weight"].abs().max()) > 0


# An optimize_sync_iters past warm_up opens the sync window (warm_up, 2500]
# around IT: the Trainer's rule (loop.py::_static_for).
OPTIMIZE_SYNC_ITERS = 2500


@pytest.mark.parametrize("flow_frame", [True, False],
                         ids=["integration_frame", "lerp_frame"])
def test_sync_window_step_matches_jax(flow_frame):
    """Inside the sync window the step fits every frame's ToF quad
    ``tof_permutation[2]`` against rendered channel 5 (``sync_phase``,
    step.py:522-537 / JAX step.py:589-605) and takes each frame's deform
    at its quad's first frame (``deform_sync``, step.py:465 / JAX
    step.py:543-549). Held against JAX at the other cases' tolerances; on
    the lerp frame the loss must differ from the same step outside the
    window, on the integration frame equal it."""
    warm_up = SCHED["warm_up"]
    window = dict(sync_phase=warm_up < IT <= OPTIMIZE_SYNC_ITERS,
                  deform_sync=IT <= OPTIMIZE_SYNC_ITERS)
    assert window == dict(sync_phase=True, deform_sync=True)
    jstatic, tstatic = _static(flow_frame, **window)
    arrays = train_state_arrays(5, N_ALIVE, CAPACITY, DEPTH, WIDTH)
    pairs = [frame_pair(20 + fid, fid, SIZE, SIZE, (fid, fid), flow=True)
             for fid in (6, 8)]
    idx = 1 if flow_frame else 0
    jout, tout = run_step_pair(jstatic, tstatic, arrays, pairs, idx, IT)
    _, tm = assert_step_matches(jout, tout, _gaussian_lrs_at(tstatic, IT),
                                _deform_lr_at(tstatic, IT))
    _, tout_static = _static(flow_frame)
    state = torch_train_state(arrays, tout_static.deform)
    outside = train_step(tout_static, state.model, state.deform,
                         state.deform_adam, stack_frames(pairs)[1], idx, IT,
                         torch.Generator().manual_seed(0))[3]
    names = dict(zip(METRIC_NAMES, tm))
    assert names["loss"] > 0 and names["tile_overflow"] == 0
    # On an integration frame (fid % 4 == 0) both branches pick quad
    # tof_permutation[2] and channel 5; on a lerp frame the window differs.
    moved = float(names["loss"]) != float(outside[METRIC_NAMES.index("loss")])
    assert moved != flow_frame


def test_training_state_round_trip():
    """weights.training_state_from_numpy and its _to_numpy inverse carry
    every leaf of a training state across unchanged, in the JAX layout."""
    arrays = train_state_arrays(3, 40, 64, DEPTH, WIDTH, sorted_layout=False)
    state = torch_train_state(arrays, DeformConfig(depth=DEPTH, width=WIDTH),
                              iteration=2101)
    back = training_state_to_numpy(state)
    assert back["iteration"] == 2101

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], f"{prefix}.{k}")
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}[{i}]")
        else:
            yield prefix, np.asarray(tree)

    for key in ("params", "aux", "adam", "deform", "deform_adam"):
        got, want = dict(flat(back[key])), dict(flat(arrays[key]))
        assert got.keys() == want.keys(), key
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], key + name)
