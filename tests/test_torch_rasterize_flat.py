"""The port's flat-stream path as a whole against the JAX package.

 - ``rasterize`` with ``flat_stream=True`` against the JAX
   ``_rasterize_flat(..., interpret=True)``, called directly as
   tests/test_flat_stream.py calls it (the JAX ``rasterize`` takes the
   flat path only on a TPU): every image output at atol 1e-4, rtol 1e-3,
   the binning counters and radii exactly, the touched-pixel counts up to
   the lanes within ulps of T_STOP; the gradients of a scalar mix of the
   outputs w.r.t. every input (means3d, scales, rotations, opacities, both
   SH blocks, the offsets, means2d_ndc, the bg map and the flow) at
   tests/test_flat_stream.py's atol 3e-4, rtol 2e-3.
 - Unbounded tile depth: a scene crowded into one tile renders on the flat
   path with ``tile_overflow == 0`` and equals the JAX dense render at an L
   that holds the deepest tile, where the dense layout at the small L
   overflows.
 - One ``train_step`` with both RasterConfigs flat against the JAX step,
   which renders dense on the CPU (the same function), at
   ``assert_step_matches``' tolerances (tests/torch_port_util.py).
 - ``eval_frame`` (ToRF, two cameras, gates on) and ``render_flow`` on a
   flat config against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu import renderer as jrenderer
from gftorf_tpu.models.gaussians import GaussianParams as JParams
from gftorf_tpu.render.preprocess import preprocess as j_pre
from gftorf_tpu.render.rasterize import _rasterize_flat as j_rasterize_flat
from gftorf_tpu.render.rasterize import rasterize as j_rasterize
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu.train.evaluate import eval_frame as j_eval
from gftorf_tpu_torch import renderer as trenderer
from gftorf_tpu_torch.render.rasterize import rasterize as t_rasterize
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
from gftorf_tpu_torch.train.evaluate import eval_frame as t_eval
from gftorf_tpu_torch.train.step import (
    METRIC_NAMES,
    _deform_lr_at,
    _gaussian_lrs_at,
)
from gftorf_tpu_torch.weights import (
    deform_params_from_numpy,
    gaussian_params_from_numpy,
)
from torch_port_util import (
    assert_close,
    assert_step_matches,
    cameras,
    deform_arrays,
    frame_pair,
    run_step_pair,
    scene_arrays,
    statics,
    train_state_arrays,
)

W, H = 64, 48
OUT_ATOL, OUT_RTOL = 1e-4, 1e-3
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
INPUTS = ("means3d", "scales", "rotations", "opacities", "shs", "shs_p",
          "phase_offset", "dc_offset", "means2d_ndc", "bg_map", "flow")
OUTPUTS = {"color": 3, "phasor": 7, "depth": 1, "acc": 1,
           "depth_distortion": 1, "flow": 6}
EXACT = ("radii", "num_rendered", "dup_overflow", "tile_overflow", "tile_max")


def _inputs(seed, n=200, crowd=False):
    a = scene_arrays(seed, n)
    if crowd:  # most of the scene in front of one spot: one deep tile
        a["xyz"][:, :2] *= 0.02
    rng = np.random.default_rng(seed + 3)
    x = dict(
        means3d=a["xyz"], scales=np.exp(a["scaling"]), rotations=a["rotation"],
        opacities=1.0 / (1.0 + np.exp(-a["opacity"][:, 0])),
        shs=a["sh_color"], shs_p=np.stack([a["sh_phase"], a["sh_amp"]], -1),
        phase_offset=np.float32(0.1), dc_offset=np.float32(0.02),
        means2d_ndc=np.zeros((n, 2)), bg_map=rng.uniform(-1, 1, (7, H, W)),
        flow=0.3 * rng.normal(size=(n, 6)),
    )
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    maps = {k: rng.uniform(-1, 1, (c, H, W)).astype(np.float32)
            for k, c in OUTPUTS.items()}
    return x, maps


def _loss(out, maps, lib):
    total = 0.0
    for k in OUTPUTS:
        img = getattr(out, k)
        total = total + lib.sum(img * maps[k] * (img if k == "flow" else 1.0))
    return total


def _port(x, cam, cfg, requires_grad=False):
    t = {k: torch.tensor(v, requires_grad=requires_grad) for k, v in x.items()}
    out = t_rasterize(
        t["means3d"], t["scales"], t["rotations"], t["opacities"], t["shs"],
        t["shs_p"], t["phase_offset"], t["dc_offset"], t["means2d_ndc"],
        t["bg_map"], camera=cam, config=cfg, active_sh_degree=3,
        flow_precomp=t["flow"])
    return out, t


def _outputs_match(tout, jout, names=tuple(OUTPUTS) + ("distribution",)):
    for k in names:
        assert_close(getattr(tout, k), getattr(jout, k), OUT_ATOL, OUT_RTOL, k)
    for k in EXACT:
        np.testing.assert_array_equal(getattr(tout, k).numpy(),
                                      np.asarray(getattr(jout, k)), k)
    port = tout.pixels.numpy().reshape(-1)
    ref = np.asarray(jout.pixels).reshape(-1)
    assert int(np.sum(port != ref)) <= max(1, port.size // 1000)


@pytest.mark.parametrize("tile_w,gates", [(32, True), (16, False)],
                         ids=["tiles16x32_gates_on", "tiles16x16_gates_off"])
def test_rasterize_flat_matches_jax_rasterize_flat(tile_w, gates):
    x, maps = _inputs(7)
    n = x["means3d"].shape[0]
    kw = dict(height=H, width=W, tile_h=16, tile_w=tile_w, need_dd=gates,
              need_distribution=gates)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw, flat_stream=True)
    jcam, tcam = cameras(W, H, seed=4, jitter=0.05)

    def j_loss(args):
        pre = j_pre(args["means3d"], args["scales"], args["rotations"],
                    args["opacities"], args["shs"], args["shs_p"],
                    args["phase_offset"], args["dc_offset"],
                    args["means2d_ndc"], jcam, jcfg, 3)
        out = j_rasterize_flat(pre, args["bg_map"], jcfg, jcfg.capacity_for(n),
                               n, args["flow"], interpret=True)
        return _loss(out, {k: jnp.asarray(v) for k, v in maps.items()}, jnp), out

    (j_total, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in x.items()})
    t_out, targs = _port(x, tcam, tcfg, requires_grad=True)
    t_total = _loss(t_out, {k: torch.tensor(v) for k, v in maps.items()}, torch)
    t_total.backward()

    _outputs_match(t_out, j_out)
    assert int(t_out.tile_overflow) == 0
    assert_close(t_total, j_total, OUT_ATOL, OUT_RTOL, "loss")
    for name in INPUTS:
        grad = targs[name].grad
        assert grad is not None, name
        assert_close(grad, j_grads[name], GRAD_ATOL, GRAD_RTOL, f"d loss / d {name}")
    assert int((targs["means2d_ndc"].grad.abs().sum(-1) > 0).sum()) > 50


def test_flat_unbounded_tile_depth():
    """A tile far deeper than max_per_tile: the dense layout truncates
    (tile_overflow > 0), the flat stream renders it whole and equals the
    JAX dense render at an L that holds it; the port's dense path at that L
    gives the same gradients as its flat path."""
    x, maps = _inputs(11, n=600, crowd=True)
    kw = dict(height=H, width=W, tile_h=16, tile_w=32, max_per_tile=128)
    jcam, tcam = cameras(W, H, seed=2)

    flat_out, fargs = _port(x, tcam, TConfig(**kw, flat_stream=True), True)
    deepest = int(flat_out.tile_max)
    assert deepest > 2 * 256 and int(flat_out.tile_overflow) == 0
    big = -(-deepest // 128) * 128
    j_out = j_rasterize(
        *[jnp.asarray(x[k]) for k in INPUTS[:-2]], jnp.asarray(x["bg_map"]),
        camera=jcam, config=JConfig(**dict(kw, max_per_tile=big)),
        flow_precomp=jnp.asarray(x["flow"]))
    _outputs_match(flat_out, j_out, ("color", "phasor", "depth", "acc",
                                     "depth_distortion", "distribution", "flow"))

    small, _ = _port(x, tcam, TConfig(**kw))
    assert int(small.tile_overflow) > 0 and int(small.tile_max) == deepest

    dense_out, dargs = _port(x, tcam, TConfig(**dict(kw, max_per_tile=big)), True)
    tmaps = {k: torch.tensor(v) for k, v in maps.items()}
    _loss(flat_out, tmaps, torch).backward()
    _loss(dense_out, tmaps, torch).backward()
    for name in INPUTS:
        assert_close(fargs[name].grad, dargs[name].grad, GRAD_ATOL, GRAD_RTOL, name)


SIZE = (64, 48)
DEPTH, WIDTH = 2, 32
SCHED = dict(
    warm_up=2000, flow_start=2000, tof_iters=2_000_000,
    position_lr_init=1.6e-4, position_lr_final=1.6e-6,
    deform_lr_init=8e-4, deform_lr_final=1.6e-6, scaling_lr=0.001,
    weights=dict(color=0.0, tof=1.0, dssim=0.2, depth=0.0, dd=0.0, flow=0.5,
                 oe=0.0, scale=0.0, mlp_reg=0.01),
)


def test_train_step_flat_matches_jax():
    """One F-ToRF step on an integration frame (flow channels and loss on)
    with both RasterConfigs flat, as tests/test_torch_train_step.py runs
    it dense."""
    it = 2101
    rc = dict(width=SIZE[0], height=SIZE[1], tile_h=16, tile_w=32,
              max_per_tile=512, need_dd=False, need_distribution=False)
    jstatic, tstatic = statics(
        "ftorf", rc, rc, DEPTH, WIDTH, sched=SCHED, flat_stream=True,
        single_camera=True, use_quad=True, use_wl1p=True, color_on=False,
        flow_on=True, flow_frame=True, mlp_reg_on=True, active_sh_degree=2,
        tof_inverse_permutation=(2, 0, 3, 1), tof_permutation=(1, 3, 0, 2),
        bg_color=(0.1, 0.2, 0.3, 0.05, 0.1, 0.15, 0.2), deform_clip=0.5,
        compact_layout=True, render_bucket=320, deform_bucket=160,
    )
    assert tstatic.config_tof.flat_stream and tstatic.config_color.flat_stream
    arrays = train_state_arrays(5, 300, 384, DEPTH, WIDTH)
    pairs = [frame_pair(20 + fid, fid, SIZE, SIZE, (fid, fid), flow=True)
             for fid in (6, 8)]
    jout, tout = run_step_pair(jstatic, tstatic, arrays, pairs, 1, it)
    _, tm = assert_step_matches(jout, tout, _gaussian_lrs_at(tstatic, it),
                                _deform_lr_at(tstatic, it))
    names = dict(zip(METRIC_NAMES, tm))
    assert names["tile_overflow"] == 0 and names["tile_max"] > 0
    assert names["flow_l2"] > 0 and names["loss"] > 0


def test_eval_frame_flat_matches_jax():
    """Serving on the flat path: a ToRF two-camera eval_frame (gates on)
    against the JAX eval_frame."""
    a = scene_arrays(3, 300)
    hw, hb, head_w, head_b = deform_arrays(4, 4, 64)
    head_w["xyz"] *= 0.2
    from gftorf_tpu.models.deform import DeformParams
    from gftorf_tpu_torch.models.deform import DeformConfig

    jd = DeformParams(tuple(map(jnp.asarray, hw)), tuple(map(jnp.asarray, hb)),
                      {k: jnp.asarray(v) for k, v in head_w.items()},
                      {k: jnp.asarray(v) for k, v in head_b.items()})
    td = deform_params_from_numpy(hw, hb, head_w, head_b,
                                  DeformConfig(depth=4, width=64), device="cpu")
    rc = dict(width=64, height=48, tile_h=16, tile_w=32, max_per_tile=512)
    rt = dict(rc, width=48, height=32, tile_w=16)
    jstatic, tstatic = statics("torf", rc, rt, 4, 64, flat_stream=True,
                               single_camera=False)
    jf, tf = frame_pair(9, 5, (64, 48), (48, 32), (0, 1))
    alive = np.ones(300, bool)
    alive[::17] = False
    jm, jc, jt = j_eval(jstatic, JParams(**{k: jnp.asarray(v) for k, v in a.items()}),
                        jd, jnp.asarray(alive), jf)
    tm, tc, tt = t_eval(tstatic, gaussian_params_from_numpy(a, device="cpu"), td,
                        torch.tensor(alive), tf, device="cpu")
    for name in jm:
        assert_close(tm[name], jm[name], OUT_ATOL, OUT_RTOL, name)
    for tout, jout in ((tt, jt), (tc, jc)):
        _outputs_match(tout, jout, ("color", "phasor", "depth", "acc",
                                    "depth_distortion", "distribution"))
        assert float(tout.acc.max()) > 0.5


def test_render_flow_flat_matches_jax():
    a = scene_arrays(17, 200)
    rng = np.random.default_rng(18)
    n = a["xyz"].shape[0]
    d_xyz = (0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    d_rot = (0.02 * rng.normal(size=(n, 4))).astype(np.float32)
    flow3d = rng.normal(size=(n, 3)).astype(np.float32)
    weight = rng.uniform(-1, 1, (3, H, W)).astype(np.float32)
    kw = dict(height=H, width=W, tile_h=16, tile_w=16, max_per_tile=512)
    jcam, tcam = cameras(W, H, seed=6, jitter=0.05)

    def j_loss(fl):
        out = jrenderer.render_flow(
            JParams(**{k: jnp.asarray(v) for k, v in a.items()}),
            jnp.asarray(d_xyz), jnp.asarray(d_rot), fl, jcam,
            JConfig(**kw))["render_flow"]
        return jnp.sum(out * weight), out

    (_, j_img), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(flow3d))
    fl = torch.tensor(flow3d, requires_grad=True)
    t_img = trenderer.render_flow(
        gaussian_params_from_numpy(a, device="cpu"), torch.tensor(d_xyz),
        torch.tensor(d_rot), fl, tcam, TConfig(**kw, flat_stream=True),
        device="cpu")["render_flow"]
    (t_img * torch.tensor(weight)).sum().backward()
    assert_close(t_img, j_img, OUT_ATOL, OUT_RTOL, "render_flow")
    assert_close(fl.grad, j_grad, GRAD_ATOL, GRAD_RTOL, "d render_flow / d flow3d")
    assert float(fl.grad.abs().max()) > 0
