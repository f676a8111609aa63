"""The port's losses, flow geometry, Adam, densify stats, gradient clip and
schedules against the JAX package, on the same numpy inputs.

Values and, for the losses, gradients at atol 1e-6 and rtol 1e-5: the
same float32 formulas, reduced in another order. Both SSIM lowerings are
checked against the JAX function run with the same lowering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.config import OptimizationParams as JOpt
from gftorf_tpu.models import deform as jdeform
from gftorf_tpu.models import gaussians as jg
from gftorf_tpu.ops import flow as jflow
from gftorf_tpu.train import losses as jl
from gftorf_tpu.train import schedule as jsched
from gftorf_tpu.train import step as jstep
from gftorf_tpu_torch.config import OptimizationParams as TOpt
from gftorf_tpu_torch.models import deform as tdeform
from gftorf_tpu_torch.models import gaussians as tg
from gftorf_tpu_torch.ops import flow as tflow
from gftorf_tpu_torch.train import losses as tl
from gftorf_tpu_torch.train import schedule as tsched
from gftorf_tpu_torch.train import step as tstep
from torch_port_util import assert_close, camera_arrays, statics

ATOL, RTOL = 1e-6, 1e-5


def _pair(rng, *shape, low=-1.0, high=1.0):
    x = rng.uniform(low, high, shape).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x, requires_grad=True)


def _value_and_grads(jfn, tfn, jargs, targs):
    jv, jg_ = jax.value_and_grad(jfn, argnums=tuple(range(len(jargs))))(*jargs)
    tv = tfn(*targs)
    tv.backward()
    assert_close(tv, jv, ATOL, RTOL, "value")
    for t, j in zip(targs, jg_):
        assert_close(t.grad, j, ATOL, RTOL, "grad")


@pytest.mark.parametrize("name", ["weighted_l1_loss", "weighted_l1_loss_quad",
                                  "weighted_l2_loss_quad", "l1_loss", "l2_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    jp, tp = _pair(rng, 3, 12, 16)
    jgt, tgt = _pair(rng, 3, 12, 16)
    extra = {"weighted_l1_loss": (0.1, 2), "weighted_l1_loss_quad": (0.1,),
             "weighted_l2_loss_quad": (0.1,)}.get(name, ())
    _value_and_grads(lambda a, b: getattr(jl, name)(a, b, *extra),
                     lambda a, b: getattr(tl, name)(a, b, *extra),
                     (jp, jgt), (tp, tgt))


@pytest.mark.parametrize("impl", ["banded", "conv"])
def test_ssim_matches_jax(impl, monkeypatch):
    monkeypatch.setattr(jl, "_SSIM_IMPL", impl)
    rng = np.random.default_rng(2)
    for shape in ((3, 24, 32), (1, 17, 23)):
        jp, tp = _pair(rng, *shape, low=0.0)
        jgt, tgt = _pair(rng, *shape, low=0.0)
        _value_and_grads(jl.ssim, lambda a, b: tl.ssim(a, b, impl=impl),
                         (jp, jgt), (tp, tgt))


def test_flow_geometry_matches_jax():
    rng = np.random.default_rng(3)
    view_t, _ = camera_arrays(seed=2, jitter=0.1)
    h, w = 12, 16
    k = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
    dist = rng.uniform(1, 6, (1, h, w)).astype(np.float32)
    flow3d = (0.1 * rng.normal(size=(3, h, w))).astype(np.float32)
    jv, tv = jnp.asarray(view_t), torch.tensor(view_t)
    jk, tk = jnp.asarray(k), torch.tensor(k)
    jp3 = jflow.distance_to_points3d(jnp.asarray(dist), jv, 20.0, 21.0, 8.0, 6.0)
    tp3 = tflow.distance_to_points3d(torch.tensor(dist), tv, 20.0, 21.0, 8.0, 6.0)
    assert_close(tp3, jp3, ATOL, RTOL, "points3d")
    jp2 = jflow.project_points(jp3, jv, jk)
    tp2 = tflow.project_points(tp3, tv, tk)
    assert_close(tp2, jp2, 1e-5, RTOL, "points2d")  # pixel coordinates ~10

    def jf(f):
        return jnp.sum(jflow.project_flow(jp2, jp3, f, jv, jk) ** 2)

    tf = torch.tensor(flow3d, requires_grad=True)
    _value_and_grads(jf, lambda f: (tflow.project_flow(tp2, tp3, f, tv, tk) ** 2).sum(),
                     (jnp.asarray(flow3d),), (tf,))
    assert_close(tflow.intrinsics_matrix(20.0, 21.0, 8.0, 6.0),
                 jflow.intrinsics_matrix(20.0, 21.0, 8.0, 6.0), 0, 0, "K")


def _gaussian_leaves(rng, n=40, m=16):
    shapes = dict(xyz=(n, 3), sh_color=(n, m, 3), sh_phase=(n, m),
                  sh_amp=(n, m), scaling=(n, 3), rotation=(n, 4),
                  opacity=(n, 1), seg_color=(n, 3), phase_offset=(1,),
                  dc_offset=(1,))
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("on", [None, 0, 1])
def test_adam_update_matches_jax(on):
    rng = np.random.default_rng(4)
    p, g = _gaussian_leaves(rng), _gaussian_leaves(rng)
    mu = {k: 0.1 * v for k, v in _gaussian_leaves(rng).items()}
    nu = {k: 0.01 * v * v for k, v in _gaussian_leaves(rng).items()}
    color_lr = np.full((16, 1), 0.0025 / 20, np.float32)
    color_lr[0, 0] = 0.0025
    lrs = dict(xyz=1e-3, sh_color=color_lr, sh_phase=1e-4, sh_amp=2e-4,
               scaling=5e-3, rotation=1e-3, opacity=0.05, seg_color=0.0,
               phase_offset=1e-6, dc_offset=0.0)

    def J(d):
        return jg.GaussianParams(**{k: jnp.asarray(v) for k, v in d.items()})

    def T(d):
        return tg.GaussianParams(**{k: torch.tensor(v) for k, v in d.items()})

    jp, jadam = jg.adam_update(
        J(p), J(g), jg.AdamState(J(mu), J(nu), jnp.int32(6)),
        jg.GaussianParams(**{k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()}),
        on=None if on is None else jnp.float32(on))
    tlrs = tg.GaussianParams(**{k: torch.tensor(v) if isinstance(v, np.ndarray)
                                else v for k, v in lrs.items()})
    tp, tadam = tg.adam_update(T(p), T(g), tg.AdamState(
        T(mu), T(nu), torch.tensor(6, dtype=torch.int32)), tlrs, on=on)
    assert int(tadam.step) == int(jadam.step) == (6 if on == 0 else 7)
    for k in p:
        assert_close(getattr(tp, k), getattr(jp, k), ATOL, RTOL, k)
        assert_close(getattr(tadam.mu, k), getattr(jadam.mu, k), ATOL, RTOL, k)
        assert_close(getattr(tadam.nu, k), getattr(jadam.nu, k), ATOL, RTOL, k)


@pytest.mark.parametrize("mask", [False, True])
def test_add_densification_stats_matches_jax(mask):
    rng = np.random.default_rng(5)
    n = 50
    aux = dict(alive=rng.uniform(size=n) > 0.2,
               max_radii2d=rng.uniform(0, 5, n).astype(np.float32),
               xyz_grad_accum=rng.uniform(0, 1e-3, n).astype(np.float32),
               denom=rng.integers(0, 9, n).astype(np.float32))
    grad = (1e-4 * rng.normal(size=(n, 2))).astype(np.float32)
    radii = rng.integers(0, 4, n).astype(np.int32)
    pixels = rng.integers(0, 30, n).astype(np.float32)
    apply = rng.uniform(size=n) > 0.5
    j = jg.add_densification_stats(
        jg.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        jnp.asarray(grad), jnp.asarray(radii), jnp.asarray(pixels),
        jnp.asarray(apply) if mask else None)
    t = tg.add_densification_stats(
        tg.GaussianAux(**{k: torch.tensor(v) for k, v in aux.items()}),
        torch.tensor(grad), torch.tensor(radii), torch.tensor(pixels),
        torch.tensor(apply) if mask else None)
    for k in aux:
        assert_close(getattr(t, k), getattr(j, k), ATOL, RTOL, k)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_jax(scale):
    rng = np.random.default_rng(6)
    shapes = {"hidden.0.weight": (8, 5), "hidden.0.bias": (8,),
              "heads.xyz.weight": (3, 8), "heads.xyz.bias": (3,)}
    leaves = {k: (scale * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()}
    j = jdeform.clip_by_global_norm({k: jnp.asarray(v) for k, v in leaves.items()}, 1.0)
    t = tdeform.clip_by_global_norm({k: torch.tensor(v) for k, v in leaves.items()}, 1.0)
    for k in leaves:
        assert_close(t[k], j[k], ATOL, RTOL, k)


@pytest.mark.parametrize("iteration", [0, 1, 2000, 2001, 4001, 15000, 30000, 40000])
def test_schedules_match_jax(iteration):
    jo, to = JOpt(), TOpt()
    for o in (jo, to):
        o.feature_phase_lr_init, o.feature_phase_lr_final = 1e-4, 1e-6
        o.phase_offset_lr, o.dc_offset_lr = 1e-6, 2e-6
    j = jsched.build_gaussian_lrs(jo, iteration, 5.0, 3, False)
    t = tsched.build_gaussian_lrs(to, iteration, 5.0, 3, False)
    for k in t._fields:
        np.testing.assert_allclose(np.asarray(getattr(t, k)),
                                   np.asarray(getattr(j, k)), rtol=1e-12, err_msg=k)
    assert tsched.deform_lr_at(to, iteration) == jsched.deform_lr_at(jo, iteration)
    assert tsched.expon_lr(iteration, 1e-3, 1e-5, 0, 0.01, 30000) == \
        jsched.expon_lr(iteration, 1e-3, 1e-5, 0, 0.01, 30000)


SCHED = dict(warm_up=2000, tof_iters=3000, flow_start=2500,
             dd_window=(100, 3000), oe_window=(2000, 2002),
             scale_window=(1000, 5000), optimize_offset_start=2500,
             phase_offset_lr=1e-6, dc_offset_lr=2e-6,
             weights=dict(color=0.0, tof=1.0, dssim=0.2, depth=0.0, dd=0.1,
                          flow=0.01, oe=0.01, scale=0.1, mlp_reg=0.0))


@pytest.mark.parametrize("it", [1, 100, 101, 2000, 2001, 2002, 2500, 2501,
                                2999, 3000, 3001, 4999, 5000])
def test_step_schedules_match_jax_at_window_edges(it):
    kw = dict(width=32, height=16)
    js, ts = statics("torf", kw, kw, 2, 16, sched=SCHED, scene_extent=3.0)
    jw, tw = jstep._weights_at(js, jnp.int32(it)), tstep._weights_at(ts, it)
    for k in tw._fields:
        assert float(np.asarray(getattr(jw, k))) == pytest.approx(
            getattr(tw, k), rel=1e-7), k
    jl_, tl_ = jstep._gaussian_lrs_at(js, jnp.int32(it)), tstep._gaussian_lrs_at(ts, it)
    for k in tl_._fields:
        assert_close(torch.as_tensor(getattr(tl_, k)), getattr(jl_, k), 0,
                     RTOL, k)
    assert_close(torch.tensor(tstep._deform_lr_at(ts, it)),
                 jstep._deform_lr_at(js, jnp.int32(it)), 0, RTOL, "deform lr")
