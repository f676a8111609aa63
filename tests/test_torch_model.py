"""The port's model events (``gftorf_tpu_torch/models/gaussians.py``) and
KNN (``ops/knn.py``) against the JAX package on the CPU.

Each case of ``tests/test_model.py:35-261`` feeds one state, made from a
numpy seed, to both packages; the split draw is JAX's
``jax.random.normal(key, (n, C, 3))``, handed to the port as a tensor.
Tolerances: the model events move, copy and mask rows, so alive masks,
Adam steps and every copied or masked value must be equal; the values
they compute (KNN scales, split positions and scales, reset opacities)
hold at rtol 1e-6 / atol 1e-6 (fp32 rounding of the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.models import gaussians as J
from gftorf_tpu.native import mean_knn_sq_dist_native
from gftorf_tpu.ops.knn import mean_knn_sq_dist as j_knn
from gftorf_tpu_torch.models import gaussians as T
from gftorf_tpu_torch.ops.knn import mean_knn_sq_dist as t_knn
from gftorf_tpu_torch.weights import (
    gaussian_adam_from_numpy,
    gaussian_aux_from_numpy,
    gaussian_params_from_numpy,
)

ATOL = RTOL = 1e-6


def pcd(n, seed, sh_degree=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32), rng.rand(n, 3).astype(np.float32),
            rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32))


def both_states(n=16, capacity=64, seed=0, sh_degree=1, seg=None):
    pts, cols, ph, amp = pcd(n, seed)
    kw = dict(sh_degree=sh_degree)
    j = J.init_from_pcd(pts, cols, ph, amp, seg, capacity, **kw)
    t = T.init_from_pcd(pts, cols, ph, amp, seg, capacity, device="cpu", **kw)
    return j, t


def to_port(js):
    """A JAX GaussianModelState as the port's (CPU tensors)."""
    np_tree = lambda tr: {k: np.asarray(v) for k, v in tr._asdict().items()}  # noqa: E731
    return T.GaussianModelState(
        params=gaussian_params_from_numpy(np_tree(js.params), "cpu"),
        aux=gaussian_aux_from_numpy(np_tree(js.aux), "cpu"),
        adam=gaussian_adam_from_numpy(np_tree(js.adam.mu), np_tree(js.adam.nu),
                                      int(js.adam.step), "cpu"),
    )


def assert_state(t, j, atol=ATOL, rtol=RTOL, where=""):
    """Every leaf of the port's state against the JAX state's; bools and
    ints exactly."""
    pairs = [("params", t.params, j.params), ("aux", t.aux, j.aux),
             ("mu", t.adam.mu, j.adam.mu), ("nu", t.adam.nu, j.adam.nu)]
    for group, tt, jt in pairs:
        for name, tv, jv in zip(tt._fields, tt, jt):
            tv, jv = tv.numpy(), np.asarray(jv)
            assert tv.shape == jv.shape, (where, group, name)
            if jv.dtype == bool:
                np.testing.assert_array_equal(tv, jv, err_msg=f"{where}{group}.{name}")
            else:
                np.testing.assert_allclose(tv, jv, atol=atol, rtol=rtol,
                                           err_msg=f"{where}{group}.{name}")
    assert int(t.adam.step) == int(j.adam.step)


def densify_both(js, extent=10.0, max_screen=0.0, key=0, hyper=None):
    hyper = hyper or J.DensifyHyper()
    C = js.aux.alive.shape[0]
    k = jax.random.PRNGKey(key)
    jn, jd = J.densify_and_prune(js, k, hyper, extent, max_screen)
    noise = torch.tensor(np.asarray(jax.random.normal(k, (hyper.split_n, C, 3))))
    th = T.DensifyHyper(**{f: getattr(hyper, f) for f in (
        "grad_threshold", "min_opacity", "percent_dense", "split_n",
        "split_scale_shrink")})
    tn, td = T.densify_and_prune(to_port(js), noise, th, extent, max_screen)
    assert int(td) == int(jd)
    assert_state(tn, jn)
    return tn, jn


# ---------------------------------------------------------------- KNN


@pytest.mark.parametrize("n,seed,clustered", [(700, 0, False), (900, 1, True),
                                              (2, 2, False), (1, 3, False)])
def test_knn_matches_jax_and_native(n, seed, clustered):
    rng = np.random.RandomState(seed)
    if clustered:
        centers = rng.randn(12, 3) * 10
        pts = centers[rng.randint(0, 12, n)] + 0.01 * rng.randn(n, 3)
    else:
        pts = rng.randn(n, 3) * 3
    pts = pts.astype(np.float32)
    port = t_knn(torch.tensor(pts), chunk_elems=n * 37).numpy()
    brute = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(brute, np.inf)
    k = min(3, n - 1)
    exact = np.sort(brute, 1)[:, :k].mean(1) if k else np.zeros(n)
    np.testing.assert_allclose(port, exact, rtol=1e-5, atol=0)
    native = mean_knn_sq_dist_native(pts)
    if native is not None:
        np.testing.assert_allclose(port, native, rtol=1e-5, atol=0)
    if not clustered:  # the JAX matmul form cancels on tight clusters
        dev = np.asarray(j_knn(jnp.asarray(pts), block_size=256))
        np.testing.assert_allclose(port, dev, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------- init


def test_init_shapes_alive_and_scales():
    j, t = both_states()
    assert t.params.xyz.shape == (64, 3) and t.params.sh_color.shape == (64, 4, 3)
    assert int(t.aux.alive.sum()) == 16
    assert_state(t, j, atol=1e-6, rtol=1e-5)


def test_init_scales_from_knn_grid():
    xs = np.arange(4, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    cols = np.ones((64, 3), np.float32) * 0.5
    t = T.init_from_pcd(pts, cols, None, None, None, 128, device="cpu")
    j = J.init_from_pcd(pts, cols, None, None, None, 128)
    np.testing.assert_allclose(t.params.scaling[:64].numpy(), 0.0, atol=1e-5)
    assert_state(t, j)


@pytest.mark.parametrize("isotropic,static_first", [(True, False), (False, True)])
def test_init_isotropic_and_static_first(isotropic, static_first):
    pts, cols, ph, amp = pcd(40, 5)
    seg = np.zeros((40, 3), np.float32)
    seg[:20, 0] = 1.0
    kw = dict(sh_degree=2, initial_opacity=0.3, isotropic=isotropic,
              init_static_first=static_first)
    j = J.init_from_pcd(pts, cols, ph, amp, seg, 64, **kw)
    t = T.init_from_pcd(pts, cols, ph, amp, seg, 64, device="cpu", **kw)
    assert_state(t, j, atol=1e-6, rtol=1e-5)


def test_init_capacity_too_small_raises():
    pts, cols, ph, amp = pcd(8, 0)
    with pytest.raises(ValueError):
        T.init_from_pcd(pts, cols, ph, amp, None, 4, device="cpu")


# ---------------------------------------------------------------- densify


def test_clone_small_high_grad():
    j, _ = both_states(n=8, capacity=32)
    j = j._replace(
        params=j.params._replace(scaling=jnp.full_like(j.params.scaling, -5.0)),
        aux=j.aux._replace(xyz_grad_accum=j.aux.xyz_grad_accum.at[:4].set(10.0),
                           denom=j.aux.denom.at[:8].set(1.0)))
    tn, _ = densify_both(j)
    assert int(tn.aux.alive.sum()) == 12  # 8 + 4 clones


def test_screen_size_prune_is_inert_like_reference():
    j, _ = both_states(n=8, capacity=32)
    j = j._replace(
        aux=j.aux._replace(max_radii2d=jnp.full_like(j.aux.max_radii2d, 500.0),
                           denom=j.aux.denom.at[:8].set(1.0)),
        params=j.params._replace(
            scaling=jnp.full_like(j.params.scaling, jnp.log(0.1))
            .at[0].set(jnp.log(1.0)).at[1].set(jnp.log(1e-4))))
    tn, _ = densify_both(j, max_screen=10.0)
    alive = tn.aux.alive.numpy()
    assert not alive[0] and not alive[1] and alive[2:8].all()
    assert (tn.aux.max_radii2d.numpy() == 0.0).all()


@pytest.mark.parametrize("isotropic", [False, True])
def test_split_large_high_grad_with_jax_noise(isotropic):
    pts, cols, ph, amp = pcd(8, 0)
    j = J.init_from_pcd(pts, cols, ph, amp, None, 64, sh_degree=1,
                        isotropic=isotropic)
    rng = np.random.RandomState(9)
    quats = rng.randn(64, 4).astype(np.float32)
    j = j._replace(
        params=j.params._replace(scaling=jnp.full_like(j.params.scaling, 1.0),
                                 rotation=jnp.asarray(quats)),
        aux=j.aux._replace(xyz_grad_accum=j.aux.xyz_grad_accum.at[:2].set(10.0),
                           denom=j.aux.denom.at[:8].set(1.0)))
    tn, _ = densify_both(j, key=3)
    assert int(tn.aux.alive.sum()) == 10  # 8 - 2 split + 2 * 2 copies
    scales = T.get_scaling(tn.params)[tn.aux.alive].numpy()
    assert scales.min() < np.exp(1.0)


def test_split_and_clone_mixed_with_moments():
    """Clones and splits in one event, scattered alive slots, tagged Adam
    moments: every row lands where the JAX package puts it."""
    j, _ = both_states(n=24, capacity=64, seed=4)
    rng = np.random.RandomState(4)
    alive = np.zeros(64, bool)
    alive[rng.choice(64, 30, replace=False)] = True
    scaling = np.where(rng.rand(64, 1) < 0.5, -5.0, 0.5) * np.ones((1, 3))
    tag = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape), jnp.float32),
                       j.params)
    j = j._replace(
        params=j.params._replace(scaling=jnp.asarray(scaling, jnp.float32),
                                 xyz=jnp.asarray(rng.randn(64, 3), jnp.float32)),
        aux=j.aux._replace(alive=jnp.asarray(alive),
                           xyz_grad_accum=jnp.asarray(rng.rand(64) * 4e-4, jnp.float32),
                           denom=jnp.asarray(rng.randint(0, 3, 64), jnp.float32)),
        adam=J.AdamState(mu=tag, nu=jax.tree.map(jnp.abs, tag), step=jnp.int32(7)))
    tn, jn = densify_both(j, extent=4.0, max_screen=10.0, key=11)
    new_slots = tn.aux.alive.numpy() & ~alive
    assert new_slots.any()
    assert (tn.adam.mu.xyz.numpy()[new_slots] == 0).all()


def test_prune_low_opacity():
    j, _ = both_states(n=8, capacity=16)
    j = j._replace(params=j.params._replace(
        opacity=j.params.opacity.at[:3].set(J.inverse_sigmoid(jnp.float32(0.001)))))
    tn, _ = densify_both(j)
    assert int(tn.aux.alive.sum()) == 5


def test_capacity_overflow_reported():
    j, _ = both_states(n=8, capacity=9)
    j = j._replace(
        params=j.params._replace(scaling=jnp.full_like(j.params.scaling, -5.0)),
        aux=j.aux._replace(xyz_grad_accum=j.aux.xyz_grad_accum.at[:8].set(10.0),
                           denom=j.aux.denom.at[:8].set(1.0)))
    C = 9
    k = jax.random.PRNGKey(0)
    noise = torch.tensor(np.asarray(jax.random.normal(k, (2, C, 3))))
    tn, dropped = T.densify_and_prune(to_port(j), noise, T.DensifyHyper(), 10.0, 0.0)
    assert int(dropped) == 7  # 8 clones wanted, 1 free slot
    densify_both(j)
    # grown and run again with the same draw: nothing dropped
    grown = J.grow_capacity(j, 32)
    tg = T.grow_capacity(to_port(j), 32)
    assert_state(tg, grown)
    densify_both(grown)


def test_moments_zeroed_for_new():
    j, _ = both_states(n=8, capacity=32)
    ones = jax.tree.map(jnp.ones_like, j.params)
    j = j._replace(
        adam=J.AdamState(mu=ones, nu=ones, step=jnp.int32(5)),
        params=j.params._replace(scaling=jnp.full_like(j.params.scaling, -5.0)),
        aux=j.aux._replace(xyz_grad_accum=j.aux.xyz_grad_accum.at[:4].set(10.0),
                           denom=j.aux.denom.at[:8].set(1.0)))
    tn, _ = densify_both(j)
    new_slots = tn.aux.alive.numpy() & ~np.asarray(j.aux.alive)
    assert new_slots.sum() == 4
    assert (tn.adam.mu.xyz.numpy()[new_slots] == 0).all()
    assert int(tn.adam.step) == 5


def test_densify_draws_from_a_generator():
    j, t = both_states(n=8, capacity=32)
    t = t._replace(
        params=t.params._replace(scaling=torch.full_like(t.params.scaling, 1.0)),
        aux=t.aux._replace(xyz_grad_accum=torch.full_like(t.aux.denom, 10.0),
                           denom=torch.ones_like(t.aux.denom)))
    a, _ = T.densify_and_prune(t, torch.Generator().manual_seed(5), T.DensifyHyper(),
                               10.0, 0.0)
    b, _ = T.densify_and_prune(t, torch.Generator().manual_seed(5), T.DensifyHyper(),
                               10.0, 0.0)
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- opacity


@pytest.mark.parametrize("masked", [False, True])
def test_reset_opacity(masked):
    j, t = both_states(n=8, capacity=8)
    mask = np.arange(8) < 4
    jp = J.reset_opacity(j.params, jnp.asarray(mask) if masked else None)
    tp = T.reset_opacity(t.params, torch.tensor(mask) if masked else None)
    np.testing.assert_allclose(tp.opacity.numpy(), np.asarray(jp.opacity),
                               atol=ATOL, rtol=RTOL)
    op = T.get_opacity(tp)[:, 0].numpy()
    if masked:
        assert (op[:4] <= 0.011).all()
        np.testing.assert_allclose(op[4:], 0.1, rtol=1e-5)
    else:
        assert op.max() <= 0.011


@pytest.mark.parametrize("masked", [False, True])
def test_reset_opacity_state_zeroes_adam(masked):
    j, _ = both_states()
    ones = jax.tree.map(jnp.ones_like, j.params)
    j = j._replace(adam=j.adam._replace(mu=ones, nu=ones))
    mask = np.arange(64) % 3 == 0
    jn = J.reset_opacity_state(j, jnp.asarray(mask) if masked else None)
    tn = T.reset_opacity_state(to_port(j), torch.tensor(mask) if masked else None)
    assert_state(tn, jn)
    assert (tn.adam.mu.opacity.numpy() == 0).all()
    assert (tn.adam.nu.opacity.numpy() == 0).all()
    assert (tn.adam.mu.xyz.numpy() == 1).all()
    # a zero-gradient point stays exactly at the clamp
    zero_g = T.tree_map(torch.zeros_like, tn.params)
    lrs = T.tree_map(lambda _: 0.05, tn.params)
    stepped, _ = T.adam_update(tn.params, zero_g, tn.adam, lrs)
    assert torch.equal(stepped.opacity, tn.params.opacity)


def test_prune_only():
    j, _ = both_states(n=8, capacity=8)
    j = j._replace(params=j.params._replace(
        opacity=j.params.opacity.at[:2].set(J.inverse_sigmoid(jnp.float32(0.001)))))
    tn = T.prune_only(to_port(j), 0.01)
    assert int(tn.aux.alive.sum()) == 6
    assert_state(tn, J.prune_only(j, 0.01))


# ---------------------------------------------------------------- layout


def test_sort_layout_matches_jax_and_is_idempotent():
    j, _ = both_states(n=64, capacity=64)
    alive = jnp.zeros((64,), bool).at[jnp.arange(3, 60, 4)].set(True)
    seg = j.params.seg_color.at[::3, 0].set(1.0)
    mu = j.adam.mu._replace(
        xyz=jnp.arange(64, dtype=jnp.float32)[:, None].repeat(3, 1))
    j = j._replace(params=j.params._replace(seg_color=seg),
                   aux=j.aux._replace(alive=alive),
                   adam=j.adam._replace(mu=mu))
    ts = T.sort_layout(to_port(j))
    assert_state(ts, J.sort_layout(j), atol=0, rtol=0)
    motion = T.get_motion_mask(ts.params).numpy()
    al = ts.aux.alive.numpy()
    n_dyn, n_alive = int((al & motion).sum()), int(al.sum())
    assert al[:n_alive].all() and not al[n_alive:].any()
    assert motion[:n_dyn].all()
    assert not (al[n_dyn:n_alive] & motion[n_dyn:n_alive]).any()
    ts2 = T.sort_layout(ts)
    for a, b in zip(ts.params, ts2.params):
        assert torch.equal(a, b)
