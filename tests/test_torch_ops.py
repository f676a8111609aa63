"""The port's ops (transforms, covariance, SH, ToF) against gftorf_tpu.ops.

Inputs are made from a seed with numpy and fed to both packages on the
CPU. Tolerance: atol 1e-6, rtol 1e-5 (float32 ops in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.ops import covariance as jcov
from gftorf_tpu.ops import sh as jsh
from gftorf_tpu.ops import tof as jtof
from gftorf_tpu.ops import transforms as jtr
from gftorf_tpu_torch.ops import covariance as tcov
from gftorf_tpu_torch.ops import sh as tsh
from gftorf_tpu_torch.ops import tof as ttof
from gftorf_tpu_torch.ops import transforms as ttr

TOL = dict(atol=1e-6, rtol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(port.detach().numpy() if torch.is_tensor(port) else port),
        np.asarray(ref), **(tol or TOL))


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def random_rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_matrices_equal(seed):
    rng = np.random.default_rng(seed)
    R, tv = random_rotation(rng), rng.normal(size=3)
    np.testing.assert_array_equal(ttr.world_to_view(R, tv),
                                  jtr.world_to_view(R, tv))
    args = (0.05, 60.0, 0.9 + 0.1 * seed, 0.7)
    np.testing.assert_array_equal(ttr.projection_matrix(*args),
                                  jtr.projection_matrix(*args))
    shift = (0.05, 60.0, 300.0, 290.0, 160.5, 118.0, 320, 240, 0.9, 0.7)
    np.testing.assert_array_equal(ttr.projection_matrix_shift(*shift),
                                  jtr.projection_matrix_shift(*shift))
    v = jtr.world_to_view(R, tv)
    p = jtr.projection_matrix(*args)
    np.testing.assert_array_equal(ttr.full_projection(v, p),
                                  jtr.full_projection(v, p))
    np.testing.assert_array_equal(ttr.camera_center(v), jtr.camera_center(v))
    assert ttr.fov2focal(0.8, 320) == jtr.fov2focal(0.8, 320)
    assert ttr.focal2fov(250.0, 320) == jtr.focal2fov(250.0, 320)


def test_point_transforms():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    close(ttr.transform_point_4x3(t(p), t(m)),
          jtr.transform_point_4x3(jnp.asarray(p), jnp.asarray(m)))
    close(ttr.transform_point_4x4(t(p), t(m)),
          jtr.transform_point_4x4(jnp.asarray(p), jnp.asarray(m)))
    v = rng.uniform(-1.2, 1.2, 64).astype(np.float32)
    close(ttr.ndc2pix(t(v), 320), jtr.ndc2pix(jnp.asarray(v), 320))


def _gaussians(seed, n=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scale = rng.uniform(0.01, 0.4, (n, 3)).astype(np.float32)
    tview = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(0.5, 8, n)], -1).astype(np.float32)
    view_t = jtr.world_to_view(random_rotation(rng), rng.normal(size=3))
    return q, scale, tview, view_t


@pytest.mark.parametrize("seed", [0, 1])
def test_covariance(seed):
    q, scale, tview, view_t = _gaussians(seed)
    close(tcov.quat_to_rotmat(t(q)), jcov.quat_to_rotmat(jnp.asarray(q)))
    c3_ref = jcov.build_cov3d(jnp.asarray(scale), 1.3, jnp.asarray(q))
    c3 = tcov.build_cov3d(t(scale), 1.3, t(q))
    close(c3, c3_ref)

    fx, fy, tx, ty = 277.1, 281.9, 0.58, 0.43
    c2_ref = jax.vmap(
        lambda tt, cc: jcov.ewa_project_cov2d(
            tt, cc, jnp.asarray(view_t), jnp.float32(fx), jnp.float32(fy),
            jnp.float32(tx), jnp.float32(ty))
    )(jnp.asarray(tview), c3_ref)
    f32 = lambda x: torch.tensor(np.float32(x))  # noqa: E731
    c2 = tcov.ewa_project_cov2d(t(tview), t(np.asarray(c3_ref)), t(view_t),
                                f32(fx), f32(fy), f32(tx), f32(ty))
    close(c2, c2_ref)

    conic_ref, det_ref = jcov.conic_from_cov2d(c2_ref)
    conic, det = tcov.conic_from_cov2d(t(np.asarray(c2_ref)))
    close(conic, conic_ref)
    close(det, det_ref)
    close(tcov.screen_radius(t(np.asarray(c2_ref)), t(np.asarray(det_ref))),
          jcov.screen_radius(c2_ref, det_ref), atol=0, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = (degree + 1) ** 2
    coeffs = rng.normal(size=(96, 2, m + 3)).astype(np.float32)
    close(tsh.sh_basis(degree, t(d)), jsh.sh_basis(degree, jnp.asarray(d)))
    close(tsh.eval_sh(degree, t(coeffs), t(d)),
          jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(d)))
    assert tsh.SH_C0 == jsh.SH_C0


@pytest.mark.parametrize("view_dependent", [False, True])
def test_tof(view_dependent):
    rng = np.random.default_rng(7)
    dist = rng.uniform(0.5, 9.0, 200).astype(np.float32)
    phase = rng.normal(size=200).astype(np.float32)
    amp = rng.uniform(0, 2, 200).astype(np.float32)
    f32 = np.float32
    ref = jtof.phasor_channels(jnp.asarray(dist), jnp.asarray(phase),
                               jnp.asarray(amp), f32(10.0), f32(0.05),
                               f32(0.02), view_dependent)
    port = ttof.phasor_channels(t(dist), t(phase), t(amp),
                                torch.tensor(f32(10.0)), torch.tensor(f32(0.05)),
                                torch.tensor(f32(0.02)), view_dependent)
    close(port, ref)
    tof_img = rng.normal(size=(24, 32, 3)).astype(np.float32)
    tof_img[0, :4, 0] = 0.0  # the |real| < 1e-6 guard
    close(ttof.depth_from_tof(t(tof_img), torch.tensor(f32(10.0)), 0.3),
          jtof.depth_from_tof(jnp.asarray(tof_img), f32(10.0), 0.3),
          )
