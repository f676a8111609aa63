"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every scene is made from a seed with numpy and handed to both packages,
the JAX package as jnp arrays and the port as CPU torch tensors.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gftorf_tpu.ops.transforms import projection_matrix, world_to_view
from gftorf_tpu.render.settings import CameraSpec as JCamera
from gftorf_tpu_torch.render.settings import CameraSpec as TCamera

FOV_X, FOV_Y = 0.9, 0.7
ZNEAR, ZFAR, DEPTH_RANGE = 0.1, 50.0, 10.0


def scene_arrays(seed, n=300, sh_degree=3, dynamic_half=True):
    """GaussianParams fields (numpy float32) for n Gaussians in the frustum
    of ``camera_arrays``: z in [1, 8], scales 0.02-0.15, SH color and
    phasor coefficients, opacity logits, and half of them dynamic."""
    rng = np.random.default_rng(seed)
    m = (sh_degree + 1) ** 2
    z = rng.uniform(1.0, 8.0, n)
    xyz = np.stack([rng.uniform(-0.45, 0.45, n) * z,
                    rng.uniform(-0.35, 0.35, n) * z, z], -1)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n)
    sh_p = 0.2 * rng.normal(size=(n, m, 2))
    sh_p[:, 0, 1] += 1.0
    seg = np.zeros((n, 3))
    if dynamic_half:
        seg[: n // 2, 0] = 1.0
    arrays = dict(
        xyz=xyz,
        sh_color=0.3 * rng.normal(size=(n, m, 3)),
        sh_phase=sh_p[..., 0],
        sh_amp=sh_p[..., 1],
        scaling=np.log(rng.uniform(0.02, 0.15, (n, 3))),
        rotation=quat,
        opacity=np.log(opac / (1.0 - opac))[:, None],
        seg_color=seg,
        phase_offset=np.zeros(1),
        dc_offset=np.zeros(1),
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def camera_arrays(seed=0, jitter=0.0):
    """(view_t, proj_t) of a camera near the origin looking down +z."""
    rng = np.random.default_rng(1000 + seed)
    angle = jitter * rng.normal(size=3)
    rx, ry = angle[0], angle[1]
    R = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0],
                  [-np.sin(ry), 0, np.cos(ry)]]) @ np.array(
        [[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    t = jitter * rng.normal(size=3)
    return world_to_view(R, t), projection_matrix(ZNEAR, ZFAR, FOV_X, FOV_Y)


def cameras(width, height, seed=0, jitter=0.0):
    """The same camera for both packages: (jax CameraSpec, torch CameraSpec)."""
    view_t, proj_t = camera_arrays(seed, jitter)
    args = (view_t, proj_t, width, height, FOV_X, FOV_Y, ZNEAR, ZFAR,
            DEPTH_RANGE)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def deform_arrays(seed, depth, width, xyz_multires=10, t_multires=10,
                  sh_degree=3):
    """Deform-MLP leaves (numpy float32) in the JAX ``DeformParams`` layout:
    hidden (in, W) weights and (W,) biases, heads (W, out) by name. Heads
    are drawn large enough that every output is far from zero."""
    rng = np.random.default_rng(seed)
    in_dim = 3 + 6 * xyz_multires + 1 + 2 * t_multires
    skip = depth // 2
    hw, hb = [], []
    prev = in_dim
    for i in range(depth):
        if i == skip + 1:
            prev = width + in_dim
        hw.append(rng.normal(size=(prev, width)) * np.sqrt(2.0 / (prev + width)))
        hb.append(0.05 * rng.normal(size=width))
        prev = width
    m = (sh_degree + 1) ** 2
    outs = dict(xyz=3, rot=4, r=m, g=m, b=m, a=m)
    head_w = {k: 0.05 * rng.normal(size=(width, o)) for k, o in outs.items()}
    head_b = {k: 0.01 * rng.normal(size=o) for k, o in outs.items()}
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return ([f32(w) for w in hw], [f32(b) for b in hb],
            {k: f32(v) for k, v in head_w.items()},
            {k: f32(v) for k, v in head_b.items()})


def statics(scene_type, cfg_color, cfg_tof, depth, width, **kw):
    """The same static configuration for both packages: (jax StepStatic,
    torch StepStatic). ``kw`` sets fields the two share; the JAX-only
    training fields take their eval-path values."""
    from gftorf_tpu.models.deform import DeformConfig as JDeform
    from gftorf_tpu.render.settings import RasterConfig as JConfig
    from gftorf_tpu.train.step import StepStatic as JStatic
    from gftorf_tpu_torch.models.deform import DeformConfig as TDeform
    from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
    from gftorf_tpu_torch.train.step import StepStatic as TStatic

    shared = dict(
        scene_type=scene_type, active_sh_degree=3, total_num_views=64,
        render_regions=("static", "dynamic"), dynamic_on=True,
        use_quad=False, num_phasor_channels=2, optimize_phase_offset=False,
        optimize_dc_offset=False, scene_extent=2.0,
    )
    shared.update(kw)
    jax_only = dict(
        sync_phase=False, use_wl1c=False, use_wl1p=False, wl1p_e=0.1,
        color_on=True, depth_on=False, dd_on=False, oe_on=False,
        scale_on=False, mlp_reg_on=False, flow_on=False, random_bg=False,
    )
    j = JStatic(config_color=JConfig(**cfg_color), config_tof=JConfig(**cfg_tof),
                deform=JDeform(depth=depth, width=width), **jax_only, **shared)
    t = TStatic(config_color=TConfig(**cfg_color), config_tof=TConfig(**cfg_tof),
                deform=TDeform(depth=depth, width=width), **shared)
    return j, t


def to_jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def to_torch(arrays):
    return {k: torch.tensor(v) for k, v in arrays.items()}


def assert_close(port, ref, atol, rtol, name=""):
    np.testing.assert_allclose(
        port.detach().cpu().numpy() if torch.is_tensor(port) else port,
        np.asarray(ref), atol=atol, rtol=rtol, err_msg=name)
