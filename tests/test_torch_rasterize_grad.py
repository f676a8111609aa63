"""Gradients of the port's ``rasterize`` against ``jax.grad`` of the JAX
package's, and ``render_flow`` against the JAX ``render_flow``.

The same scene (numpy, from a seed) goes through both rasterizers; the
JAX one composites with its XLA compositor on the CPU, the port with
``DenseComposite`` over the plain versions of its kernels. The loss is a
scalar mix of every image output (color, phasor, depth, acc, depth
distortion, and the fused flow channels) against fixed random weight
maps, and the gradients with respect to every input must agree: means3d,
scales, rotations, opacities, both SH blocks, the phase and dc offsets,
``means2d_ndc`` (the densification signal) and ``flow_precomp``.
Tolerance atol 2e-4, rtol 1e-3, tests/test_pallas.py's own for gradients
summed in another order; the forward outputs at atol 1e-4, rtol 1e-3 as
in tests/test_torch_render.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu import renderer as jrenderer
from gftorf_tpu.models.gaussians import GaussianParams as JParams
from gftorf_tpu.render.rasterize import rasterize as j_rasterize
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu_torch import renderer as trenderer
from gftorf_tpu_torch.render.rasterize import rasterize as t_rasterize
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
from gftorf_tpu_torch.weights import gaussian_params_from_numpy
from torch_port_util import assert_close, cameras, scene_arrays

ATOL, RTOL = 2e-4, 1e-3
W, H = 64, 48
INPUTS = ("means3d", "scales", "rotations", "opacities", "shs", "shs_p",
          "phase_offset", "dc_offset", "means2d_ndc", "bg_map", "flow")
OUTPUTS = {"color": 3, "phasor": 7, "depth": 1, "acc": 1,
           "depth_distortion": 1, "flow": 6}


def _inputs(seed, n=240):
    a = scene_arrays(seed, n)
    rng = np.random.default_rng(seed + 3)
    x = dict(
        means3d=a["xyz"], scales=np.exp(a["scaling"]), rotations=a["rotation"],
        opacities=1.0 / (1.0 + np.exp(-a["opacity"][:, 0])),
        shs=a["sh_color"], shs_p=np.stack([a["sh_phase"], a["sh_amp"]], -1),
        phase_offset=np.float32(0.1), dc_offset=np.float32(0.02),
        means2d_ndc=np.zeros((n, 2)), bg_map=rng.uniform(-1, 1, (7, H, W)),
        flow=rng.normal(size=(n, 6)),
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


CASES = {
    # tile_w, dd + distribution gates
    "tiles16x32_gates_on": (32, True),
    "tiles16x16_gates_off": (16, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_gradients_match_jax(case):
    tile_w, gates = CASES[case]
    x, maps = _inputs(7)
    kw = dict(height=H, width=W, tile_h=16, tile_w=tile_w, max_per_tile=512,
              need_dd=gates, need_distribution=gates)
    jcam, tcam = cameras(W, H, seed=4, jitter=0.05)

    def j_loss(args):
        out = j_rasterize(
            args["means3d"], args["scales"], args["rotations"],
            args["opacities"], args["shs"], args["shs_p"],
            args["phase_offset"], args["dc_offset"], args["means2d_ndc"],
            args["bg_map"], camera=jcam, config=JConfig(**kw),
            active_sh_degree=3, flow_precomp=args["flow"])
        return _loss(out, {k: jnp.asarray(v) for k, v in maps.items()}, jnp), out

    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    (j_total, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(jargs)

    targs = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    t_out = t_rasterize(
        targs["means3d"], targs["scales"], targs["rotations"],
        targs["opacities"], targs["shs"], targs["shs_p"],
        targs["phase_offset"], targs["dc_offset"], targs["means2d_ndc"],
        targs["bg_map"], camera=tcam, config=TConfig(**kw),
        active_sh_degree=3, flow_precomp=targs["flow"])
    t_total = _loss(t_out, {k: torch.tensor(v) for k, v in maps.items()}, torch)
    t_total.backward()

    for k in OUTPUTS:
        assert_close(getattr(t_out, k), getattr(j_out, k), 1e-4, 1e-3, k)
    assert_close(t_total, j_total, 1e-4, 1e-3, "loss")
    for name in INPUTS:
        grad = targs[name].grad
        assert grad is not None, name
        assert_close(grad, j_grads[name], ATOL, RTOL, f"d loss / d {name}")
    # the densification signal is there, and reaches many Gaussians
    assert int((targs["means2d_ndc"].grad.abs().sum(-1) > 0).sum()) > 50


def test_render_flow_matches_jax():
    a = scene_arrays(17, 200)
    rng = np.random.default_rng(18)
    n = a["xyz"].shape[0]
    d_xyz = (0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    d_rot = (0.02 * rng.normal(size=(n, 4))).astype(np.float32)
    flow3d = rng.normal(size=(n, 3)).astype(np.float32)
    weight = rng.uniform(-1, 1, (3, H, W)).astype(np.float32)
    kw = dict(height=H, width=W, tile_h=16, tile_w=16, max_per_tile=512)
    jcam, tcam = cameras(W, H, seed=6, jitter=0.05)
    jparams = JParams(**{k: jnp.asarray(v) for k, v in a.items()})
    alive = np.ones(n, bool)
    alive[::9] = False

    def j_loss(fl):
        out = jrenderer.render_flow(jparams, jnp.asarray(d_xyz), jnp.asarray(d_rot),
                                    fl, jcam, JConfig(**kw),
                                    alive=jnp.asarray(alive))["render_flow"]
        return jnp.sum(out * weight), out

    (_, j_img), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(flow3d))
    tparams = gaussian_params_from_numpy(a, device="cpu")
    fl = torch.tensor(flow3d, requires_grad=True)
    t_img = trenderer.render_flow(tparams, torch.tensor(d_xyz),
                                  torch.tensor(d_rot), fl, tcam, TConfig(**kw),
                                  alive=torch.tensor(alive),
                                  device="cpu")["render_flow"]
    (t_img * torch.tensor(weight)).sum().backward()
    assert_close(t_img, j_img, 1e-4, 1e-3, "render_flow")
    assert_close(fl.grad, j_grad, ATOL, RTOL, "d render_flow / d flow3d")
    assert float(fl.grad.abs().max()) > 0
