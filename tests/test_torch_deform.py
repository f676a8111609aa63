"""The port's deform MLP and deform query against the JAX package.

``weights.deform_params_from_numpy`` carries one set of weights (drawn
with numpy) across, then ``DeformNetwork`` is held against
``apply_deform`` and the port's ``_query_deform`` against the JAX one:
torf, and ftorf on and off the integration frame, with the unbucketed and
both bucketed (gather and compact-layout) ``_deform_slots`` branches.
Tolerance atol 1e-5, rtol 1e-4: both run the MLP in float32 on the CPU,
with sums taken in another order. The ``deform_model.npz`` written by JAX
``save_pytree`` must load to the same weights bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.models.deform import DeformConfig as JDeform
from gftorf_tpu.models.deform import DeformParams, apply_deform
from gftorf_tpu.models.gaussians import GaussianParams as JParams
from gftorf_tpu.train.step import _query_deform as j_query
from gftorf_tpu.utils.checkpoint import save_pytree
from gftorf_tpu_torch.models.deform import DeformConfig, init_deform
from gftorf_tpu_torch.train.export import load_deform_model
from gftorf_tpu_torch.train.step import _query_deform as t_query
from gftorf_tpu_torch.weights import (
    deform_params_from_numpy,
    gaussian_params_from_numpy,
)
from torch_port_util import assert_close, deform_arrays, scene_arrays, statics

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(height=48, width=64, tile_h=16, tile_w=16)


def _both(seed, depth, width):
    hw, hb, head_w, head_b = deform_arrays(seed, depth, width)
    jp = DeformParams(tuple(jnp.asarray(w) for w in hw),
                      tuple(jnp.asarray(b) for b in hb),
                      {k: jnp.asarray(v) for k, v in head_w.items()},
                      {k: jnp.asarray(v) for k, v in head_b.items()})
    net = deform_params_from_numpy(hw, hb, head_w, head_b,
                                   DeformConfig(depth=depth, width=width),
                                   device="cpu")
    return jp, net


@pytest.mark.parametrize("depth,width,n", [(4, 64, 200), (8, 256, 256)])
def test_apply_deform_matches_jax(depth, width, n):
    jp, net = _both(depth, depth, width)
    rng = np.random.default_rng(depth)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    ref = apply_deform(jp, JDeform(depth=depth, width=width),
                       jnp.asarray(xyz), jnp.asarray(t))
    with torch.no_grad():
        out = net(torch.tensor(xyz), torch.tensor(t))
    for name, o, r in zip(("d_xyz", "d_rot", "d_sh", "d_sh_p"), out, ref):
        assert tuple(o.shape) == r.shape, name
        assert_close(o, r, ATOL, RTOL, name)
    assert float(out[0].abs().max()) > 1e-2


@pytest.mark.parametrize(
    "scene_type,fid", [("torf", 5), ("ftorf", 8), ("ftorf", 6)],
    ids=["torf", "ftorf_integration_frame", "ftorf_lerp"])
@pytest.mark.parametrize(
    "bucket,compact", [(0, False), (128, False), (128, True)],
    ids=["unbucketed", "bucket_gather", "bucket_compact"])
def test_query_deform_matches_jax(scene_type, fid, bucket, compact):
    n = 256
    a = scene_arrays(7, n)  # rows [0, 128) dynamic: the compact layout
    alive = np.ones(n, bool)
    alive[[3, 200]] = False
    jstatic, tstatic = statics(scene_type, CFG, CFG, 4, 64,
                               deform_bucket=bucket, compact_layout=compact)
    jp, net = _both(11, 4, 64)
    ref = j_query(jstatic, jp, JParams(**{k: jnp.asarray(v) for k, v in a.items()}),
                  jnp.int32(fid), alive=jnp.asarray(alive))
    with torch.no_grad():
        out = t_query(tstatic, net, gaussian_params_from_numpy(a, device="cpu"),
                      fid, alive=torch.tensor(alive))
    names = ("d_xyz", "d_rot", "d_sh", "d_sh_p", "d_curr", "d_next")
    for name, o, r in zip(names, out, ref):
        assert tuple(o.shape) == r.shape, name
        assert_close(o, r, ATOL, RTOL, name)
    if bucket:
        # compacted rows: static and dead rows get no deformation
        assert not out[0][128:].any() and not out[0][3].any()
    assert float(out[0].abs().max()) > 1e-2


def test_deform_npz_round_trip(tmp_path):
    depth, width = 4, 64
    jp, _ = _both(3, depth, width)
    path = str(tmp_path / "deform_model.npz")
    save_pytree(path, jp, meta={"iteration": 7})
    net = load_deform_model(path, DeformConfig(depth=depth, width=width),
                            device="cpu")
    for i, layer in enumerate(net.hidden):
        np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                      np.asarray(jp.hidden_w[i]))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(jp.hidden_b[i]))
    for name, head in net.heads.items():
        np.testing.assert_array_equal(head.weight.detach().numpy().T,
                                      np.asarray(jp.head_w[name]))
        np.testing.assert_array_equal(head.bias.detach().numpy(),
                                      np.asarray(jp.head_b[name]))
    with pytest.raises(ValueError, match="depth"):
        load_deform_model(path, DeformConfig(depth=2, width=width), device="cpu")


def test_init_deform_is_seeded_and_near_identity():
    cfg = DeformConfig(depth=4, width=64)
    nets = [init_deform(cfg, torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 0, 1)]
    sd = [n.state_dict() for n in nets]
    assert all(torch.equal(sd[0][k], sd[1][k]) for k in sd[0])
    assert not torch.equal(sd[0]["hidden.0.weight"], sd[2]["hidden.0.weight"])
    assert float(sd[0]["heads.xyz.weight"].std()) < 1e-4
    assert all(not sd[0][k].any() for k in sd[0] if k.endswith("bias"))
    xyz = torch.rand((16, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        d_xyz = nets[0](xyz, torch.full((16, 1), 0.5))[0]
    assert float(d_xyz.abs().max()) < 1e-2
