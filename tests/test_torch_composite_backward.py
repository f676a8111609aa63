"""The port's dense compositor backward against the JAX package.

``composite_backward_plain`` (the CPU version of csrc/dense_backward.cu)
and the ``DenseComposite`` autograd function are held, on the same packed
inputs, against:

 - ``composite_backward_pallas(..., interpret=True)``, the TPU kernel run
   as tests/test_pallas.py runs it, on the same ``feat_tl``, ``out_res``
   (from JAX's forward) and cotangent ``g``;
 - ``jax.grad`` of ``composite_tiles``, the XLA prefix-op compositor,
   including the background (the shape of tests/test_pallas.py:59-90).

Tolerance atol 2e-4, rtol 1e-3: tests/test_pallas.py's own for gradients
summed in another order (the suffix sums are totals minus running prefixes
divided by q >= 0.01, so rounding in the prefixes is amplified up to 100x).
Cases: dd on and off, flow present and absent, a ragged image. A
flow-only loss leaves exactly zero gradient on mean2d, conic and opacity
(the detached weights of tests/test_pallas.py:112-148). The kernel runs
only on the card: its test is marked ``gpu``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.render.composite import composite_tiles
from gftorf_tpu.render.pallas_composite import (
    composite_backward_pallas,
    composite_forward_pallas,
    composite_tiles_pallas,
)
from gftorf_tpu_torch.render.kernels import dense
from torch_port_util import assert_close, packed_tile_inputs

ATOL, RTOL = 2e-4, 1e-3
# Output weights of the scalar loss: color, phasor, depth, acc, dd, flow.
WEIGHTS = dict(color=1.0, phasor=0.5, depth=0.25, acc=0.125, dd=2.0, flow=0.75)
# Packed columns of each TileFeatures leaf.
COLUMNS = dict(mean2d=(0, 2), conic=(2, 5), opacity=(5, 6), dist_ndc=(6, 7),
               rgb=(7, 10), dist=(10, 11), phasor=(11, 18), flow=(18, 24))

CASES = {
    # width, height, tile_w, gates (dd + distribution), flow
    "dd_flow": (64, 48, 16, True, True),
    "dd_no_flow": (64, 48, 32, True, False),
    "no_dd_flow": (64, 48, 32, False, True),
    "no_dd_no_flow": (64, 48, 16, False, False),
    "ragged": (56, 40, 16, True, True),
}


def _inputs(case, seed):
    w, h, tile_w, gates, flow = CASES[case]
    return packed_tile_inputs(seed, tile_w=tile_w, flow=flow, gates=gates,
                              width=w, height=h)


def _cotangent(d, seed):
    """A (T, PIX, 32) cotangent with every column set, as a loss would."""
    T = d["counts"].shape[0]
    pix = d["tcfg"].tile_pixels
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (T, pix, 32)).astype(np.float32)


def _torch_args(d):
    return [torch.tensor(d[k]) for k in ("feat_tl", "bg_tiles", "counts",
                                         "origins")]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_interpret(case):
    d = _inputs(case, 11)
    flow = CASES[case][4]
    jargs = [jnp.asarray(d[k]) for k in ("feat_tl", "bg_tiles", "counts",
                                         "origins")]
    out = composite_forward_pallas(*jargs, d["jcfg"], interpret=True).out
    g = _cotangent(d, 12)
    ref = composite_backward_pallas(
        jargs[0], jargs[1], out, jnp.asarray(g), jargs[2], jargs[3],
        d["jcfg"], interpret=True, has_flow=flow)
    feat, bg, counts, origins = _torch_args(d)
    port = dense.composite_backward(
        feat, bg, torch.tensor(np.asarray(out)), torch.tensor(g), counts,
        origins, d["tcfg"], flow)
    assert port.shape == ref.shape
    assert_close(port, ref, ATOL, RTOL, "dfeat")
    L = feat.shape[1]
    past = np.arange(L)[None, :] >= d["counts"][:, None]
    assert not port.numpy()[past].any()  # lanes past the count: zero rows
    if not flow:
        assert not port[..., 18:].any()
    if not CASES[case][3]:
        assert not port[..., 6].any()


def _jax_loss(compositor, feats, config):
    def f(leaves, bg_map):
        out = compositor(feats._replace(**leaves), bg_map, config)
        total = (WEIGHTS["color"] * jnp.sum(out.color)
                 + WEIGHTS["phasor"] * jnp.sum(out.phasor)
                 + WEIGHTS["depth"] * jnp.sum(out.depth)
                 + WEIGHTS["acc"] * jnp.sum(out.acc)
                 + WEIGHTS["dd"] * jnp.sum(out.dd))
        if feats.flow is not None:
            total += WEIGHTS["flow"] * jnp.sum(out.flow ** 2)
        return total
    return f


def _port_grads(d, flow_loss_only=False):
    """Gradients of the same loss through DenseComposite: w.r.t. the packed
    block (split into TileFeatures leaves) and the (7, H, W) bg map."""
    feat, _, counts, origins = _torch_args(d)
    feat.requires_grad_(True)
    bg_map = torch.tensor(d["bg"], requires_grad=True)
    cfg = d["tcfg"]
    has_flow = d["feats"].flow is not None
    bg_tiles = dense._bg_to_tiles(bg_map, counts.shape[0], cfg)
    out, contrib = dense.DenseComposite.apply(feat, bg_tiles, counts, origins,
                                              cfg, has_flow)
    assert not contrib.requires_grad
    o = dense.unpack_outputs(out, contrib)
    flow_term = (o.flow ** 2).sum() if has_flow else 0.0
    if flow_loss_only:
        total = flow_term
    else:
        total = (WEIGHTS["color"] * o.color.sum()
                 + WEIGHTS["phasor"] * o.phasor.sum()
                 + WEIGHTS["depth"] * o.depth.sum()
                 + WEIGHTS["acc"] * o.acc.sum() + WEIGHTS["dd"] * o.dd.sum()
                 + WEIGHTS["flow"] * flow_term)
    total.backward()
    return feat.grad, bg_map.grad


def _compare_leaves(port_feat, port_bg, ref_leaves, ref_bg):
    for name, ref in ref_leaves.items():
        a, b = COLUMNS[name]
        got = port_feat[..., a:b]
        assert_close(got.reshape(np.shape(ref)), ref, ATOL, RTOL, name)
    assert_close(port_bg, ref_bg, ATOL, RTOL, "bg")


@pytest.mark.parametrize("case", list(CASES))
def test_dense_composite_grads_match_jax(case):
    """DenseComposite's gradients against jax.grad of composite_tiles and,
    in two of the cases, of the Pallas kernel's custom VJP (interpret
    mode; every case already holds the plain backward against it)."""
    d = _inputs(case, 21)
    feats = d["feats"]
    names = [n for n in COLUMNS if getattr(feats, n) is not None]
    leaves = {n: getattr(feats, n) for n in names}
    bg = jnp.asarray(d["bg"])
    port_feat, port_bg = _port_grads(d)
    compositors = [composite_tiles]
    if case in ("no_dd_no_flow", "ragged"):
        compositors.append(functools.partial(composite_tiles_pallas,
                                             interpret=True))
    for compositor in compositors:
        g_leaves, g_bg = jax.grad(_jax_loss(compositor, feats, d["jcfg"]),
                                  argnums=(0, 1))(leaves, bg)
        _compare_leaves(port_feat, port_bg, g_leaves, g_bg)


def test_flow_only_loss_leaves_geometry_gradient_zero():
    d = _inputs("dd_flow", 31)
    port_feat, port_bg = _port_grads(d, flow_loss_only=True)
    np.testing.assert_array_equal(port_feat[..., 0:6].numpy(), 0.0)
    np.testing.assert_array_equal(port_bg.numpy(), 0.0)
    assert float(port_feat[..., 18:24].abs().max()) > 0
    ref = jax.grad(lambda fl: jnp.sum(composite_tiles(
        d["feats"]._replace(flow=fl), jnp.asarray(d["bg"]), d["jcfg"]).flow ** 2)
    )(d["feats"].flow)
    assert_close(port_feat[..., 18:24].reshape(ref.shape), ref, ATOL, RTOL,
                 "flow")


def test_direct_plain_autograd_would_leak_flow_into_geometry():
    """Why the plain forward is never differentiated directly: its flow
    columns are weighted by the geometry, so autograd through it moves
    the flow gradient into mean2d/conic/opacity, which DenseComposite
    (above) does not."""
    d = _inputs("dd_flow", 31)
    feat, bg, counts, origins = _torch_args(d)
    feat.requires_grad_(True)
    out, _ = dense.composite_forward_plain(feat, bg, counts, origins, d["tcfg"])
    (out[..., 20:26] ** 2).sum().backward()
    assert float(feat.grad[..., 0:6].abs().max()) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    """The CUDA backward against its plain version on the same card inputs
    (chip_smoke.py runs the same check at full width)."""
    d = _inputs(case, 41)
    args = [x.to(cuda) for x in _torch_args(d)]
    out, _ = dense.composite_forward_cuda(*args, d["tcfg"])
    g = torch.tensor(_cotangent(d, 42), device=cuda)
    flow = CASES[case][4]
    got = dense.composite_backward_cuda(args[0], args[1], out, g, args[2],
                                        args[3], d["tcfg"], flow)
    ref = dense.composite_backward_plain(args[0], args[1], out, g, args[2],
                                         args[3], d["tcfg"], flow)
    torch.cuda.synchronize()
    assert_close(got, ref.cpu(), ATOL, RTOL, "dfeat")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The backward wrapper launches its kernel or raises: CPU tensors are
    refused before any launch (composite_backward sends them to the plain
    version instead)."""
    d = _inputs("no_dd_no_flow", 51)
    feat, bg, counts, origins = _torch_args(d)
    out, _ = dense.composite_forward_plain(feat, bg, counts, origins, d["tcfg"])
    g = torch.tensor(_cotangent(d, 52))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.composite_backward_cuda(feat, bg, out, g, counts, origins,
                                      d["tcfg"], False)
