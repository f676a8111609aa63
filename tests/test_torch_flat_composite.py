"""The port's flat-stream compositor against the JAX package.

On the same aligned stream (JAX-preprocessed Gaussians binned by the JAX
``bin_gaussians_flat``, padding rows zero):

 - ``composite_forward_flat`` (the plain version on the CPU) against
   ``flat_stream.composite_forward_flat(..., interpret=True)``, the TPU
   kernel run as tests/test_flat_stream.py runs it: the output block at
   atol 2e-5, rtol 1e-4, and contributing-pixel counts per stream slot
   equal but for lanes whose transmittance lies within ulps of T_STOP (at
   most 1e-4 of the slots);
 - ``composite_backward_flat`` against ``flat_stream.
   composite_backward_flat(..., interpret=True)`` on the JAX forward's
   block and a cotangent in [-1, 1], at tests/test_flat_stream.py's
   gradient tolerance, atol 3e-4, rtol 2e-3 (sums in another order, with
   suffix sums divided by q >= 0.01);
 - the gradients through ``composite_packed_flat`` (``FlatComposite``)
   against ``jax.grad`` through the JAX ``composite_packed_flat`` (its
   custom VJP ``_make_flat_vjp``), w.r.t. the stream and the bg map.

Cases: dd / distribution gates on and off, flow on and off, 16x16 and
16x32 tiles, and crowded scenes whose central tiles span several
256-row blocks of the stream (so the TPU kernel carries its per-tile
state across chunks). The CUDA kernels run only on the card: their test
is marked ``gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.render import flat_stream as j_flat
from gftorf_tpu_torch.render.kernels import dense, flat
from torch_port_util import assert_close, packed_stream_inputs

FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
BWD_ATOL, BWD_RTOL = 3e-4, 2e-3
WEIGHTS = dict(color=1.0, phasor=0.5, depth=0.25, acc=0.125, dd=2.0, flow=0.75)

CASES = {
    # tile_w, gates (dd + distribution), flow, crowd, n
    "gates_flow_16x16": (16, True, True, False, 120),
    "no_gates_no_flow_16x32": (32, False, False, False, 120),
    "gates_no_flow_crowded": (16, True, False, True, 700),
    "no_gates_flow_crowded_16x32": (32, False, True, True, 700),
}


def _inputs(case, seed):
    tile_w, gates, flow, crowd, n = CASES[case]
    d = packed_stream_inputs(seed, n=n, tile_w=tile_w, flow=flow, gates=gates,
                             crowd=crowd)
    if crowd:
        assert d["tile_count"].max() > 2 * flat.FLAT_ALIGN
    return d


def _jax_args(d):
    return [jnp.asarray(d[k]) for k in ("feat_fl", "bg_tiles", "chunk_tile",
                                        "origins")]


def _torch_args(d):
    return [torch.tensor(d[k]) for k in ("feat_fl", "bg_tiles", "tile_start",
                                         "tile_count", "origins")]


def _cotangent(d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, d["bg_tiles"].shape[:2] + (32,)).astype(np.float32)


def _contrib_mismatch(port, ref):
    diff = int(np.sum(port != np.asarray(ref)))
    print(f"contrib slots that differ: {diff} of {port.size}")
    assert diff <= 1e-4 * port.size, diff


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_pallas_interpret(case):
    d = _inputs(case, 1)
    ref_out, ref_contrib = j_flat.composite_forward_flat(
        *_jax_args(d), d["jcfg"], interpret=True)
    out, contrib = flat.composite_forward_flat(*_torch_args(d), d["tcfg"])
    assert out.shape == ref_out.shape and contrib.shape == ref_contrib.shape
    assert_close(out, ref_out, FWD_ATOL, FWD_RTOL, "out block")
    _contrib_mismatch(contrib.numpy(), ref_contrib)
    assert not contrib.numpy()[d["gauss_flat"] < 0].any()  # padding slots
    _, gates, has_flow, _, _ = CASES[case]
    if not gates:
        assert not out[..., [12, 14, 15, 16, 18, 19]].any()
    assert bool(out[..., 20:26].any()) == has_flow


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_interpret(case):
    d = _inputs(case, 2)
    has_flow = CASES[case][2]
    jargs = _jax_args(d)
    out, _ = j_flat.composite_forward_flat(*jargs, d["jcfg"], interpret=True)
    g = _cotangent(d, 3)
    ref = j_flat.composite_backward_flat(
        jargs[0], jargs[1], out, jnp.asarray(g), jargs[2], jargs[3], d["jcfg"],
        interpret=True, has_flow=has_flow)
    feat, bg, start, count, origins = _torch_args(d)
    port = flat.composite_backward_flat(
        feat, bg, torch.tensor(np.asarray(out)), torch.tensor(g), start, count,
        origins, d["tcfg"], has_flow)
    assert port.shape == ref.shape
    assert_close(port, ref, BWD_ATOL, BWD_RTOL, "dfeat")
    assert not port.numpy()[d["gauss_flat"] < 0].any()  # padding rows
    if not has_flow:
        assert not port[:, 18:].any()
    if not CASES[case][1]:
        assert not port[:, 6].any()


def _jax_loss(d, has_flow):
    def f(feat_fl, bg_map):
        o = j_flat.composite_packed_flat(
            feat_fl, jnp.asarray(d["chunk_tile"]), bg_map, d["jcfg"],
            interpret=True, has_flow=has_flow)
        total = (WEIGHTS["color"] * jnp.sum(o.color)
                 + WEIGHTS["phasor"] * jnp.sum(o.phasor)
                 + WEIGHTS["depth"] * jnp.sum(o.depth)
                 + WEIGHTS["acc"] * jnp.sum(o.acc)
                 + WEIGHTS["dd"] * jnp.sum(o.dd)
                 + WEIGHTS["flow"] * jnp.sum(o.flow ** 2)
                 # not differentiable: the stop-gradients drop these terms
                 + jnp.sum(o.distribution) + jnp.sum(o.contrib_pixels))
        return total
    return f


@pytest.mark.parametrize("case", ["gates_flow_16x16", "gates_no_flow_crowded"])
def test_flat_composite_grads_match_flat_vjp(case):
    d = _inputs(case, 4)
    has_flow = CASES[case][2]
    g_feat, g_bg = jax.grad(_jax_loss(d, has_flow), argnums=(0, 1))(
        jnp.asarray(d["feat_fl"]), jnp.asarray(d["bg"]))

    feat, _, start, count, origins = _torch_args(d)
    feat.requires_grad_(True)
    bg_map = torch.tensor(d["bg"], requires_grad=True)
    cfg = d["tcfg"]
    bg_tiles = dense._bg_to_tiles(bg_map, start.shape[0], cfg)
    o = flat.composite_packed_flat(feat, start, count, bg_tiles, origins, cfg,
                                   has_flow)
    assert not o.contrib_pixels.requires_grad
    total = (WEIGHTS["color"] * o.color.sum() + WEIGHTS["phasor"] * o.phasor.sum()
             + WEIGHTS["depth"] * o.depth.sum() + WEIGHTS["acc"] * o.acc.sum()
             + WEIGHTS["dd"] * o.dd.sum() + WEIGHTS["flow"] * (o.flow ** 2).sum()
             + o.distribution.sum() + o.contrib_pixels.sum())
    total.backward()
    assert_close(feat.grad, g_feat, BWD_ATOL, BWD_RTOL, "d feat_fl")
    assert_close(bg_map.grad, g_bg, BWD_ATOL, BWD_RTOL, "d bg")
    assert float(feat.grad[:, 0:6].abs().max()) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_card(cuda, case):
    """Both CUDA kernels against their plain versions on the same card
    inputs (chip_smoke.py runs the same checks at full width)."""
    d = _inputs(case, 5)
    has_flow = CASES[case][2]
    feat, bg, start, count, origins = [x.to(cuda) for x in _torch_args(d)]
    cfg = d["tcfg"]
    out, contrib = flat.composite_forward_flat_cuda(feat, bg, start, count,
                                                    origins, cfg)
    ref_out, ref_contrib = flat.composite_forward_flat_plain(
        feat, bg, start, count, origins, cfg)
    g = torch.tensor(_cotangent(d, 6), device=cuda)
    dfeat = flat.composite_backward_flat_cuda(feat, bg, out, g, start, count,
                                              origins, cfg, has_flow)
    ref_dfeat = flat.composite_backward_flat_plain(feat, bg, out, g, start,
                                                   count, origins, cfg, has_flow)
    torch.cuda.synchronize()
    assert_close(out, ref_out.cpu(), FWD_ATOL, FWD_RTOL, "out block")
    _contrib_mismatch(contrib.cpu().numpy(), ref_contrib.cpu().numpy())
    assert_close(dfeat, ref_dfeat.cpu(), 2e-4, 1e-3, "dfeat")


def test_cuda_wrappers_refuse_what_their_kernels_do_not_take():
    """The flat wrappers launch their kernel or raise: CPU tensors, inputs
    that require grad outside FlatComposite, and (backward) tiles of more
    than 512 pixels are refused before any launch."""
    d = _inputs("no_gates_no_flow_16x32", 7)
    feat, bg, start, count, origins = _torch_args(d)
    cfg = d["tcfg"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat.composite_forward_flat_cuda(feat, bg, start, count, origins, cfg)
    out, _ = flat.composite_forward_flat_plain(feat, bg, start, count, origins,
                                               cfg)
    g = torch.tensor(_cotangent(d, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flat.composite_backward_flat_cuda(feat, bg, out, g, start, count,
                                          origins, cfg, False)
    with pytest.raises(ValueError, match="requires grad"):
        flat.composite_forward_flat_cuda(feat.clone().requires_grad_(True), bg,
                                         start, count, origins, cfg)
    wide = type(cfg)(height=cfg.height, width=cfg.width, tile_h=32,
                     tile_w=32, flat_stream=True)
    with pytest.raises(ValueError, match="up to 512"):
        flat.composite_backward_flat_cuda(feat, bg, out, g, start, count,
                                          origins, wide, False)
