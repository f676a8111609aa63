"""The port's dense compositor (plain version on the CPU) against two JAX
references on the same packed inputs:

 - ``composite_forward_pallas(..., interpret=True)``, the TPU kernel run
   as tests/test_pallas.py runs it: every output column at atol 2e-5 and
   rtol 1e-4, the tolerances of tests/test_pallas.py;
 - ``composite_tiles``, the XLA prefix-op compositor, at the same
   tolerances (1e-4 for depth and dd, as tests/test_pallas.py).

Per-instance contributing-pixel counts must be equal except for lanes
whose t_incl lies within ulps of T_STOP (see _chunk_common's docstring);
the tests report how many lanes differ and allow at most 1e-4 of them.
The kernel itself runs only on the card: its test is marked ``gpu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.render.composite import composite_tiles
from gftorf_tpu.render.pallas_composite import composite_forward_pallas
from gftorf_tpu_torch.render.kernels import dense
from torch_port_util import assert_close, packed_tile_inputs


_packed_inputs = packed_tile_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


def _contrib_mismatch(port, ref):
    diff = int(np.sum(port != np.asarray(ref)))
    frac = diff / port.size
    print(f"contrib lanes that differ: {diff} of {port.size}")
    assert frac <= 1e-4, (diff, port.size)


def test_helpers_match_jax():
    d = _packed_inputs(0, flow=False)
    T = d["counts"].shape[0]
    bg_t = dense._bg_to_tiles(torch.tensor(d["bg"]), T, d["tcfg"])
    np.testing.assert_array_equal(bg_t.numpy(), d["bg_tiles"])
    np.testing.assert_array_equal(
        dense._default_origins(T, d["tcfg"], "cpu").numpy(), d["origins"])


@pytest.mark.parametrize("gates", [True, False], ids=["gates_on", "gates_off"])
@pytest.mark.parametrize("flow", [True, False], ids=["flow", "no_flow"])
def test_plain_matches_pallas_interpret(gates, flow):
    d = _packed_inputs(1, flow=flow, gates=gates)
    ref = composite_forward_pallas(
        jnp.asarray(d["feat_tl"]), jnp.asarray(d["bg_tiles"]),
        jnp.asarray(d["counts"]), jnp.asarray(d["origins"]), d["jcfg"],
        interpret=True)
    out, contrib = dense.composite_forward(
        torch.tensor(d["feat_tl"]), torch.tensor(d["bg_tiles"]),
        torch.tensor(d["counts"]), torch.tensor(d["origins"]), d["tcfg"])
    assert out.shape == ref.out.shape and contrib.shape == ref.contrib.shape
    assert_close(out, ref.out, atol=2e-5, rtol=1e-4, name="out block")
    _contrib_mismatch(contrib.numpy(), ref.contrib)
    if not gates:
        assert not out[..., [12, 14, 15, 16, 18, 19]].any()
    if not flow:
        assert not out[..., 20:].any()
    assert float(out[..., 20:26].abs().max()) > 0 or not flow


@pytest.mark.parametrize("gates", [True, False], ids=["gates_on", "gates_off"])
@pytest.mark.parametrize("tile_w", [16, 32])
def test_plain_matches_composite_tiles(gates, tile_w):
    d = _packed_inputs(2, tile_w=tile_w, gates=gates)
    ref = composite_tiles(d["feats"], jnp.asarray(d["bg"]), d["jcfg"])
    out, contrib = dense.composite_forward(
        torch.tensor(d["feat_tl"]), torch.tensor(d["bg_tiles"]),
        torch.tensor(d["counts"]), torch.tensor(d["origins"]), d["tcfg"])
    port = dense.unpack_outputs(out, contrib)
    for name, atol in (("color", 2e-5), ("phasor", 2e-5), ("depth", 1e-4),
                       ("acc", 2e-5), ("dd", 1e-4), ("distribution", 1e-5),
                       ("flow", 2e-5)):
        assert_close(getattr(port, name), getattr(ref, name), atol=atol,
                     rtol=1e-4, name=name)
    _contrib_mismatch(port.contrib_pixels.numpy(), ref.contrib_pixels)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    """The CUDA kernel against its plain version on the same card inputs
    (chip_smoke.py runs the same check at full width)."""
    for gates in (True, False):
        d = _packed_inputs(3, tile_w=32, gates=gates)
        args = [torch.tensor(d[k]).to(cuda)
                for k in ("feat_tl", "bg_tiles", "counts", "origins")]
        out, contrib = dense.composite_forward_cuda(*args, d["tcfg"])
        ref_out, ref_contrib = dense.composite_forward_plain(*args, d["tcfg"])
        torch.cuda.synchronize()
        assert_close(out, ref_out.cpu(), atol=2e-5, rtol=1e-4)
        _contrib_mismatch(contrib.cpu().numpy(), ref_contrib.cpu().numpy())


def test_cuda_wrapper_refuses_grad_inputs():
    d = _packed_inputs(4, flow=False)
    feat = torch.tensor(d["feat_tl"], requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        dense.composite_forward_cuda(
            feat, torch.tensor(d["bg_tiles"]), torch.tensor(d["counts"]),
            torch.tensor(d["origins"]), d["tcfg"])
