"""The port's preprocess and dense binning against the JAX package.

Preprocess: every PreprocessOutputs field, floats at atol 1e-5 and rtol
1e-5 (float32 ops in another order), integer and bool fields exactly.
Binning: both packages bin the same (JAX-preprocessed) rects and depths,
and every Binning field must be exactly equal, including scenes that
overflow max_per_tile and the duplicate capacity (the `mode="drop"`
scatters).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.render.binning import bin_gaussians as j_bin
from gftorf_tpu.render.preprocess import preprocess as j_pre
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu_torch.render.binning import bin_gaussians as t_bin
from gftorf_tpu_torch.render.preprocess import preprocess as t_pre
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
from torch_port_util import assert_close, cameras, scene_arrays

W, H = 64, 48


def _inputs(seed, n):
    a = scene_arrays(seed, n)
    # a few culled points: behind the camera, beyond zfar, zero opacity
    a["xyz"][:3, 2] = -1.0
    a["xyz"][3, 2] = 80.0
    opac = 1.0 / (1.0 + np.exp(-a["opacity"][:, 0]))
    opac[4:6] = 0.0
    rot = a["rotation"]
    shs_p = np.stack([a["sh_phase"], a["sh_amp"]], -1)
    return (a["xyz"], np.exp(a["scaling"]), rot, opac.astype(np.float32),
            a["sh_color"], shs_p)


def _run_both(seed, n, tile_w, max_per_tile, vdp=False, sh=3):
    jcam, tcam = cameras(W, H, seed=seed, jitter=0.05)
    kw = dict(height=H, width=W, tile_h=16, tile_w=tile_w,
              max_per_tile=max_per_tile, use_view_dependent_phase=vdp)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    arrs = _inputs(seed, n)
    po, dc = np.float32(0.05), np.float32(0.02)
    jout = j_pre(*[jnp.asarray(x) for x in arrs], po, dc, jnp.zeros((n, 2)),
                 jcam, jcfg, sh)
    tout = t_pre(*[torch.tensor(x) for x in arrs], torch.tensor(po),
                 torch.tensor(dc), torch.zeros((n, 2)), tcam, tcfg, sh)
    return jout, tout, jcfg, tcfg


@pytest.mark.parametrize("seed,vdp,sh", [(0, False, 3), (1, True, 3),
                                         (2, False, 1)])
def test_preprocess_matches_jax(seed, vdp, sh):
    jout, tout, _, _ = _run_both(seed, 300, 16, 512, vdp, sh)
    assert len(tout._fields) == 12 and tout._fields == jout._fields
    for name in ("valid", "rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    assert tout.rect.dtype == torch.int32
    assert not bool(tout.valid[:6].any())
    for name in ("mean2d", "depth_view", "conic", "opacity", "rgb", "phasor",
                 "dist", "dist_ndc", "radius"):
        assert_close(getattr(tout, name), getattr(jout, name), atol=1e-5,
                     rtol=1e-5, name=name)


@pytest.mark.parametrize(
    "seed,n,tile_w,max_per_tile,dup_capacity",
    [
        (0, 300, 16, 512, 0),  # roomy
        (1, 300, 32, 512, 0),  # 16x32 tiles
        (2, 300, 32, 128, 0),  # tiles overflow max_per_tile
        (3, 300, 32, 256, 300),  # the duplicate list overflows too
    ],
)
def test_binning_matches_jax_exactly(seed, n, tile_w, max_per_tile,
                                     dup_capacity):
    jout, _, jcfg, tcfg = _run_both(seed, n, tile_w, max_per_tile)
    capacity = dup_capacity or jcfg.capacity_for(n)
    jb = j_bin(jout.rect, jout.depth_view, jout.valid, jcfg, capacity)
    tb = t_bin(torch.tensor(np.asarray(jout.rect)),
               torch.tensor(np.asarray(jout.depth_view)),
               torch.tensor(np.asarray(jout.valid)), tcfg, capacity)
    for name in jb._fields:
        port, ref = getattr(tb, name), np.asarray(getattr(jb, name))
        np.testing.assert_array_equal(port.numpy(), ref, name)
        assert port.numpy().dtype == ref.dtype, name
    if max_per_tile == 128:
        assert int(tb.tile_overflow) > 0
    if dup_capacity:
        assert bool(tb.dup_overflow)


def test_binning_rejects_grids_past_8_bits():
    cfg = TConfig(height=16, width=16 * 256, tile_w=16)
    with pytest.raises(ValueError, match="below 256"):
        t_bin(torch.zeros((1, 4), dtype=torch.int32), torch.ones(1),
              torch.ones(1, dtype=torch.bool), cfg, 1024)
