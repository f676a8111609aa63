"""The port's serving slice as a whole against the JAX package.

One scene (numpy, from a seed), one set of deform weights and one camera
rig go to both packages. ``eval_frame`` (ftorf single-camera on and off
the integration frame, torf two-camera) and ``renderer.render_eval`` /
``renderer.render`` must agree: every image channel at atol 1e-4, rtol
1e-3 (float32 preprocess, deform MLP and blending in another order),
every metric at the same tolerance, per-Gaussian radii and the binning
counters exactly, and the touched-pixel counts up to the few lanes whose
transmittance lies within ulps of T_STOP (at most 1e-3 of the Gaussians).
The JAX side composites with its XLA compositor, as it does on the CPU.

Also: configs/*.json load to equal fields in both packages, a model
written by the JAX exporter loads in the port to equal parameters, and
the entry points refuse to run without CUDA unless given device="cpu".
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu import renderer as jrenderer
from gftorf_tpu.config import Config as JConfigFile
from gftorf_tpu.models.deform import DeformParams
from gftorf_tpu.models.gaussians import GaussianParams as JParams
from gftorf_tpu.train.evaluate import eval_frame as j_eval
from gftorf_tpu.train.export import gaussian_ply_props
from gftorf_tpu.train.step import FrameData as JFrame
from gftorf_tpu.utils.ply import write_ply
from gftorf_tpu_torch import renderer as trenderer
from gftorf_tpu_torch.config import Config as TConfigFile
from gftorf_tpu_torch.models.deform import DeformConfig, init_deform
from gftorf_tpu_torch.render.settings import CameraSpec as TCamera
from gftorf_tpu_torch.train.evaluate import eval_frame as t_eval
from gftorf_tpu_torch.train.export import load_gaussians_from_ply
from gftorf_tpu_torch.train.step import FrameData as TFrame
from gftorf_tpu_torch.weights import (
    deform_params_from_numpy,
    gaussian_params_from_numpy,
)
from torch_port_util import (
    assert_close,
    cameras,
    deform_arrays,
    scene_arrays,
    statics,
)

ATOL, RTOL = 1e-4, 1e-3
IMAGE_FIELDS = ("color", "phasor", "depth", "acc", "depth_distortion",
                "distribution")
EXACT_FIELDS = ("radii", "num_rendered", "dup_overflow", "tile_overflow",
                "tile_max")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(seed, n=300, depth=4, width=64):
    a = scene_arrays(seed, n)
    hw, hb, head_w, head_b = deform_arrays(seed + 1, depth, width)
    # small deformations: the dynamic half moves, but stays in view
    head_w["xyz"] *= 0.2
    jdeform = DeformParams(tuple(jnp.asarray(w) for w in hw),
                           tuple(jnp.asarray(b) for b in hb),
                           {k: jnp.asarray(v) for k, v in head_w.items()},
                           {k: jnp.asarray(v) for k, v in head_b.items()})
    tdeform = deform_params_from_numpy(
        hw, hb, head_w, head_b, DeformConfig(depth=depth, width=width),
        device="cpu")
    jparams = JParams(**{k: jnp.asarray(v) for k, v in a.items()})
    tparams = gaussian_params_from_numpy(a, device="cpu")
    return a, (jparams, jdeform), (tparams, tdeform)


def _frames(seed, fid, size_color, size_tof, cam_seeds):
    """FrameData for both packages: numpy ground truth, one rig."""
    rng = np.random.default_rng(seed)
    (wc, hc), (wt, ht) = size_color, size_tof
    jcc, tcc = cameras(wc, hc, seed=cam_seeds[0], jitter=0.05)
    jct, tct = cameras(wt, ht, seed=cam_seeds[1], jitter=0.05)
    gt = dict(
        gt_image=rng.uniform(0, 1, (3, hc, wc)),
        gt_phasor=rng.normal(size=(3, ht, wt)),
        gt_quad=rng.normal(size=(4, ht, wt)),
        gt_distance=rng.uniform(1, 8, (1, ht, wt)),
        forward_flow=np.zeros((2, ht, wt)),
        backward_flow=np.zeros((2, ht, wt)),
    )
    gt = {k: v.astype(np.float32) for k, v in gt.items()}
    j = JFrame(
        frame_id=jnp.int32(fid), cam_color=jcc, cam_tof=jct,
        **{k: jnp.asarray(v) for k, v in gt.items()},
        has_forward_flow=jnp.asarray(False), has_backward_flow=jnp.asarray(False),
        phase_offset=jnp.float32(0.1), dc_offset=jnp.float32(0.02),
        intrinsics_tof=jnp.eye(3), intrinsics_color=jnp.eye(3),
    )
    t = TFrame(
        frame_id=torch.tensor(fid, dtype=torch.int32), cam_color=tcc,
        cam_tof=tct, **{k: torch.tensor(v) for k, v in gt.items()},
        has_forward_flow=torch.tensor(False),
        has_backward_flow=torch.tensor(False),
        phase_offset=torch.tensor(0.1), dc_offset=torch.tensor(0.02),
        intrinsics_tof=torch.eye(3), intrinsics_color=torch.eye(3),
    )
    return j, t


def _pixels_match(port, ref):
    port = port.numpy().reshape(-1)
    ref = np.asarray(ref).reshape(-1)
    diff = int(np.sum(port != ref))
    print(f"touched-pixel counts that differ: {diff} of {port.size}")
    assert diff <= max(1, port.size // 1000), diff
    np.testing.assert_allclose(port, ref, atol=8.0)


def _outputs_match(tout, jout):
    for name in IMAGE_FIELDS:
        port, ref = getattr(tout, name), getattr(jout, name)
        assert tuple(port.shape) == ref.shape, name
        assert_close(port, ref, ATOL, RTOL, name)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), name)
    _pixels_match(tout.pixels, jout.pixels)
    assert float(tout.acc.max()) > 0.5  # the scene is in view


CASES = {
    # scene_type, fid, single camera, color/ToF sizes, gates
    "ftorf_lerp": ("ftorf", 6, True, (64, 48), (64, 48), False),
    "ftorf_integration": ("ftorf", 8, True, (64, 48), (64, 48), False),
    "torf_two_camera": ("torf", 5, False, (64, 48), (48, 32), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_frame_matches_jax(case):
    scene_type, fid, single, size_c, size_t, gates = CASES[case]
    _, (jp, jd), (tp, td) = _model(3)
    rc = dict(width=size_c[0], height=size_c[1], tile_h=16, tile_w=32,
              max_per_tile=512, need_dd=gates, need_distribution=gates)
    rt = dict(rc, width=size_t[0], height=size_t[1], tile_w=16)
    jstatic, tstatic = statics(
        scene_type, rc, rc if single else rt, 4, 64, single_camera=single,
        use_quad=scene_type == "ftorf", tof_inverse_permutation=(2, 0, 3, 1))
    jf, tf = _frames(fid, fid, size_c, size_t, (0, 0 if single else 1))
    alive = np.ones(tp.xyz.shape[0], bool)
    alive[::17] = False
    jm, jc, jt = j_eval(jstatic, jp, jd, jnp.asarray(alive), jf)
    tm, tc, tt = t_eval(tstatic, tp, td, torch.tensor(alive), tf, device="cpu")
    assert sorted(tm) == sorted(jm)
    for name in jm:
        assert_close(tm[name], jm[name], ATOL, RTOL, name)
    _outputs_match(tt, jt)
    if not single:
        _outputs_match(tc, jc)
    else:
        assert tc is tt


def test_renderer_matches_jax():
    a, (jp, _), (tp, _) = _model(5)
    n = a["xyz"].shape[0]
    rng = np.random.default_rng(9)
    m = a["sh_color"].shape[1]
    offs = [(0.02 * rng.normal(size=s)).astype(np.float32)
            for s in ((n, 3), (n, 4), (n, m, 3), (n, m, 2))]
    bg = rng.uniform(0, 0.3, (7, 48, 64)).astype(np.float32)
    jcc, tcc = cameras(64, 48, seed=0, jitter=0.05)
    jct, tct = cameras(64, 48, seed=2, jitter=0.05)
    kw = dict(width=64, height=48, tile_w=16, max_per_tile=512)
    jstatic, tstatic = statics("torf", kw, kw, 2, 16)
    cfg_j, cfg_t = jstatic.config_tof, tstatic.config_tof
    common = dict(active_sh_degree=2, cam_phase_offset=0.1, cam_dc_offset=0.02)
    jd = jrenderer.render(jp, *map(jnp.asarray, offs), jcc, jct, cfg_j, cfg_j,
                          jnp.asarray(bg), **common)
    td = trenderer.render(tp, *map(torch.tensor, offs), tcc, tct, cfg_t,
                          cfg_t, torch.tensor(bg), **common, device="cpu")
    je = jrenderer.render_eval(jp, *map(jnp.asarray, offs), jcc, cfg_j,
                               jnp.asarray(bg), render_regions=("dynamic",),
                               **common)
    te = trenderer.render_eval(tp, *map(torch.tensor, offs), tcc, cfg_t,
                               torch.tensor(bg), render_regions=("dynamic",),
                               **common, device="cpu")
    for port, ref in ((td, jd), (te, je)):
        assert sorted(port) == sorted(ref)
        for k in ref:
            if k == "pixels":
                _pixels_match(port[k], ref[k])
            elif port[k].dtype in (torch.bool, torch.int32):
                np.testing.assert_array_equal(port[k].numpy(),
                                              np.asarray(ref[k]), k)
            else:
                assert_close(port[k], ref[k], ATOL, RTOL, k)


@pytest.mark.parametrize("name", ["ftorf", "torf"])
def test_configs_load_to_equal_fields(name):
    path = os.path.join(ROOT, "configs", f"{name}.json")
    assert TConfigFile.from_json(path).to_dict() == \
        JConfigFile.from_json(path).to_dict()
    over = {"num_points": 1234, "tile_w": 16}
    assert TConfigFile.from_json(path, over).to_dict() == \
        JConfigFile.from_json(path, over).to_dict()


def test_ply_written_by_jax_loads_equal(tmp_path):
    a = scene_arrays(13, 120)
    alive = np.ones(120, bool)
    alive[[0, 50, 119]] = False
    jparams = JParams(**{k: jnp.asarray(v) for k, v in a.items()})
    path = str(tmp_path / "point_cloud_full.ply")
    write_ply(path, gaussian_ply_props(jparams, jnp.asarray(alive), full=True))
    loaded = load_gaussians_from_ply(path, sh_degree=3, device="cpu")
    for name in loaded._fields:
        want = a[name] if name in ("phase_offset", "dc_offset") else a[name][alive]
        np.testing.assert_array_equal(getattr(loaded, name).numpy(), want, name)


def _entry_points():
    a = scene_arrays(0, 8)
    tp = gaussian_params_from_numpy(a, device="cpu")
    _, tcam = cameras(32, 16)
    size = dict(width=32, height=16)
    cfg = statics("torf", size, size, 2, 16)[1]
    zeros = [torch.zeros(s) for s in ((8, 3), (8, 4), (8, 16, 3), (8, 16, 2))]
    bg = torch.zeros((7, 16, 32))
    _, tframe = _frames(0, 0, (32, 16), (32, 16), (0, 0))
    net = init_deform(DeformConfig(depth=2, width=16), device="cpu")
    return {
        "eval_frame": lambda: t_eval(cfg, tp, net, torch.ones(8, dtype=bool),
                                     tframe),
        "render": lambda: trenderer.render(tp, *zeros, tcam, tcam,
                                           cfg.config_tof, cfg.config_tof, bg),
        "render_eval": lambda: trenderer.render_eval(tp, *zeros, tcam,
                                                     cfg.config_tof, bg),
        "camera": lambda: TCamera.create(np.eye(4), np.eye(4), 32, 16, 0.9,
                                         0.7),
        "params": lambda: gaussian_params_from_numpy(a),
        "init_deform": lambda: init_deform(DeformConfig(depth=2, width=16)),
    }


@pytest.mark.parametrize("entry", ["eval_frame", "render", "render_eval",
                                   "camera", "params", "init_deform"])
def test_entry_points_need_cuda_or_cpu_asked(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()
