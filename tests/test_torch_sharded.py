"""The port's multi-device rasterizer (``parallel/sharded.py``), its mesh
and backends (``parallel/mesh.py``), the flat binning of a band of tile
rows, and the packages' public names, against the JAX package.

``rasterize_sharded`` runs on gloo CPU ranks (tests/torch_dist_ranks.py)
over 2 and 4 shards; the JAX ``rasterize_sharded`` under ``shard_map``
over the virtual CPU devices of tests/conftest.py, on the same scene
(numpy, from a seed). Every ``RenderOutputs`` field is held against
JAX's and against the port's single-device ``rasterize``: images at atol
1e-5 rtol 1e-4, integers exactly; and the gradients of a loss over every
image output with respect to every input at atol 2e-5 rtol 1e-3 (each
rank seeds 1/n and the ranks' gradients are summed, as the sharded step
does). 64x48 pixels in 16x16 tiles: three tile rows, so four shards
leave one band empty. The flat-stream render equals the dense one (at
those tolerances on the CPU); a scene squashed into one band reports the
deepest band's need in ``rendered_worst``, as JAX does; every rank holds
bitwise the same outputs. A scene of 241 Gaussians, some of them not
``alive``, divides by neither shard count, so its rows (``flow_precomp``
and ``alive`` too) are padded to ``per * n`` and the pixel counts and
radii are cut back to 241; it is held against JAX's sharded render.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gftorf_tpu.parallel.mesh import make_mesh as j_make_mesh
from gftorf_tpu.parallel.sharded import rasterize_sharded as j_rasterize_sharded
from gftorf_tpu.render.settings import RasterConfig as JConfig
from gftorf_tpu_torch.render.rasterize import rasterize as t_rasterize
from gftorf_tpu_torch.render.settings import RasterConfig as TConfig
from torch_dist_ranks import run_ranks
from torch_port_util import assert_close, cameras, scene_arrays

W, H = 64, 48
IMG_ATOL, IMG_RTOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SHARDS = (2, 4)
INPUTS = ("means3d", "scales", "rotations", "opacities", "shs", "shs_p",
          "phase_offset", "dc_offset", "means2d_ndc", "bg_map", "flow")
IMAGES = {"color": 3, "phasor": 7, "depth": 1, "acc": 1,
          "depth_distortion": 1, "distribution": 3, "flow": 6}
INTEGERS = ("radii", "num_rendered", "dup_overflow", "tile_overflow",
            "tile_max")
CFG = dict(height=H, width=W, tile_h=16, tile_w=16, max_per_tile=512)
ODD_P = 241  # divides by no shard count: the rows are padded


def _inputs(seed, n=240, height=H, squash=1.0):
    a = scene_arrays(seed, n)
    a["xyz"][:, 1] *= squash
    rng = np.random.default_rng(seed + 3)
    x = dict(
        means3d=a["xyz"], scales=np.exp(a["scaling"]), rotations=a["rotation"],
        opacities=1.0 / (1.0 + np.exp(-a["opacity"][:, 0])),
        shs=a["sh_color"], shs_p=np.stack([a["sh_phase"], a["sh_amp"]], -1),
        phase_offset=np.float32(0.1), dc_offset=np.float32(0.02),
        means2d_ndc=np.zeros((n, 2)), bg_map=rng.uniform(-1, 1, (7, height, W)),
        flow=rng.normal(size=(n, 6)),
    )
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    maps = {k: rng.uniform(-1, 1, (c, height, W)).astype(np.float32)
            for k, c in IMAGES.items() if k != "distribution"}
    return x, maps


def _loss(out, maps, lib):
    total = 0.0
    for k, m in maps.items():
        img = getattr(out, k)
        total = total + lib.sum(img * m * (img if k == "flow" else 1.0))
    return total


def _jax_sharded(x, maps, n, jcam, cfg, alive=None):
    mesh = j_make_mesh(data=1, shard=n)
    alive = None if alive is None else jnp.asarray(alive)

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(),
                       check_vma=False)
    def render(a):
        return j_rasterize_sharded(
            a["means3d"], a["scales"], a["rotations"], a["opacities"], a["shs"],
            a["shs_p"], a["phase_offset"], a["dc_offset"], a["means2d_ndc"],
            a["bg_map"], camera=jcam, config=cfg, axis_name="shard",
            alive=alive, flow_precomp=a["flow"])

    def loss(a):
        out = render(a)
        return _loss(out, {k: jnp.asarray(v) for k, v in maps.items()}, jnp), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in x.items()})
    return out, grads


def _port_single(x, maps, tcam, cfg):
    t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
    out = t_rasterize(
        t["means3d"], t["scales"], t["rotations"], t["opacities"], t["shs"],
        t["shs_p"], t["phase_offset"], t["dc_offset"], t["means2d_ndc"],
        t["bg_map"], camera=tcam, config=cfg, flow_precomp=t["flow"])
    _loss(out, {k: torch.tensor(v) for k, v in maps.items()}, torch).backward()
    out = type(out)(*(v.detach() if torch.is_tensor(v) else v for v in out))
    return out, {k: t[k].grad for k in INPUTS}


@pytest.fixture(scope="module")
def scene():
    x, maps = _inputs(7)
    jcam, tcam = cameras(W, H, seed=4, jitter=0.05)
    skew, _ = _inputs(9, height=64, squash=0.05)
    jcam64, tcam64 = cameras(W, 64, seed=4)
    odd, _ = _inputs(11, n=ODD_P)
    alive = np.random.default_rng(12).uniform(size=ODD_P) > 0.2
    alive[-1] = True
    return dict(x=x, maps=maps, jcam=jcam, tcam=tcam, skew=skew,
                jcam64=jcam64, tcam64=tcam64, odd=odd, alive=alive)


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """Each shard count's ranks: the dense render with gradients, the flat
    render with gradients, the skewed 64x64 scene, the padded scene dense
    and flat with gradients; and the mesh shapes."""
    s = scene
    cases = [
        dict(x=s["x"], camera=s["tcam"], config=TConfig(**CFG), maps=s["maps"]),
        dict(x=s["x"], camera=s["tcam"], maps=s["maps"],
             config=TConfig(**CFG, flat_stream=True)),
        dict(x=s["skew"], camera=s["tcam64"],
             config=TConfig(**dict(CFG, height=64))),
        dict(x=s["odd"], camera=s["tcam"], config=TConfig(**CFG),
             maps=s["maps"], alive=s["alive"]),
        dict(x=s["odd"], camera=s["tcam"], maps=s["maps"], alive=s["alive"],
             config=TConfig(**CFG, flat_stream=True)),
    ]
    out = {}
    for n in SHARDS:
        jobs = [("rasterize", dict(inputs=INPUTS, cases=cases)),
                ("mesh", dict(shapes=[(1, n), (n, 1), (1, -1), (n, 2), (1, n + 1)]))]
        out[n] = run_ranks("many", n, jobs,
                           str(tmp_path_factory.mktemp(f"shard{n}")))
    return out


@pytest.fixture(scope="module")
def references(scene):
    s = scene
    jcfg = JConfig(**CFG)
    ref = {"single": _port_single(s["x"], s["maps"], s["tcam"], TConfig(**CFG))}
    for n in SHARDS:
        ref[n] = _jax_sharded(s["x"], s["maps"], n, s["jcam"], jcfg)
        ref["odd", n] = _jax_sharded(s["odd"], s["maps"], n, s["jcam"], jcfg,
                                     alive=s["alive"])
    return ref


def _check_outputs(got, want, what):
    for k in IMAGES:
        assert_close(got[k], getattr(want, k), IMG_ATOL, IMG_RTOL, f"{what}: {k}")
    for k in INTEGERS:
        np.testing.assert_array_equal(
            np.asarray(got[k]), np.asarray(getattr(want, k)), f"{what}: {k}")
    np.testing.assert_array_equal(np.asarray(got["pixels"]),
                                  np.asarray(want.pixels), f"{what}: pixels")


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_render_matches_jax(ranks, references, n):
    got = ranks[n][0][0][0]
    want, _ = references[n]
    _check_outputs(got["out"], want, f"{n} shards vs JAX")
    for k in ("num_rendered", "rendered_worst"):
        assert int(got["out"][k]) == int(getattr(want, k)), k


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_gradients_match_jax(ranks, references, n):
    got = ranks[n][0][0][0]["grads"]
    _, want = references[n]
    for k in INPUTS:
        assert_close(got[k], want[k], GRAD_ATOL, GRAD_RTOL, f"d loss / d {k}")


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_matches_single_device(ranks, references, n):
    got = ranks[n][0][0][0]
    out, grads = references["single"]
    _check_outputs(got["out"], out, f"{n} shards vs one device")
    for k in INPUTS:
        assert_close(got["grads"][k], grads[k], GRAD_ATOL, GRAD_RTOL,
                     f"d loss / d {k}")
    assert float(got["grads"]["means2d_ndc"].abs().sum()) > 0


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_flat_equals_dense(ranks, n):
    """On the CPU the plain compositors sum a flat tile over its own depth
    and a dense one over max_per_tile lanes, so the two agree at the image
    and gradient tolerances (bitwise on the card, chip_smoke.py), with
    equal integers."""
    _check_flat_equals_dense(*ranks[n][0][0][:2])


def _check_flat_equals_dense(dense, flat):
    for k, v in dense["out"].items():
        if k == "tile_overflow":
            assert int(flat["out"][k]) == 0 == int(v)
        elif k in IMAGES:
            assert_close(flat["out"][k], v, IMG_ATOL, IMG_RTOL, k)
        elif torch.is_tensor(v):
            assert torch.equal(flat["out"][k], v), k
    for k, v in dense["grads"].items():
        assert_close(flat["grads"][k], v, GRAD_ATOL, GRAD_RTOL, k)


@pytest.mark.parametrize("n", SHARDS)
def test_padded_rows_match_jax(scene, ranks, references, n):
    """241 Gaussians over 2 and 4 shards: rows padded to ``per * n`` (the
    features, ``flow_precomp`` and ``alive``), instance ids into the
    padded layout, pixel counts and radii cut back to 241; outputs and
    gradients against JAX's sharded render, which drops the padded ids
    in its segment sum."""
    got = ranks[n][0][0][3]
    want, want_grads = references["odd", n]
    assert got["out"]["radii"].shape == (ODD_P,)
    assert got["out"]["pixels"].shape == (ODD_P, 1)
    _check_outputs(got["out"], want, f"{ODD_P} Gaussians, {n} shards vs JAX")
    for k in ("num_rendered", "rendered_worst"):
        assert int(got["out"][k]) == int(getattr(want, k)), k
    for k in INPUTS:
        assert got["grads"][k].shape == want_grads[k].shape, k
        assert_close(got["grads"][k], want_grads[k], GRAD_ATOL, GRAD_RTOL,
                     f"{ODD_P} Gaussians: d loss / d {k}")
    dead = torch.tensor(~scene["alive"])
    assert float(got["out"]["pixels"][dead].abs().sum()) == 0.0
    assert float(got["out"]["pixels"].sum()) > 0.0


@pytest.mark.parametrize("n", SHARDS)
def test_padded_rows_flat_equals_dense(ranks, n):
    """The padded scene's flat render equals its dense one (at the image
    and gradient tolerances on the CPU), integers exactly."""
    _check_flat_equals_dense(*ranks[n][0][0][3:5])


@pytest.mark.parametrize("n", SHARDS)
def test_ranks_hold_equal_outputs(ranks, n):
    first = ranks[n][0][0]
    for r, other in enumerate(ranks[n][1:], 1):
        for case, (a, b) in enumerate(zip(first, other[0])):
            for k, v in a["out"].items():
                if torch.is_tensor(v):
                    assert torch.equal(b["out"][k], v), (r, case, k)
            for k, v in a.get("grads", {}).items():
                assert torch.equal(b["grads"][k], v), (r, case, k)


def test_rendered_worst_tracks_skewed_shard(scene, ranks):
    """A scene squashed into one band of tile rows (the JAX package's
    ``test_rendered_worst_tracks_skewed_shard``): rendered_worst is the
    deepest band's num_rendered times the shards, as JAX reports it."""
    s = scene
    jcfg = JConfig(**dict(CFG, height=64))
    want, _ = _jax_sharded(s["skew"], {}, 4, s["jcam64"], jcfg)
    got = ranks[4][0][0][2]["out"]
    total, worst = int(got["num_rendered"]), int(got["rendered_worst"])
    assert total == int(want.num_rendered) and worst == int(want.rendered_worst)
    assert worst >= int(1.5 * total)


@pytest.mark.parametrize("n", SHARDS)
def test_make_mesh(ranks, n):
    for r, res in enumerate(ranks[n]):
        shapes = res[1]
        assert shapes[(1, n)] == (r, 0, r, "gloo", n)
        assert shapes[(n, 1)] == (r, r, 0, "gloo", n)
        assert shapes[(1, -1)] == (r, 0, r, "gloo", n)
        for bad in ((n, 2), (1, n + 1)):
            assert "every rank must be in the mesh" in shapes[bad], shapes[bad]


def test_bin_gaussians_flat_num_tiles():
    """The flat binning of one band of tile rows equals JAX's exactly. JAX's
    sharded flat path passes ``num_tiles`` = the band's tiles; the port's
    takes the band's own config, whose ``num_tiles`` is that count."""
    from gftorf_tpu.render.binning import bin_gaussians_flat as j_bin
    from gftorf_tpu.render.preprocess import preprocess as j_pre
    from gftorf_tpu_torch.render.binning import bin_gaussians_flat as t_bin

    x, _ = _inputs(21, n=300)
    jcam, _ = cameras(W, H, seed=21)
    jcfg = JConfig(**CFG)
    pre = j_pre(*(jnp.asarray(x[k]) for k in INPUTS[:8]),
                jnp.asarray(x["means2d_ndc"]), jcam, jcfg, 3)
    rect = np.asarray(pre.rect)
    for row0, rows in ((0, 1), (1, 1), (1, 2)):
        band = rect.copy()
        band[:, 1] = np.clip(rect[:, 1] - row0, 0, rows)
        band[:, 3] = np.clip(rect[:, 3] - row0, 0, rows)
        kw = dict(CFG, height=rows * 16)
        T = rows * jcfg.grid_w
        want = j_bin(jnp.asarray(band), pre.depth_view, pre.valid, JConfig(**kw),
                     1024, num_tiles=T)
        got = t_bin(torch.tensor(band), torch.tensor(np.asarray(pre.depth_view)),
                    torch.tensor(np.asarray(pre.valid)), TConfig(**kw), 1024)
        for k in want._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)), k)
        assert got.tile_count.shape == (T,)


@pytest.mark.parametrize("devices,ok", [
    (["cuda:0", "cuda:1"], True),
    (["cuda:0", "cuda:0"], False),
    (["cuda", "cuda:0"], False),
    (["cpu", "cpu"], False),
], ids=["one_card_each", "shared_card", "shared_default_card", "cpu"])
def test_nccl_backend_check(devices, ok):
    """nccl takes one rank per card; two ranks on one device raise, and the
    message names gloo (nothing swaps the backend behind the caller)."""
    from gftorf_tpu_torch.parallel.mesh import check_backend, default_backend

    check_backend("gloo", devices)
    if ok:
        check_backend("nccl", devices)
    else:
        with pytest.raises(ValueError, match="gloo"):
            check_backend("nccl", devices)
    assert default_backend("cuda:1") == "nccl" and default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        check_backend("mpi", devices)


def test_mesh_without_process_group_raises():
    """A Trainer asked for a mesh outside torch.distributed.run raises
    before it loads anything."""
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.train.loop import Trainer

    cfg = Config.from_dict(dict(source_path="/nonexistent", mesh_shards=2))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        Trainer(cfg, device="cpu")


JAX_EXPORTS = {
    "ops": "gftorf_tpu.ops", "models": "gftorf_tpu.models",
    "render": "gftorf_tpu.render", "parallel": "gftorf_tpu.parallel",
}
# render/oracle.py is a test-only numpy oracle: the port's tests call the
# JAX package's.
NOT_PORTED = {"rasterize_oracle"}


@pytest.mark.parametrize("package", list(JAX_EXPORTS))
def test_package_exports(package):
    """Every public name of a JAX package's __init__ resolves in the
    port's package of the same name."""
    import importlib
    import inspect

    jmod = importlib.import_module(JAX_EXPORTS[package])
    tmod = importlib.import_module(f"gftorf_tpu_torch.{package}")
    names = {k for k, v in vars(jmod).items()
             if not k.startswith("_") and not inspect.ismodule(v)}
    missing = sorted(names - NOT_PORTED - set(vars(tmod)))
    assert names - NOT_PORTED and not missing, missing


def test_tof_from_depth_matches_jax():
    from gftorf_tpu.ops import tof_from_depth as j_fn
    from gftorf_tpu_torch.ops import tof_from_depth as t_fn

    depth = np.random.default_rng(0).uniform(0.5, 9.0, (5, 7)).astype(np.float32)
    for amp, off in ((1.0, 0.0), (2.0, 0.3)):
        assert_close(t_fn(torch.tensor(depth), amp, 10.0, off),
                     j_fn(jnp.asarray(depth), amp, 10.0, off), 1e-6, 1e-6)
