"""The port's training CLI (``python -m gftorf_tpu_torch.train``) on the
CPU, against the root ``train.py`` of the JAX package.

Both CLIs train the same config on a dataset written by the JAX
generator; the port must write the same artifact tree, the same
``cfg_args_full.json`` and ``train_log.jsonl`` records with the same keys.
A PLY and a ``deform_model.npz`` written by the port load in the JAX
package (the other direction is tests/test_torch_render.py's). LPIPS with
synthetic AlexNet weights matches the JAX package's at rtol 1e-4 (two
fp32 convolution stacks), and is reported as null without weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gftorf_tpu.data.generate import write_dataset
from gftorf_tpu.models.deform import DeformConfig as JDeformConfig
from gftorf_tpu.models.deform import init_deform as j_init_deform
from gftorf_tpu.train.export import load_gaussians_from_ply as j_load_ply
from gftorf_tpu.utils import metrics as JM
from gftorf_tpu.utils.checkpoint import load_pytree as j_load_pytree
from gftorf_tpu_torch.train.__main__ import main
from gftorf_tpu_torch.utils import metrics as TM
from test_metrics import _synthetic_weights

ITERS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same config trained by train.py and by the port's CLI."""
    import train as j_train

    root = tmp_path_factory.mktemp("cli")
    src = str(root / "scene")
    np.random.seed(0)
    write_dataset(src, num_frames=8, width=64, height=48)
    cfg = dict(source_path=src, total_num_views=8, tof_image_width=64,
               tof_image_height=48, color_image_width=64,
               color_image_height=48, depth_range=15.0, num_points=500,
               iterations=ITERS, warm_up=20, use_quad=True, dynamic=True,
               dataset_type="quad", random_bg_color=True)
    path = str(root / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    flags = ["--config", path, "--test_iterations", "2", str(ITERS),
             "--save_iterations", str(ITERS), "--checkpoint_iterations", "2",
             str(ITERS), "--quiet"]
    j_dir, t_dir = str(root / "jax"), str(root / "port")
    j_train.main(flags + ["--model_path", j_dir, "--platform", "cpu"])
    trainer = main(flags + ["--model_path", t_dir, "--device", "cpu"])
    return dict(j=j_dir, t=t_dir, trainer=trainer, flags=flags, root=root)


def files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_artifact_tree_matches_train_py(runs):
    assert files(runs["t"]) == files(runs["j"])
    want = {"train_log.jsonl", "cfg_args_full.json", "cfg_args", "cameras.json",
            "input.ply", f"chkpnt{ITERS}.npz", "scene_bounds.png"} | {
        f"point_cloud/iteration_{ITERS}/{f}" for f in (
            "point_cloud.ply", "point_cloud_full.ply", "phase_offset.npy",
            "dc_offset.npy", "deform_model.npz")}
    assert want <= set(files(runs["t"]))


def test_config_and_log_match_train_py(runs):
    def cfg(d):
        with open(os.path.join(d, "cfg_args_full.json")) as f:
            c = json.load(f)
        c.pop("model_path")
        return c

    assert cfg(runs["t"]) == cfg(runs["j"])

    def log(d):
        with open(os.path.join(d, "train_log.jsonl")) as f:
            return [json.loads(line) for line in f]

    tl, jl = log(runs["t"]), log(runs["j"])
    # The port's step records carry train.py's keys and the step's
    # occupancy; its evaluation records, train.py's keys alone.
    occupancy = {"rendered", "tile_max", "flat"}
    assert [sorted(r) for r in tl] == [
        sorted(set(r) | (occupancy if "iter_time" in r else set()))
        for r in jl]
    evals = [r["eval"] for r in tl if "eval" in r]
    assert len(evals) == 2
    for e in evals:
        assert list(e["test"]) == list(next(r["eval"] for r in jl
                                            if "eval" in r)["test"])
        assert e["test"]["lpips"] is None
        assert all(np.isfinite(v) for k, v in e["test"].items() if k != "lpips")
    hist = [r["histograms"] for r in tl if "histograms" in r]
    assert sorted(hist[0]) == ["amplitude", "dist", "opacity", "scale"]


def test_port_ply_loads_in_jax(runs):
    tr = runs["trainer"]
    ply = os.path.join(runs["t"], f"point_cloud/iteration_{ITERS}/point_cloud_full.ply")
    jp = j_load_ply(ply)
    alive = tr.model.aux.alive.numpy()
    for name in ("xyz", "sh_color", "sh_phase", "sh_amp", "scaling", "rotation",
                 "opacity", "seg_color"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tr.model.params, name).numpy()[alive],
                                      err_msg=name)


def test_port_deform_model_loads_in_jax(runs):
    tr = runs["trainer"]
    c = tr.deform_cfg
    like = j_init_deform(jax.random.PRNGKey(0), JDeformConfig(
        depth=c.depth, width=c.width, xyz_multires=c.xyz_multires,
        t_multires=c.t_multires, sh_degree=c.sh_degree))
    tree, _ = j_load_pytree(os.path.join(
        runs["t"], f"point_cloud/iteration_{ITERS}/deform_model.npz"), like)
    for i in range(c.depth):
        np.testing.assert_array_equal(np.asarray(tree.hidden_w[i]),
                                      tr.deform[f"hidden.{i}.weight"].numpy().T)
    np.testing.assert_array_equal(np.asarray(tree.head_b["xyz"]),
                                  tr.deform["heads.xyz.bias"].numpy())


def test_resume_from_the_cli_checkpoint(runs):
    """--start_checkpoint resumes the saved state and trains on."""
    out = str(runs["root"] / "resumed")
    ck = os.path.join(runs["t"], "chkpnt2.npz")
    flags = list(runs["flags"])
    flags[flags.index("--test_iterations") + 1:
          flags.index("--save_iterations")] = [str(ITERS + 2)]
    tr = main(flags + ["--model_path", out, "--device", "cpu",
                       "--start_checkpoint", ck, "--iterations", str(ITERS + 2)])
    assert tr.iteration == ITERS + 2
    with open(os.path.join(out, "train_log.jsonl")) as f:
        its = [json.loads(line).get("iteration") for line in f]
    assert its[-1] == ITERS + 2 and 1 not in its


def test_cli_needs_cuda_without_device(tmp_path, runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = os.path.join(str(runs["root"]), "cfg.json")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", cfg, "--model_path", str(tmp_path / "m")])


@pytest.mark.parametrize("flag", [["--debug", "true", "--distributed"],
                                  ["--distributed"]])
def test_cli_rejects_unported_switches(tmp_path, runs, flag, capsys):
    """--distributed is refused outside the ranks of torch.distributed.run
    (under it the CLI trains on a mesh: tests/test_torch_sharded_cli.py),
    with or without --debug true (which the CLI takes:
    tests/test_torch_render_cli.py); --debug_nans is taken
    (tests/test_torch_debug_nans.py)."""
    cfg = os.path.join(str(runs["root"]), "cfg.json")
    with pytest.raises(SystemExit):
        main(["--config", cfg, "--model_path", str(tmp_path / "m"),
              "--device", "cpu"] + flag)
    if "--distributed" in flag:
        assert "torch.distributed.run" in capsys.readouterr().err


def test_lpips_with_synthetic_weights_matches_jax(tmp_path):
    w = _synthetic_weights(str(tmp_path / "w.npz"), key=3)
    rng = np.random.RandomState(4)
    a = rng.rand(3, 64, 80).astype(np.float32)
    b = np.clip(a + 0.15 * rng.randn(3, 64, 80).astype(np.float32), 0, 1)
    port = float(TM.lpips(torch.tensor(a), torch.tensor(b), weights_path=w))
    ref = float(JM.lpips(jnp.asarray(a), jnp.asarray(b), weights_path=w))
    np.testing.assert_allclose(port, ref, rtol=1e-4)
    assert float(TM.lpips(torch.tensor(a), torch.tensor(a), weights_path=w)) == 0.0
    assert not TM.lpips_available(str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError):
        TM.lpips(torch.tensor(a), torch.tensor(b),
                 weights_path=str(tmp_path / "absent.npz"))


def test_psnr_ssim_reexported():
    x = torch.rand(3, 16, 16, generator=torch.Generator().manual_seed(0))
    assert float(TM.ssim(x, x)) == pytest.approx(1.0, abs=1e-6)
    assert np.isinf(float(TM.psnr(x, x)))
