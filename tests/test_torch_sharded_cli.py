"""The port's Trainer and train CLI under a mesh of ``torch.distributed``
ranks on the CPU (gloo, tests/torch_dist_ranks.py), without the JAX
package's Trainer (its parity is tests/test_torch_sharded_trainer.py).

- Grow-and-replay under the mesh (``mesh_shards`` 2): ``max_per_tile``
  and ``dup_factor`` far below the scene's need, random backgrounds on,
  and a densify event: one record per iteration, none overflowing, the
  ranks' states bitwise equal, and the run bitwise equal to one that
  started at the grown capacities. A Trainer whose mesh does not cover
  every rank raises.
- The CLI under ``python -m torch.distributed.run --nproc_per_node 2``
  with ``--distributed --device cpu``: rank 0 writes ``train.py``'s
  artifact tree, each record and evaluation once, and the ranks end with
  the same state digest (``Trainer.check_ranks_agree``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gftorf_tpu.data.generate import write_dataset
from test_torch_trainer import base_cfg
from torch_dist_ranks import free_port, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("scene") / "s")
    np.random.seed(3)
    write_dataset(src, num_frames=8, width=64, height=48)
    return src


@pytest.fixture(scope="module")
def grow(scene_dir, tmp_path_factory):
    cfg = base_cfg(scene_dir, num_points=3000, iterations=6, warm_up=2,
                   shrink_window=0, max_per_tile=128, max_per_tile_limit=4096,
                   dup_factor=1, dup_factor_limit=96, densify_from_iter=3,
                   densification_interval=4, densify_grad_threshold=1e-7,
                   random_bg_color=True, mesh_shards=2)
    return run_ranks("grow", 2, dict(cfg=cfg),
                     str(tmp_path_factory.mktemp("grow")))


def test_grow_and_replay_under_the_mesh(grow):
    r = grow[0]
    assert [o["iteration"] for o in r["outs"]] == list(range(1, 7))
    assert r["grown"][0] > 128 and r["grown"][1] > 1, r["grown"]
    assert all(o["tile_overflow"] == 0 and not o["dup_overflow"] for o in r["outs"])
    assert all(np.isfinite(o["loss"]) for o in r["outs"])
    # the densify event at iteration 4 changed the point count
    assert r["outs"][3]["num_points"] != r["outs"][4]["num_points"]
    # the replayed run equals a run that started at the grown capacities
    assert [o["loss"] for o in r["outs2"]] == [o["loss"] for o in r["outs"]]
    for a, b in zip(r["state"], r["state2"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grow_ranks_hold_equal_states(grow):
    for key in ("state", "state2"):
        for i, (a, b) in enumerate(zip(grow[0][key], grow[1][key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f"{key} {i}")
    assert grow[0]["grown"] == grow[1]["grown"]


def test_mesh_must_cover_every_rank(grow):
    for r in grow:
        assert "every rank must be in the mesh" in r["mismatch"]


def test_train_cli_distributed_writes_the_tree_once(scene_dir, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    gftorf_tpu_torch.train --distributed --device cpu``: rank 0 writes
    ``train.py``'s artifact tree, each record and evaluation once."""
    out = str(tmp_path / "model")
    cfg = base_cfg(scene_dir, model_path=out, iterations=6, warm_up=2,
                   num_points=600, densify_from_iter=100, D=2, W=32)
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = ROOT
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "-m", "gftorf_tpu_torch.train", "--config", path, "--distributed",
           "--device", "cpu", "--mesh_shards", "2", "--quiet",
           "--test_iterations", "1", "6", "--save_iterations", "6",
           "--checkpoint_iterations", "6"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Training complete") == 1, proc.stdout
    assert proc.stdout.count("ranks agree: state digest") == 1, proc.stdout
    want = ["train_log.jsonl", "cfg_args_full.json", "cfg_args", "cameras.json",
            "cameras_full.json", "nerf_normalization.json", "input.ply",
            "chkpnt6.npz"] + [f"point_cloud/iteration_6/{f}" for f in (
                "point_cloud.ply", "point_cloud_full.ply", "phase_offset.npy",
                "dc_offset.npy", "deform_model.npz")]
    missing = [f for f in want if not os.path.isfile(os.path.join(out, f))]
    assert not missing, missing
    with open(os.path.join(out, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["iteration"] for r in recs if "eval" in r] == [1, 6]
    assert [r["iteration"] for r in recs if "loss" in r] == [1]
    for r in recs:
        if "eval" in r:
            assert np.isfinite(r["eval"]["test"]["mae_d_tof"])
