"""The train CLI's ``--debug_nans`` (``utils/debug_nans.py``) on the CPU.
About 35 s in one process, 12 s of it the JAX CLI's run. The NaN
checkpoint comes from ``chip_smoke.nan_checkpoint``, which the
``[debug_nans]`` phase uses on the card.

- A clean run with the switch, an evaluation included, gives the same
  bits as one without it: the same losses and the same state digest
  (``Trainer.check_ranks_agree``).
- A checkpoint with one NaN in a live Gaussian's opacity resumes without
  the switch (no evaluation: its histograms refuse a NaN in either
  package) and raises ``FloatingPointError`` with it; the root
  ``train.py --debug_nans`` (``jax_debug_nans``) raises on the same
  checkpoint, in a subprocess.
- The mode raises at a backward op that makes a NaN (a norm's gradient at
  0), and the kernel wrappers' output check raises only inside the mode.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from chip_smoke import nan_checkpoint
from gftorf_tpu_torch.data.generate import write_dataset
from gftorf_tpu_torch.train.__main__ import main
from gftorf_tpu_torch.utils import debug_nans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 64x48 ftorf scene, a small config (the deform MLP and the flow
    loss on from iteration 3) and a checkpoint at iteration 3."""
    root = tmp_path_factory.mktemp("dn")
    src = str(root / "scene")
    write_dataset(src, num_frames=8, width=64, height=48, device="cpu")
    cfg = dict(source_path=src, total_num_views=8, tof_image_width=64,
               tof_image_height=48, color_image_width=64,
               color_image_height=48, depth_range=15.0, num_points=500,
               iterations=ITERS, warm_up=2, use_quad=True, dynamic=True,
               dataset_type="quad", random_bg_color=True, D=2, W=32)
    path = str(root / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root, path


def cli(cfg, model_path, *flags, evals=(0,)):
    return main(["--config", cfg, "--model_path", model_path, "--device",
                 "cpu", "--quiet", "--test_iterations", *map(str, evals),
                 *flags])


def test_clean_run_same_bits(setup):
    root, cfg = setup
    on = cli(cfg, str(root / "on"), "--debug_nans", evals=(ITERS,))
    off = cli(cfg, str(root / "off"), evals=(ITERS,))
    assert [r["loss"] for r in on.history] == [r["loss"] for r in off.history]
    assert on.check_ranks_agree() == off.check_ranks_agree()
    assert not debug_nans.active() and not torch.is_anomaly_enabled()


def test_nan_checkpoint_raises_only_with_switch(setup):
    root, cfg = setup
    tr = cli(cfg, str(root / "ckpt"), "--iterations", "3",
             "--checkpoint_iterations", "3")
    bad = nan_checkpoint(tr, str(root / "ckpt" / "chkpnt3.npz"),
                         str(root / "nan.npz"))
    resumed = cli(cfg, str(root / "resumed"), "--start_checkpoint", bad)
    assert resumed.iteration == ITERS
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        cli(cfg, str(root / "raised"), "--start_checkpoint", bad,
            "--debug_nans")
    assert not debug_nans.active()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "train.py"), "--config", cfg,
         "--model_path", str(root / "jax"), "--platform", "cpu", "--quiet",
         "--test_iterations", "0", "--start_checkpoint", bad, "--debug_nans"],
        cwd=str(root), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                 JAX_COMPILATION_CACHE_DIR=str(root / "jax_cache")))
    assert proc.returncode != 0
    assert "FloatingPointError" in proc.stderr, proc.stderr[-2000:]


def test_backward_nan_and_wrapper_check():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        with debug_nans.nan_checks():
            torch.linalg.vector_norm(x).backward()
    nan = torch.tensor([1.0, float("nan")])
    debug_nans.check_output("a kernel", nan)  # outside the mode: no check
    with pytest.raises(FloatingPointError, match="a kernel"):
        with debug_nans.nan_checks():
            debug_nans.check_output("a kernel", nan)
    assert not debug_nans.active() and not torch.is_anomaly_enabled()
