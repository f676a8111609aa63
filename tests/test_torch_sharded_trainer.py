"""The port's Trainer and train CLI under a (data, shard) mesh of
``torch.distributed`` ranks (gloo on the CPU, tests/torch_dist_ranks.py).

- Parity with the JAX Trainer under the same mesh (``mesh_shards`` 2, as
  ``tests/test_sharded_train.py::test_trainer_sharded_matches_single``
  runs it): both on one 64x48 scene written by the JAX generator, the
  port's starting state carried from the JAX Trainer (``weights.py``),
  random backgrounds off, 4 iterations across the end of warm-up (2) into
  the frozen-Gaussian phase (3) where the deform MLP steps. The records
  and the final state are held as tests/test_torch_trainer.py holds the
  single-device Trainer (its ``assert_states_close``), and every rank's
  state equals rank 0's bitwise.

Grow-and-replay under the mesh and the train CLI's ``--distributed`` are
in tests/test_torch_sharded_cli.py.
"""

import types

import numpy as np
import pytest

from gftorf_tpu.config import Config as JConfig
from gftorf_tpu.data.generate import write_dataset
from gftorf_tpu.train.loop import Trainer as JTrainer
from test_torch_trainer import LOSS_RTOL, assert_states_close, base_cfg
from torch_dist_ranks import run_ranks

ITERS = 4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("scene") / "s")
    np.random.seed(3)
    write_dataset(src, num_frames=8, width=64, height=48)
    return src


def _numpy_state(tr_j):
    """The JAX Trainer's state as ``weights.training_state_from_numpy``'s
    arguments."""
    m, d, da = tr_j.model, tr_j.deform, tr_j.deform_adam
    as_np = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}  # noqa: E731
    dl = lambda p: ([np.asarray(x) for x in p.hidden_w],  # noqa: E731
                    [np.asarray(x) for x in p.hidden_b],
                    {k: np.asarray(v) for k, v in p.head_w.items()},
                    {k: np.asarray(v) for k, v in p.head_b.items()})
    return dict(params=as_np(m.params), aux=as_np(m.aux),
                adam=(as_np(m.adam.mu), as_np(m.adam.nu), int(m.adam.step)),
                deform=dl(d), deform_adam=(dl(da.mu), dl(da.nu), int(da.step)),
                iteration=tr_j.iteration)


@pytest.fixture(scope="module")
def parity(scene_dir, tmp_path_factory):
    cfg = base_cfg(scene_dir, iterations=ITERS, warm_up=2, densify_until_iter=3,
                   densify_from_iter=100, lambda_flow=0.0, max_per_tile=512,
                   max_per_tile_limit=4096, random_bg_color=False,
                   num_points=600, mesh_shards=2)
    tr_j = JTrainer(JConfig.from_dict(cfg), startup_artifacts=False)
    state = _numpy_state(tr_j)
    ranks = run_ranks("trainer", 2, dict(cfg=cfg, state=state, iterations=ITERS),
                      str(tmp_path_factory.mktemp("trainer")))
    outs_j = []
    for _ in range(ITERS):
        outs_j += tr_j.step()
    outs_j += tr_j.drain()
    return tr_j, outs_j, ranks


def test_trainer_records_match_jax(parity):
    tr_j, outs_j, ranks = parity
    outs_t = ranks[0]["outs"]
    assert ranks[0]["buckets"] == (tr_j.render_bucket, tr_j.deform_bucket)
    assert [o["iteration"] for o in outs_t] == list(range(1, ITERS + 1))
    for a, b in zip(outs_t, outs_j):
        assert (a["iteration"], a["idx"], a["num_points"], a["tile_overflow"],
                a["dup_overflow"]) == (b["iteration"], b["idx"], b["num_points"],
                                       b["tile_overflow"], b["dup_overflow"])
        assert abs(a["visible"] - b["visible"]) <= 1, (a, b)
        for k in ("loss", "l1_p", "ema_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, err_msg=k)


def test_trainer_state_matches_jax(parity):
    tr_j, _, ranks = parity
    tree = ranks[0]["tree"]
    port = types.SimpleNamespace(_checkpoint_tree=lambda: tree)
    assert_states_close(port, tr_j)


def test_trainer_ranks_hold_equal_states(parity):
    from gftorf_tpu_torch.utils.checkpoint import tree_leaves

    _, _, ranks = parity
    first = [np.asarray(x) for x in tree_leaves(ranks[0]["tree"])]
    other = [np.asarray(x) for x in tree_leaves(ranks[1]["tree"])]
    assert len(first) == len(other) > 0
    for i, (a, b) in enumerate(zip(first, other)):
        np.testing.assert_array_equal(a, b, f"leaf {i}")
    assert [o["loss"] for o in ranks[0]["outs"]] == [o["loss"] for o in ranks[1]["outs"]]
