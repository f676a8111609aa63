"""The port's multi-device training step against the JAX package's:
ToRF, shard-only meshes.

One step from the same state (numpy, from a seed) under the meshes
(data, shard) = (1, 2) and (1, 4): the JAX ``train_step`` with
``mesh_shape`` (``shard_map`` over the virtual CPU devices of
tests/conftest.py) against the port's on gloo CPU ranks
(tests/torch_dist_ranks.py), at the tolerances of the JAX package's own
sharded-step test (loss rtol 1e-4, parameters and deform weights atol
2e-5 rtol 1e-3, xyz_grad_accum atol 1e-5 rtol 1e-3, denom exact) and
Adam's mu, the gradient, at the single-device parity tolerances, which a
gradient counted once per rank fails (tests/torch_port_util.py). Every
rank ends the step with bitwise the same state. The step also equals the
port's single-device step at those tolerances (its ``num_rendered``
aside: a mesh reports its deepest band's count times the shards). The
case is ``torch_port_util.torf_step_case``; the other meshes and scene
type are in the other tests/test_torch_sharded_train*.py files (one JAX
compile of a sharded step takes about 20 s on the CPU).
"""

import pytest

from torch_port_util import (
    SHARDED_CHECKS,
    check_sharded_step,
    sharded_step_runs,
    torf_step_case,
)

MESHES = [(1, 2), (1, 4)]
CASE = torf_step_case()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jstatic, tstatic, arrays, pairs, idx, it = CASE
    return sharded_step_runs(jstatic, tstatic, arrays, pairs, idx, it, MESHES,
                             str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("check", SHARDED_CHECKS)
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{s}" for d, s in MESHES])
def test_sharded_step(runs, mesh, check):
    check_sharded_step(runs, mesh, CASE[4], check)
