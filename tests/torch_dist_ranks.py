"""Ranks of the port's multi-device tests (tests/test_torch_sharded*.py).

``run_ranks(job, world, payload, out_dir)`` starts ``world`` processes in
the ``spawn`` context of multiprocessing, on a free localhost port, each
joining a gloo process group on the CPU (``parallel.mesh.
init_distributed``) and running ``JOBS[job](payload)``; it returns every
rank's result in rank order. A rank that raises, or a run that outlives
its timeout, fails the caller with the rank's traceback, and every rank
is killed. This module imports only torch and the port: the ranks never
load JAX (the reference runs in the test's own process).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
import traceback

import torch

RANK_THREADS = 2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(job, rank, world, port, in_path, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(RANK_THREADS)
    import torch.distributed as dist

    from gftorf_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed(device="cpu", timeout_s=120)
        payload = torch.load(in_path, weights_only=False)
        result = JOBS[job](payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job: str, world: int, payload, out_dir: str, timeout: float = 180.0):
    """Run ``JOBS[job](payload)`` on ``world`` gloo CPU ranks; returns the
    list of their results."""
    import multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "payload.pt")
    torch.save(payload, in_path)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(job, r, world, port, in_path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if failed or hung:
        errs = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        raise AssertionError(
            f"{job}: ranks {failed} failed, ranks {hung} killed (still running "
            f"then; timeout {timeout} s)\n" + "\n".join(errs))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Jobs: each takes the payload and returns what rank 0 reports, plus
# whatever the test holds equal across ranks.


def job_rasterize(payload):
    """``rasterize_sharded`` over every rank, per case: the outputs and the
    gradients of a loss over every image output with respect to every
    input (each rank's seeded 1/n and summed over the ranks, as the
    sharded step does)."""
    import torch.distributed as dist

    from gftorf_tpu_torch.parallel.collectives import psum
    from gftorf_tpu_torch.parallel.sharded import rasterize_sharded

    n = dist.get_world_size()
    results = []
    for case in payload["cases"]:
        x = {k: torch.tensor(v, requires_grad=k in payload["inputs"])
             for k, v in case["x"].items()}
        out = rasterize_sharded(
            x["means3d"], x["scales"], x["rotations"], x["opacities"],
            x["shs"], x["shs_p"], x["phase_offset"], x["dc_offset"],
            x["means2d_ndc"], x["bg_map"], camera=case["camera"],
            config=case["config"], active_sh_degree=3,
            alive=None if case.get("alive") is None else torch.tensor(case["alive"]),
            flow_precomp=x.get("flow"))
        res = {"out": {k: (v.detach() if torch.is_tensor(v) else v)
                       for k, v in out._asdict().items()}}
        if case.get("maps") is not None:
            total = 0.0
            for k, m in case["maps"].items():
                img = getattr(out, k)
                total = total + (img * torch.tensor(m)
                                 * (img if k == "flow" else 1.0)).sum()
            names = [k for k in payload["inputs"] if k in x]
            grads = torch.autograd.grad(total, [x[k] for k in names],
                                        grad_outputs=torch.tensor(1.0 / n),
                                        allow_unused=True)
            grads = [None if g is None else psum(g, dist.group.WORLD)
                     for g in grads]
            res["loss"] = total.detach()
            res["grads"] = dict(zip(names, grads))
        results.append(res)
    return results


def job_step(payload):
    """``train_step`` under each mesh of ``payload["meshes"]`` (every rank
    of the world in it), from the same state: the new state and metrics,
    as numpy."""
    from gftorf_tpu_torch.train.step import train_step
    from gftorf_tpu_torch.weights import training_state_from_numpy

    a = payload["arrays"]
    results = {}
    for mesh in payload["meshes"]:
        state = training_state_from_numpy(
            a["params"], a["aux"], a["adam"], a["deform"], a["deform_adam"], 0,
            payload["static"].deform, device="cpu")
        static = dataclasses.replace(payload["static"], mesh_shape=tuple(mesh))
        idx = payload["idx"][: mesh[0]]
        if mesh[0] == 1:
            idx = idx[0]
        out = train_step(static, state.model, state.deform, state.deform_adam,
                         payload["frames"], idx, payload["it"])
        results[tuple(mesh)] = out
    return results


def _trainer(cfg: dict):
    from gftorf_tpu_torch.config import Config
    from gftorf_tpu_torch.train.loop import Trainer

    return Trainer(Config.from_dict(cfg), startup_artifacts=False, device="cpu")


def _run(tr, n):
    outs = []
    for _ in range(n):
        outs += tr.step()
    return outs + tr.drain()


def _state_leaves(tr):
    from gftorf_tpu_torch.utils.checkpoint import tree_leaves

    return [x.numpy() if torch.is_tensor(x) else x
            for x in tree_leaves(tr._checkpoint_tree())]


def job_trainer(payload):
    """A Trainer under the mesh of ``payload["cfg"]`` from a given starting
    state (``payload["state"]``, ``weights.training_state_from_numpy``'s
    arguments) for ``payload["iterations"]``: its records and final
    state (the checkpoint tree)."""
    import random

    from gftorf_tpu_torch.weights import training_state_from_numpy

    cfg = payload["cfg"]
    tr = _trainer(cfg)
    st = training_state_from_numpy(**payload["state"], config=tr.deform_cfg,
                                   device="cpu")
    tr.model, tr.deform, tr.deform_adam = st.model, st.deform, st.deform_adam
    tr._update_deform_bucket()
    random.seed(cfg.get("seed", 0))
    outs = _run(tr, payload["iterations"])
    return {"outs": outs, "tree": tr._checkpoint_tree(),
            "buckets": (tr.render_bucket, tr.deform_bucket)}


def job_grow(payload):
    """A Trainer under the mesh whose capacities are too small (grow-and-
    replay), then one that starts at the grown capacities: both runs'
    records, the grown capacities and the final states; and the error of a
    Trainer whose mesh does not cover the process group."""
    cfg = payload["cfg"]
    tr = _trainer(cfg)
    outs = _run(tr, cfg["iterations"])
    grown = (tr.tile_cap, tr.dup_factor)
    again = _trainer(dict(cfg, max_per_tile=grown[0], dup_factor=grown[1]))
    outs2 = _run(again, cfg["iterations"])
    try:
        _trainer(dict(cfg, mesh_shards=1))
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    return {"outs": outs, "outs2": outs2, "grown": grown,
            "state": _state_leaves(tr), "state2": _state_leaves(again),
            "mismatch": mismatch}


def job_mesh(payload):
    """``make_mesh`` for each (data, shard) of the payload: this rank's
    coordinates, or the error it raised."""
    from gftorf_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for shape in payload["shapes"]:
        try:
            m = make_mesh(*shape)
            out[tuple(shape)] = (m.rank, m.data_index, m.shard_index,
                                 m.backend, m.size)
        except ValueError as e:
            out[tuple(shape)] = str(e)
    return out


def job_many(payload):
    """Several jobs in one set of ranks: ``[(job, payload), ...]``."""
    return [JOBS[job](p) for job, p in payload]


JOBS = {"rasterize": job_rasterize, "step": job_step, "mesh": job_mesh,
        "trainer": job_trainer, "grow": job_grow, "many": job_many}
