"""The (data, shard) mesh of ranks for multi-device training, on
``torch.distributed``.

Counterpart of ``gftorf_tpu/parallel/mesh.py``. The axes mean what they
mean there:

 - ``data``: camera data parallelism. Each data slice renders its own
   training camera per step; the gradients are averaged over the slices.
 - ``shard``: primitive and tile parallelism inside one render. The
   Gaussians (and the deform MLP's rows) are split over the shard axis
   for preprocessing, the tile grid by rows for compositing
   (``parallel/sharded.py``).

The JAX package is single-controller: one process owns every device and
a ``Mesh`` is a (data, shard) array of them. Here every rank is a
process (``torch.distributed.run``), the mesh is laid out as the JAX one,
``ranks.reshape(data, shard)``, and a rank holds the process groups of
its data slice (its row, the ``shard`` axis), of its shard column (the
``data`` axis) and of the whole mesh. The mesh must cover every rank:
JAX leaves devices past ``data * shard`` idle, but an idle rank here would
be a process that takes no part in the collectives.

Backends: ``nccl`` runs one rank per card (``cuda:LOCAL_RANK``); ``gloo``
runs ranks on the CPU, or ranks that share a card (their compute and
kernels on the card, the collectives staged through the host,
``parallel/collectives.py``). The caller states the backend, or it
follows the device; ``nccl`` with two ranks on one device raises and is
never swapped for ``gloo`` behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from gftorf_tpu_torch.utils.runtime import resolve_device

BACKENDS = ("nccl", "gloo")
# A rank that stops taking part in a collective (a failed or hung rank)
# makes the others raise after this long instead of waiting forever.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (data, shard) mesh."""

    data: int
    shard: int
    rank: int
    data_index: int  # this rank's data slice (row)
    shard_index: int  # this rank's place in its slice (column)
    shard_group: object  # the ranks of this data slice, in shard order
    data_group: object  # the ranks of this shard column, in data order
    group: object  # every rank of the mesh, in rank order
    backend: str

    @property
    def shape(self):
        return (self.data, self.shard)

    @property
    def size(self) -> int:
        return self.data * self.shard


def default_backend(device) -> str:
    """The backend that follows the device: ``nccl`` for CUDA (one rank
    per card), ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, devices: Sequence) -> None:
    """Raise unless ``backend`` can run ranks on ``devices`` (the device of
    each rank, in rank order): ``nccl`` takes CUDA devices, one rank per
    device; ``gloo`` takes any."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS}")
    if backend == "gloo":
        return
    devices = [torch.device(d) for d in devices]
    not_cuda = [r for r, d in enumerate(devices) if d.type != "cuda"]
    if not_cuda:
        raise ValueError(f"nccl runs on CUDA devices only; ranks {not_cuda} "
                         "are on the CPU: use backend 'gloo' there")
    seen = {}
    for r, d in enumerate(devices):
        key = (d.type, 0 if d.index is None else d.index)
        if key in seen:
            raise ValueError(
                f"nccl takes one rank per card, but ranks {seen[key]} and {r} "
                f"are both on {d}: give each rank its own card, or pass "
                "backend 'gloo' for ranks that share one")
        seen[key] = r


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(
                f"{name} is not set: run under torch.distributed.run (or set "
                "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)")
        return default
    return int(value)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``None`` or ``"cuda"``,
    a device with an index as given, or the CPU."""
    local = _env_int("LOCAL_RANK", 0)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device("cuda")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card of its own "
                f"({torch.cuda.device_count()} visible): pass a device such as "
                "'cuda:0' and backend 'gloo' for ranks that share a card")
        dev = torch.device("cuda", local)
    resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group from the ``torch.distributed.run``
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and return this rank's device (``rank_device``). ``backend`` defaults
    to ``default_backend`` of that device. Every rank's device is checked
    against the backend (``check_backend``) before the first collective
    of the caller; a mismatch raises on every rank."""
    dev = rank_device(device)
    backend = backend or default_backend(dev)
    check_backend(backend, [dev])  # this rank alone, before joining
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timeout)
    _MESHES.clear()
    # The devices travel over a gloo group, which works whatever the
    # devices are (an nccl group on a shared card would fail first).
    probe = dist.new_group(backend="gloo", timeout=timeout)
    devices = [None] * world
    dist.all_gather_object(devices, str(dev), group=probe)
    dist.destroy_process_group(probe)
    try:
        check_backend(backend, devices)
    except ValueError:
        dist.destroy_process_group()
        raise
    return dev


def make_mesh(data: int = 1, shard: int = -1) -> Mesh:
    """This rank's (data, shard) mesh over every rank of the default
    process group; ``shard=-1`` takes the ranks left over by ``data``.
    Every rank must call it, in the same order as its other group
    creations (``torch.distributed.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if shard == -1:
        shard = world // data
    if data < 1 or shard < 1 or data * shard != world:
        raise ValueError(
            f"mesh {data}x{shard} needs {data * shard} ranks, the process "
            f"group has {world}: every rank must be in the mesh")
    backend = dist.get_backend()
    rows = [dist.new_group([d * shard + s for s in range(shard)])
            for d in range(data)]
    cols = [dist.new_group([d * shard + s for d in range(data)])
            for s in range(shard)]
    d_idx, s_idx = divmod(rank, shard)
    return Mesh(data=data, shard=shard, rank=rank, data_index=d_idx,
                shard_index=s_idx, shard_group=rows[d_idx],
                data_group=cols[s_idx], group=dist.group.WORLD,
                backend=backend)


_MESHES: dict = {}


def cached_mesh(data: int, shard: int) -> Mesh:
    """One ``make_mesh(data, shard)`` per process group, so a step can
    find its mesh from ``StepStatic.mesh_shape`` (the JAX package's
    ``cached_mesh``). ``init_distributed`` clears it."""
    key = (data, shard)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(data, shard)
    return _MESHES[key]

