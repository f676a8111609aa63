"""Collectives of the multi-device step, in place of ``jax.lax.all_gather``
/ ``psum`` / ``pmax`` and the transpose JAX gives the all-gather.

Every float sum across ranks is taken in rank order from all-gathered
partials (``psum``), never by ``all_reduce``, whose order belongs to the
backend: so every rank of a group holds the same bits, and a rerun gives
them again. The Trainer relies on it: ranks whose states differ by one
bit could take different densify decisions and then wait forever in the
next collective. Maxima and integer counts, which any order gives
exactly, go the same way.

Only the all-gather along rows carries a gradient (``all_gather_rows``):
its backward is JAX's transpose of ``all_gather(tiled=True)``, the
cotangent summed over the group, then this rank's own rows. A loss
computed whole on every rank of a group and differentiated on each
therefore counts its gradient once per rank; the step seeds each rank's
backward with 1/ranks, as JAX's ``shard_map`` transpose scales a
replicated output's cotangent (``train/step.py``). No psum in the port
carries a gradient, so ``psum`` and ``pmax`` take none.

A group of one rank makes no collective call. On a ``gloo`` group, CUDA
tensors are copied to the host for the collective and the result back to
their card: the choice follows the group's backend, so ranks that share
one card over gloo compute there and exchange through the host, and an
``nccl`` group exchanges on the cards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order (no gradient)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach()[None]
    src = x.detach().contiguous()
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order (no gradient)."""
    parts = all_gather_stack(x, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (no gradient)."""
    return all_gather_stack(x, group).amax(0)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_stack(x, group).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        total = psum(g.reshape((n, ctx.rows) + tuple(g.shape[1:])), ctx.group)
        return total[dist.get_rank(ctx.group)], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order (each rank
    gives the same shape); differentiable like ``jax.lax.all_gather(...,
    tiled=True)``."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, group)
