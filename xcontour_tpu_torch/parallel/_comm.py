"""The collectives of the sharded functions, over one process group.

The JAX package's ``shard_map`` bodies call ``lax.psum``, ``lax.pmin`` /
``pmax`` (through GSPMD), ``lax.all_gather`` and ``lax.ppermute``.  Here
each is a function of a ``torch.distributed`` group, usually a mesh
axis's (``mesh.get_group("x")``):

* :func:`sum_`, :func:`min_`, :func:`max_`: an all-reduce into a new
  tensor (the input is left as it was);
* :func:`all_gather`: the members' blocks joined along ``dim`` in group
  rank order (``lax.all_gather(..., tiled=True)``);
* :func:`shift`: ``lax.ppermute`` with the pairs (i, (i + offset) % n):
  member j receives member (j - offset) % n's block;
* :func:`broadcast`: one member's tensor on every member;
* :func:`gather`: every member's block on one member (the runner's
  outputs, which only the writing rank needs).

The sharded functions use ``all_reduce``, ``all_gather_into_tensor`` and
``broadcast``, which both backends take on CUDA tensors.  Gloo does not take point to
point ones there (torch 2.11 on an H100: ``send``/``recv`` and
``batch_isend_irecv`` of CUDA tensors fail with "writev: Bad address";
``chip_smoke.py`` phase 11 probes each collective), so the ring shift is
an all-gather of which each member keeps its neighbour's block: the halo
columns are small.  Nothing is copied to the host here.  A group of one
runs no collective at all: the ring of one is the identity, as
``ppermute`` is on an axis of size 1.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# collectives run, by kind: read by the tests and chip_smoke.py
CALLS = collections.Counter()


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _reduce(t: torch.Tensor, op, group, kind: str) -> torch.Tensor:
    out = t.contiguous().clone()
    if size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
        CALLS[kind] += 1
    return out


def sum_(t: torch.Tensor, group) -> torch.Tensor:
    """The members' tensors summed (``lax.psum``)."""
    return _reduce(t, dist.ReduceOp.SUM, group, "sum")


def min_(t: torch.Tensor, group) -> torch.Tensor:
    return _reduce(t, dist.ReduceOp.MIN, group, "min")


def max_(t: torch.Tensor, group) -> torch.Tensor:
    return _reduce(t, dist.ReduceOp.MAX, group, "max")


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group member ``src``'s tensor on every member."""
    if size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    CALLS["broadcast"] += 1
    return out


def _stack(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every member's block, in group rank order."""
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(size(group) * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((size(group),) + tuple(t.shape))


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The members' blocks joined along ``dim``, in group rank order."""
    if size(group) == 1:
        return t
    CALLS["gather"] += 1
    return torch.cat(_stack(t, group).unbind(0), dim=dim)


def shift(t: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``lax.ppermute(t, pairs=[(i, (i + offset) % n)])``: the block of
    member (rank - offset) % n."""
    n = size(group)
    if n == 1:
        return t
    CALLS["shift"] += 1
    return _stack(t, group)[(rank(group) - offset) % n]


def gather(t: torch.Tensor, group, dst: int):
    """Every member's block, in group rank order, on the member of global
    rank ``dst`` (a list); None on the others."""
    if size(group) == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(size(group))] \
        if dist.get_rank() == dst else None
    dist.gather(t, out, dst=dst, group=group)
    CALLS["gather_to"] += 1
    return out
