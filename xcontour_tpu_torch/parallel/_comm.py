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
  outputs, which only the writing rank needs; forward only).

The sharded functions use ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` (the gather's backward) and ``broadcast``,
which both backends take on CUDA tensors.  Gloo does not take point to
point ones there (torch 2.11 on an H100: ``send``/``recv`` and
``batch_isend_irecv`` of CUDA tensors fail with "writev: Bad address";
``chip_smoke.py`` phase 11 probes each collective), so the ring shift is
an all-gather of which each member keeps its neighbour's block: the halo
columns are small.  Nothing is copied to the host here.  A group of one
runs no collective at all: the ring of one is the identity, as
``ppermute`` is on an axis of size 1.

Gradients, as ``jax.grad`` takes them through ``shard_map``.  Where grad
mode is on and an input requires grad, each collective but
:func:`gather` runs as a ``torch.autograd.Function`` (a group of one
stays the identity, with no Function).  Each member differentiates its
own loss; a replicated output is a copy on every member, so its
cotangent there is the member's share, and the shares add up over the
group to ``jax.grad``'s (:func:`..parallel.once_per_mesh`).  The
backwards are therefore collectives too: :func:`sum_`'s an all-reduce of
the cotangent; :func:`min_`'s and :func:`max_`'s the summed cotangent
split equally over every member's cells equal to the extremum (JAX splits
a min's cotangent between ties); :func:`broadcast`'s the cotangents
summed onto the source; :func:`all_gather`'s each member's block of the
summed cotangent (a reduce-scatter, whose own transpose is the gather);
:func:`shift`'s the opposite shift.  The backwards are made of the same
differentiable collectives, so a gradient can be differentiated again.
Every member must run each backward collective, so every member must
keep each collective's output in its graph, even one it discards
(:func:`keep`).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..kernels import needs_grad

# collectives run, by kind (a backward's as "<kind>_grad"): read by the
# tests and chip_smoke.py
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


def _reduce_many(ts, group, kind: str) -> list:
    """The tensors ``ts`` each summed over the group, in one all-reduce."""
    if len(ts) == 1:
        return [_reduce(ts[0], dist.ReduceOp.SUM, group, kind)]
    flat = _reduce(torch.cat([t.reshape(-1) for t in ts]),
                   dist.ReduceOp.SUM, group, kind)
    return [p.view(t.shape)
            for p, t in zip(flat.split([t.numel() for t in ts]), ts)]


def _sum(ts, group, kind: str) -> list:
    if needs_grad(*ts):
        return list(_Sum.apply(group, kind, *ts))
    return _reduce_many(ts, group, kind)


class _Sum(torch.autograd.Function):
    """``lax.psum`` of one or more tensors in one all-reduce; the
    cotangents likewise (the outputs a loss leaves without one stay
    without, as the K2 Function's unused channels must)."""

    @staticmethod
    def forward(ctx, group, kind, *ts):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return tuple(_reduce_many(ts, group, kind))

    @staticmethod
    def backward(ctx, *gs):
        live = [i for i, g in enumerate(gs) if g is not None]
        out = [None] * len(gs)
        if live:
            for i, g in zip(live, _sum([gs[i] for i in live], ctx.group,
                                       "sum_grad")):
                out[i] = g
        return (None, None, *out)


def sum_(t, group):
    """The members' tensors summed (``lax.psum``).  ``t`` may be a tuple of
    tensors, summed in one all-reduce (a tuple back)."""
    many = isinstance(t, tuple)
    ts = t if many else (t,)
    if size(group) == 1:        # each its own copy: no cotangent is made
        out = [x.contiguous().clone() for x in ts]
    else:
        out = _sum(ts, group, "sum")
    return tuple(out) if many else out[0]


class _Extremum(torch.autograd.Function):
    """``lax.pmin`` / ``pmax``.  Backward: every member's cotangent summed
    and split equally over the cells equal to the extremum on every
    member, ``ties`` counting the cells each element stands for (the
    summed cotangent and the tie count in one all-reduce)."""

    @staticmethod
    def forward(ctx, t, ties, op, group, kind):
        out = _reduce(t, op, group, kind)
        ctx.group, ctx.kind = group, kind
        ctx.save_for_backward(t, out, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        t, out, ties = ctx.saved_tensors
        w = torch.where(t == out, ties.to(t.dtype), torch.zeros_like(t))
        g_all, w_all = _sum([torch.stack([g, w])], ctx.group,
                            ctx.kind + "_grad")[0].unbind(0)
        share = torch.where(w > 0, g_all * w / w_all, torch.zeros_like(t))
        return share, None, None, None, None


def _extremum(t, group, ties, op, kind):
    if size(group) > 1 and needs_grad(t):
        return _Extremum.apply(t, torch.ones_like(t) if ties is None
                               else ties, op, group, kind)
    return _reduce(t, op, group, kind)


def min_(t: torch.Tensor, group, ties=None) -> torch.Tensor:
    """The members' tensors' elementwise minimum.  ``ties`` (ones when
    None) counts, for each element of ``t``, the cells it was reduced from
    that equal it: the minimum's cotangent goes to every member's tied
    cells in equal parts."""
    return _extremum(t, group, ties, dist.ReduceOp.MIN, "min")


def max_(t: torch.Tensor, group, ties=None) -> torch.Tensor:
    """The maximum, as :func:`min_`."""
    return _extremum(t, group, ties, dist.ReduceOp.MAX, "max")


def _broadcast(t, group, src, kind):
    out = t.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    CALLS[kind] += 1
    return out


class _Broadcast(torch.autograd.Function):
    """Member ``src``'s tensor everywhere; the cotangents summed onto it."""

    @staticmethod
    def forward(ctx, t, group, src):
        ctx.group, ctx.src = group, src
        return _broadcast(t, group, src, "broadcast")

    @staticmethod
    def backward(ctx, g):
        g = _sum([g], ctx.group, "broadcast_grad")[0]
        return (g if rank(ctx.group) == ctx.src else torch.zeros_like(g),
                None, None)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group member ``src``'s tensor on every member."""
    if size(group) == 1:
        return t
    if needs_grad(t):
        return _Broadcast.apply(t, group, src)
    return _broadcast(t, group, src, "broadcast")


def _stack(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every member's block, in group rank order."""
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(size(group) * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((size(group),) + tuple(t.shape))


def _all_gather(t, group, dim, kind):
    if needs_grad(t):
        return _AllGather.apply(t, group, dim, kind)
    CALLS[kind] += 1
    return torch.cat(_stack(t, group).unbind(0), dim=dim)


def _reduce_scatter(g, group, dim, kind):
    if needs_grad(g):
        return _ReduceScatter.apply(g, group, dim, kind)
    n, dim = size(group), dim % g.dim()
    blocks = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    flat = blocks.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(out, flat, group=group)
    CALLS[kind] += 1
    return out.view(blocks.shape[1:])


class _AllGather(torch.autograd.Function):
    """The blocks joined; the backward gives each member its block of the
    members' summed cotangents, in one reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group, dim, kind):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.group, ctx.dim, "gather_grad"),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    """The gather's transpose, whose own is the gather."""

    @staticmethod
    def forward(ctx, g, group, dim, kind):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(g, group, dim, kind)

    @staticmethod
    def backward(ctx, h):
        return (_all_gather(h, ctx.group, ctx.dim, "scatter_grad"),
                None, None, None)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The members' blocks joined along ``dim``, in group rank order."""
    if size(group) == 1:
        return t
    return _all_gather(t, group, dim, "gather")


def _shift(t, group, offset, kind):
    if needs_grad(t):
        return _Shift.apply(t, group, offset, kind)
    CALLS[kind] += 1
    return _stack(t, group)[(rank(group) - offset) % size(group)]


class _Shift(torch.autograd.Function):
    """``lax.ppermute``; its transpose is the opposite shift."""

    @staticmethod
    def forward(ctx, t, group, offset, kind):
        ctx.group, ctx.offset = group, offset
        return _shift(t, group, offset, kind)

    @staticmethod
    def backward(ctx, g):
        return (_shift(g, ctx.group, -ctx.offset, "shift_grad"),
                None, None, None)


def shift(t: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``lax.ppermute(t, pairs=[(i, (i + offset) % n)])``: the block of
    member (rank - offset) % n."""
    if size(group) == 1:
        return t
    return _shift(t, group, offset, "shift")


class _Keep(torch.autograd.Function):
    """``t``, with ``dropped`` in the graph at a zero cotangent."""

    @staticmethod
    def forward(ctx, t, *dropped):
        ctx.like = [(d.shape, d.dtype, d.device) for d in dropped]
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dv)
                     for s, dt, dv in ctx.like))


def keep(t: torch.Tensor, group, *dropped: torch.Tensor) -> torch.Tensor:
    """``t``, carrying tensors this member discards into the autograd graph
    with a zero cotangent, so the collectives over ``group`` that made them
    run their backward here as on every other member.  ``t`` itself where
    no gradient is taken or the group is of one."""
    if size(group) > 1 and needs_grad(*dropped):
        return _Keep.apply(t, *dropped)
    return t


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
