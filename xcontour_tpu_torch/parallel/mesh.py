"""The ('batch', 'x') mesh over a torch.distributed world, and the blocks
of a field that each rank holds.

Counterpart of ``xcontour_tpu/parallel/mesh.py``.  JAX runs one process
over a device ``Mesh``; here one process runs per rank (one card a rank,
as JAX has one device a mesh slot), in a default process group the
caller has joined (NCCL on cards, gloo on the CPU).  The snapshot batch
rides the slower 'batch' axis (across nodes) and the grid's X dimension
is split over the 'x' axis within a node; every collective of the sharded
functions runs over the 'x' axis's group (:mod:`._comm`).

The sharded functions take and return a rank's **local block**, the view
a ``shard_map`` body has: :func:`shard_batch_spec` cuts that block out
of a whole (B, ..., Ny, Nx) array and joins blocks back.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import _comm

# the mesh's axes: snapshots over BATCH, the grid's columns over X
BATCH, X = "batch", "x"


def _device_type() -> str:
    """'cuda' under NCCL, else 'cpu' (a gloo group takes CUDA tensors all
    the same: the mesh's device type only picks the groups' backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              x_size: Optional[int] = None) -> DeviceMesh:
    """A ('batch', 'x') mesh over the process group's ``n_devices`` ranks
    (the whole world: every rank must call this).

    ``x_size`` (spatial shards) defaults to 2 when the rank count is even,
    else 1: batch parallelism is the primary axis, snapshots being
    independent.  The axes are named ``BATCH`` and ``X``, which the
    sharded functions read; JAX's ``axis_names`` has no counterpart."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if x_size is None:
        x_size = 2 if n % 2 == 0 and n >= 2 else 1
    if n % x_size:
        raise ValueError(f"{n} devices not divisible by x_size={x_size}")
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}: "
                         "the mesh spans the whole process group")
    return init_device_mesh(_device_type(), (n // x_size, x_size),
                            mesh_dim_names=(BATCH, X))


def _rank_of(record) -> int:
    return record if isinstance(record, (int, np.integer)) else record.rank


def local_world_size() -> int:
    """Ranks per node: torchrun's LOCAL_WORLD_SIZE, else the whole world
    (one node)."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env:
        return int(env)
    return dist.get_world_size() if dist.is_initialized() else 1


def hybrid_device_array(devices: Sequence, x_size: int,
                        slice_of=None) -> np.ndarray:
    """Arrange ranks into the hybrid (batch, x) array: nodes stack along
    the BATCH axis and each node's own ranks form contiguous 'x' groups,
    so no 'x'-axis collective crosses the network between nodes.

    Pure topology logic over rank records (ints, or objects with a
    ``rank``): ``slice_of`` maps a record to its node and defaults to
    ``rank // LOCAL_WORLD_SIZE`` (the counterpart of JAX's
    ``process_index``).  Returns an object array of the records."""
    if slice_of is None:
        per_node = local_world_size()

        def slice_of(d):
            return _rank_of(d) // per_node
    groups = {}
    for d in devices:
        groups.setdefault(slice_of(d), []).append(d)
    sizes = {len(v) for v in groups.values()}
    if len(sizes) != 1:
        counts = {k: len(v) for k, v in groups.items()}
        raise ValueError(f"uneven devices per slice: {counts}")
    local = sizes.pop()
    if x_size < 1 or local % x_size:
        raise ValueError(f"{local} devices per slice not divisible by "
                         f"x_size={x_size}")
    rows = []
    for k in sorted(groups):
        arr = np.empty(len(groups[k]), object)
        arr[:] = groups[k]
        rows.append(arr.reshape(local // x_size, x_size))
    return np.concatenate(rows, axis=0)


def make_hybrid_mesh(x_size: Optional[int] = None,
                     slice_of=None) -> DeviceMesh:
    """Multi-node ('batch', 'x') mesh: batch across nodes, x within one.

    A world on one node (or a single process) is :func:`make_mesh` over
    every rank, unless ``slice_of`` is given, which forces the hybrid
    placement with the caller's node attribution.  ``x_size`` defaults to
    a whole node's ranks.  NCCL finds the links between a node's cards
    itself; the placement only keeps each 'x' group inside one node."""
    world = dist.get_world_size()
    if slice_of is None and local_world_size() >= world:
        return make_mesh(x_size=x_size)
    ranks = list(range(world))
    node = slice_of or (lambda r: r // local_world_size())
    if x_size is None:
        x_size = world // len({node(r) for r in ranks})
    dtype = _device_type()
    _warn_topology(dtype)
    arr = hybrid_device_array(ranks, x_size, slice_of=node)
    assert arr.shape == (world // x_size, x_size)
    return DeviceMesh(dtype, torch.as_tensor(arr.astype(np.int64)),
                      mesh_dim_names=(BATCH, X))


def _warn_topology(device_type: str) -> None:
    """On cards, a node running more ranks than it has cards puts several
    ranks of one 'x' group on one card, whose collectives then share it
    (the card's counterpart of JAX's warning that its coordinate-aware
    placement fell back to enumeration order)."""
    if device_type == "cuda" and torch.cuda.is_available():
        cards = torch.cuda.device_count()
        if local_world_size() > cards:
            warnings.warn(
                f"make_hybrid_mesh: {local_world_size()} ranks a node over "
                f"{cards} card(s); ranks share cards, so the 'x' "
                "collectives move through one device", stacklevel=3)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def once_per_mesh(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``t``, an output replicated over 'x', weighted by 1 / size('x') for
    a rank's loss: the x ranks' losses then add up to the loss of the
    whole arrays that ``jax.grad`` differentiates, which counts a
    replicated output once.  An x-sharded block is summed into the loss
    as it is."""
    n = axis_size(mesh, X)
    return t if n == 1 else t / n


def x_block(mesh: DeviceMesh, a, nxl: int):
    """This rank's ``nxl`` columns of a replicated (..., Nx) array."""
    i = mesh.get_local_rank(X)
    return a[..., i * nxl:(i + 1) * nxl]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Where a rank's block of a (B, ..., Ny, Nx) array lies: the leading
    axis split over 'batch' (for ndim >= 3), the last over 'x', Ny never
    split (every diagnostic reduces over the
    equivalent dimension, so splitting it would put the heavy LWA
    reduction across the network for no benefit).  What
    :func:`shard_batch_spec` returns; ``runner.run_batched(sharding=)``
    takes it."""

    mesh: DeviceMesh
    ndim: int

    @property
    def sizes(self):
        """(batch shards, x shards)."""
        b = axis_size(self.mesh, BATCH) if self.ndim >= 3 else 1
        return b, axis_size(self.mesh, X)

    @property
    def coords(self):
        """(batch index, x index) of this rank."""
        b = self.mesh.get_local_rank(BATCH) if self.ndim >= 3 else 0
        return b, self.mesh.get_local_rank(X)

    def index(self, shape) -> tuple:
        """The slices of this rank's block of an array of ``shape``."""
        (nb, nx), (ib, ix) = self.sizes, self.coords
        B, Nx = shape[0], shape[-1]
        if Nx % nx or (self.ndim >= 3 and B % nb):
            raise ValueError(f"shape {tuple(shape)} does not split over a "
                             f"({nb}, {nx}) mesh")
        idx = [slice(None)] * len(shape)
        if self.ndim >= 3:
            bl = B // nb
            idx[0] = slice(ib * bl, (ib + 1) * bl)
        xl = Nx // nx
        idx[-1] = slice(ix * xl, (ix + 1) * xl)
        return tuple(idx)

    def block(self, a):
        """This rank's block of the whole array ``a`` (numpy or tensor)."""
        return a[self.index(a.shape)]

    def gather(self, t: torch.Tensor, x_sharded: bool = True) -> torch.Tensor:
        """The whole array from every rank's block ``t``, on every rank (one
        all-gather over the world): x-sharded blocks joined along x and
        batch, or, for an array replicated over 'x', x rank 0's blocks
        joined along batch."""
        (nb, nx) = self.sizes
        if nb * (nx if x_sharded else 1) == 1:
            return t
        blocks = _comm.all_gather(t[None], dist.group.WORLD)
        ranks = self.mesh.mesh.reshape(-1, nx).tolist()
        rows = [torch.cat([blocks[r] for r in row[:nx if x_sharded else 1]],
                          dim=-1) for row in ranks[:nb]]
        return torch.cat(rows, dim=0)


def shard_batch_spec(mesh: DeviceMesh, ndim: int) -> BlockSpec:
    """The blocks of a (..., Ny, Nx) field batch: leading axis over
    'batch' (ndim >= 3), the last (X) axis over 'x', Ny whole."""
    return BlockSpec(mesh, ndim)
