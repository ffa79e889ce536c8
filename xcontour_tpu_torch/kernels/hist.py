"""K2: the direct multi-channel weighted CDF (CUDA: ``csrc/hist.cu``).

Replaces ``xcontour_tpu/kernels/hist_pallas.py`` (``_kernel``, launched by
``histogram_pallas_multi`` and ``histogram_pallas``):

    out[b, c, k] = sum of weights[b, c, g] over cells with
                   edges[b, 0] <= values[b, g] < edges[b, k + 1]

with the top edge inclusive at k = N-1.  NaN values and NaN weights add
nothing.  The kernel keeps each lane's current bin and running sums in
registers and looks for a new bin only when a value leaves that one; the
plain version is the digitize + segment-sum + cumsum form of
``_edges_cdf_xla``.  :func:`plan` sizes the kernel's grid from the SM count
and :func:`bin_range` the bins one launch holds in shared memory
(``tests/test_torch_hist_tiles.py`` emulates the kernel with both).
"""

from __future__ import annotations

import functools

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle

KERNEL = Kernel("weighted_cdf", "xcontour_tpu_torch/csrc/hist.cu",
                "xcontour_tpu/kernels/hist_pallas.py:31")

# the first pass: 8 warps a block, each lane loading 4 cells a step, up to 8
# channels a launch; about 4 blocks an SM, and at least 2048 cells a block
WARPS, STEP, GROUP = 8, 32 * 4, 8
BLOCKS_PER_SM, MIN_CELLS = 4, 2048
# up to 32 histogram copies (lane l adds into copy l % ncopy) in at most
# this much shared memory, and at least one copy
COPY_BYTES = 32 * 1024
# the first pass holds the edges and a (channel group, bins) histogram in
# the shared memory a block may use
SMEM_LIMIT = 227 * 1024


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocks_a_plane(B: int, cells: int, sms: int, min_cells: int) -> int:
    """Blocks each of B planes of ``cells`` cells is cut into: about
    BLOCKS_PER_SM blocks an SM over the B planes, none under ``min_cells``
    cells (K2's first pass and E's scan)."""
    return max(1, min(-(-BLOCKS_PER_SM * sms // B), -(-cells // min_cells)))


def plan(B: int, G: int, N: int, C: int, sms: int):
    """(nblk, wchunk, ncopy) of the first pass: blocks per batch element,
    cells per warp (a multiple of a warp step) and histogram copies."""
    nblk = blocks_a_plane(B, G, sms, MIN_CELLS)
    wchunk = -(-G // (nblk * WARPS))
    wchunk = -(-wchunk // STEP) * STEP
    nblk = -(-G // (wchunk * WARPS))
    cg = min(C, GROUP)
    ncopy = next((n for n in (32, 16, 8, 4, 2) if n * cg * N * 4 <= COPY_BYTES),
                 1)
    return nblk, wchunk, ncopy


def bin_range(N: int, C: int) -> int:
    """Bins one first-pass launch takes: all N where the N + 1 edges and
    one copy of a group's (min(C, 8), N) histogram fit in shared memory,
    else the most that do; the launches then take the bins in ranges."""
    cg = min(C, GROUP)
    floats = SMEM_LIMIT // 4
    if N + 1 + cg * N <= floats:
        return N
    return (floats - 1) // (cg + 1)


def digitize(values: torch.Tensor, edges: torch.Tensor):
    """(bin, valid) of values (B, G) against ascending edges (B, N+1):
    searchsorted(side='right') - 1 with the top edge inclusive, clamped to
    [0, N-1]; valid where edges[0] <= v <= edges[N] (never NaN)."""
    N = edges.shape[-1] - 1
    idx = torch.searchsorted(edges.contiguous(), values.contiguous(),
                             right=True) - 1
    top = edges[:, -1:]
    idx = torch.where(values == top, N - 1, idx).clamp(0, N - 1)
    return idx, (values >= edges[:, :1]) & (values <= top)


def weighted_cdf_plain(values: torch.Tensor, edges: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """values (B, G); edges (B, N+1) ascending; weights (B, C, G) ->
    (B, C, N) ascending CDF."""
    B, C, G = weights.shape
    N = edges.shape[-1] - 1
    idx, valid = digitize(values, edges)
    w = torch.where(torch.isnan(weights) | ~valid[:, None, :],
                    torch.zeros_like(weights), weights)
    hist = torch.zeros((B, C, N), dtype=weights.dtype, device=weights.device)
    hist.scatter_add_(2, idx[:, None, :].expand(B, C, G), w)
    return torch.cumsum(hist, dim=-1)


def weighted_cdf(values: torch.Tensor, edges: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Multi-channel ascending CDF, (B, G) x (B, N+1) x (B, C, G) ->
    (B, C, N).  CPU tensors take the plain version; CUDA tensors launch
    the kernel: any batch, any number of bins (in ranges of
    :func:`bin_range` where one launch's histogram does not fit in shared
    memory); B * C * G weights and B * C * N outputs stay under 2^31, the
    kernel's 32-bit cell and grid indices."""
    if values.device.type == "cpu":
        return weighted_cdf_plain(values, edges, weights)
    check_cuda_inputs(KERNEL.name, values=values, edges=edges,
                      weights=weights)
    if values.dim() != 2 or edges.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"{KERNEL.name}: expected values (B, G), edges "
                         "(B, N+1), weights (B, C, G)")
    B, G = values.shape
    C = weights.shape[1]
    N = edges.shape[1] - 1
    if edges.shape[0] != B or weights.shape[0] != B or weights.shape[2] != G:
        raise ValueError(f"{KERNEL.name}: shapes {tuple(values.shape)}, "
                         f"{tuple(edges.shape)}, {tuple(weights.shape)} disagree")
    if N < 1 or C < 1:
        raise ValueError(f"{KERNEL.name}: need N >= 1 bins and C >= 1 channels")
    if B * C * G >= 2 ** 31 or B * C * N >= 2 ** 31:
        raise ValueError(f"{KERNEL.name}: more than 2^31 weights or outputs")
    from ._build import library
    nrange = bin_range(N, C)
    nblk, wchunk, ncopy = plan(B, G, nrange, C, _sm_count(values.device.index))
    partial = torch.empty((B, nblk, C, N), dtype=values.dtype,
                          device=values.device)
    out = torch.empty((B, C, N), dtype=values.dtype, device=values.device)
    status = library().xc_weighted_cdf(
        values.data_ptr(), edges.data_ptr(), weights.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, G, N, C, nrange, nblk, wchunk,
        ncopy, stream_handle())
    check_status(KERNEL.name, status)
    KERNEL.count()
    return out
