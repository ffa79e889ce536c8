"""P1-P4: the kernel-ceiling probes (CUDA: ``csrc/probes.cu``).

Each probe is the twin of one of the port's kernels: the kernel's grid,
blocks, staging and loop, without the machinery that makes its output
(prep kernels, epilogues, flushes, atomics, fixed-point totals).  Its time
is the ceiling the kernel can reach at its structure
(:mod:`xcontour_tpu_torch.utils.roofline` sets the two side by side).
Each computes a function that does not depend on the blocking, so its
plain PyTorch version holds it:

- P1 :func:`lwa_structure`, twin of K3, replaces ``_lwa_structure_probe``
  (``bench.py:523``):  R[b, j, x] = sum_y min(q[b, y, x] - Q[b, j], 0) W[y, x];
- P2 :func:`hist_structure`, twin of K2's first pass, replaces
  ``_hist_structure_probe`` (``bench.py:593``):
  S[b] = sum_g (w[b, 0, g] + w[b, 1, g]) #{k in 1..N : v[b, g] < e[b, k]};
- P3 :func:`length_structure`, twin of K7, replaces
  ``_length_structure_probe`` (``bench.py:666``): T[b] = sum_n L[b, n], L
  K7's lat-lon totals (0 for an empty contour);
- P4 :func:`scaled_copy`, twin of K1, replaces ``_pallas_copy``
  (``bench.py:742``): q * 1.0000001 in float32.

The TPU's P2 and P3 write one output block that every grid step revisits,
so only their last tile (P2) or row block (P3) survives; these sum every
tile, as the TPU probes' comments mean them to.  None needs a gradient.
"""

from __future__ import annotations

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle
from .hist import SMEM_LIMIT, _sm_count, plan
from .length import TILE, contour_lengths_plain

_SOURCE = "xcontour_tpu_torch/csrc/probes.cu"
KERNEL_LWA = Kernel("lwa_structure_probe", _SOURCE, "bench.py:523")
KERNEL_HIST = Kernel("hist_structure_probe", _SOURCE, "bench.py:593")
KERNEL_LENGTH = Kernel("length_structure_probe", _SOURCE, "bench.py:666")
KERNEL_COPY = Kernel("copy_probe", _SOURCE, "bench.py:742")
# P1-P4
PROBES = (KERNEL_LWA, KERNEL_HIST, KERNEL_LENGTH, KERNEL_COPY)

SCALE = 1.0000001
# surfaces per step of P1's plain version: bounds its (B, chunk, Ny, Nx)
# temporaries
_CHUNK = 16


def lwa_structure_plain(q: torch.Tensor, Q: torch.Tensor,
                        W: torch.Tensor) -> torch.Tensor:
    """q (B, Ny, Nx), Q (B, Ny), W (Ny, Nx) -> R (B, Ny, Nx), surface j
    along axis 1."""
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    rows = [(torch.minimum(q[:, None] - Q[:, j:j + _CHUNK, None, None], zero)
             * W).sum(2) for j in range(0, q.shape[1], _CHUNK)]
    return torch.cat(rows, dim=1)


def lwa_structure(q: torch.Tensor, Q: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    """P1.  CPU tensors take the plain version; CUDA tensors launch the
    probe (any batch; fewer than 2^31 cells a snapshot)."""
    if q.device.type == "cpu":
        return lwa_structure_plain(q, Q, W)
    name = KERNEL_LWA.name
    check_cuda_inputs(name, q=q, Q=Q, W=W)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, Ny, Nx), got {tuple(q.shape)}")
    B, Ny, Nx = q.shape
    if Q.shape != (B, Ny) or W.shape != (Ny, Nx):
        raise ValueError(f"{name}: Q {tuple(Q.shape)} / W {tuple(W.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Ny * Nx >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells a snapshot")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    from ._build import library
    status = library().xc_lwa_structure(
        q.data_ptr(), W.data_ptr(), Q.data_ptr(), out.data_ptr(), B, Ny, Nx,
        stream_handle())
    check_status(name, status)
    KERNEL_LWA.count()
    return out


def edges_above(values: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """#{k in 1..N : values[b, g] < edges[b, k]} for ascending edges
    (B, N+1), in the values' dtype; 0 for NaN, whose compares are false."""
    N = edges.shape[-1] - 1
    at_or_below = torch.searchsorted(edges[:, 1:].contiguous(),
                                     values.contiguous(), right=True)
    cnt = torch.where(torch.isnan(values), torch.zeros_like(at_or_below),
                      N - at_or_below)
    return cnt.to(values.dtype)


def hist_structure_plain(values: torch.Tensor, edges: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """values (B, G), edges (B, N+1) ascending, weights (B, 2, G) -> S (B,)."""
    return ((weights[:, 0] + weights[:, 1])
            * edges_above(values, edges)).sum(-1)


def hist_structure(values: torch.Tensor, edges: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """P2.  CPU tensors take the plain version; CUDA tensors launch the
    probe on K2's grid (:func:`kernels.hist.plan` at two channels), then a
    fixed-order fold of its blocks' partials: N + 1 edges in shared
    memory, B * 2 * G weights under 2^31."""
    if values.device.type == "cpu":
        return hist_structure_plain(values, edges, weights)
    name = KERNEL_HIST.name
    check_cuda_inputs(name, values=values, edges=edges, weights=weights)
    if values.dim() != 2 or edges.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"{name}: expected values (B, G), edges (B, N+1), "
                         "weights (B, 2, G)")
    B, G = values.shape
    N = edges.shape[1] - 1
    if edges.shape[0] != B or weights.shape != (B, 2, G):
        raise ValueError(f"{name}: shapes {tuple(values.shape)}, "
                         f"{tuple(edges.shape)}, {tuple(weights.shape)} disagree")
    if N < 1:
        raise ValueError(f"{name}: need N >= 1 bins")
    if 4 * (N + 1) > SMEM_LIMIT:
        raise ValueError(f"{name}: {N + 1} edges do not fit in shared memory")
    if B * 2 * G >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 weights")
    if B == 0:
        return values.new_zeros((0,))
    from ._build import library
    nblk, wchunk, _ = plan(B, G, N, 2, _sm_count(values.device.index))
    partial = torch.empty((B, nblk), dtype=values.dtype, device=values.device)
    out = torch.empty((B,), dtype=values.dtype, device=values.device)
    status = library().xc_hist_structure(
        values.data_ptr(), edges.data_ptr(), weights.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, G, N, nblk, wchunk,
        stream_handle())
    check_status(name, status)
    KERNEL_HIST.count()
    return out


def length_structure_plain(data: torch.Tensor, levels: torch.Tensor,
                           yc: torch.Tensor, xc: torch.Tensor, *,
                           chunk: int = 8) -> torch.Tensor:
    """data (B, Ny, Nx), levels (B, N), coordinates (Ny,)/(B, Ny) and
    (Nx,)/(B, Nx) in radians -> T (B,): K7's lat-lon plain version
    (``chunk`` levels at a time) summed over the levels."""
    return contour_lengths_plain(data, levels, yc, xc, latlon=True,
                                 chunk=chunk).sum(-1)


def length_structure(data: torch.Tensor, levels: torch.Tensor,
                     yc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """P3.  CPU tensors take the plain version; CUDA tensors launch the
    probe on K7's tiles (levels sorted here, NaN last, as K7's wrapper
    does), then a fixed-order fold of the tiles' partials."""
    if data.device.type == "cpu":
        return length_structure_plain(data, levels, yc, xc)
    name = KERNEL_LENGTH.name
    check_cuda_inputs(name, data=data, levels=levels, yc=yc, xc=xc)
    if data.dim() != 3 or levels.dim() != 2:
        raise ValueError(f"{name}: expected data (B, Ny, Nx), levels (B, N)")
    B, Ny, Nx = data.shape
    N = levels.shape[1]
    if levels.shape[0] != B:
        raise ValueError(f"{name}: levels {tuple(levels.shape)} do not match "
                         f"{B} batch elements")
    for c, n, what in ((yc, Ny, "yc"), (xc, Nx, "xc")):
        if c.dim() not in (1, 2) or c.shape[-1] != n or \
                (c.dim() == 2 and c.shape[0] != B):
            raise ValueError(f"{name}: {what} must be ({n},) or ({B}, {n}), "
                             f"got {tuple(c.shape)}")
    if Ny < 2 or Nx < 2:
        raise ValueError(f"{name}: need Ny, Nx >= 2")
    if data.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")
    if B == 0 or N == 0:
        return data.new_zeros((B,))
    from ._build import library
    lev_s = torch.sort(levels, dim=-1, stable=True).values   # NaN last
    n_rb, n_cb = -(-(Ny - 1) // TILE[0]), -(-(Nx - 1) // TILE[1])
    partial = torch.empty((B, n_rb * n_cb), dtype=data.dtype,
                          device=data.device)
    out = torch.empty((B,), dtype=data.dtype, device=data.device)
    status = library().xc_length_structure(
        data.data_ptr(), lev_s.data_ptr(), yc.data_ptr(), xc.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, Ny, Nx, N, n_rb, n_cb,
        int(yc.dim() == 2), int(xc.dim() == 2), stream_handle())
    check_status(name, status)
    KERNEL_LENGTH.count()
    return out


def scaled_copy_plain(q: torch.Tensor) -> torch.Tensor:
    """q * 1.0000001, one rounding in q's dtype."""
    return q * SCALE


def scaled_copy(q: torch.Tensor) -> torch.Tensor:
    """P4.  CPU tensors take the plain version; CUDA tensors launch the
    probe on K1's blocks (fewer than 2^31 cells)."""
    if q.device.type == "cpu":
        return scaled_copy_plain(q)
    name = KERNEL_COPY.name
    check_cuda_inputs(name, q=q)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, Ny, Nx), got {tuple(q.shape)}")
    B, Ny, Nx = q.shape
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    from ._build import library
    status = library().xc_scaled_copy(q.data_ptr(), out.data_ptr(), B, Ny, Nx,
                                      stream_handle())
    check_status(name, status)
    KERNEL_COPY.count()
    return out
