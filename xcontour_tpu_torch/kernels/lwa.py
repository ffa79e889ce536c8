"""K3 and K4: local wave activity kernels (CUDA: ``csrc/lwa.cu``).

K3 (:func:`lwa_lin`) replaces ``_kernel_lin`` of
``xcontour_tpu/kernels/lwa_pallas.py``: the linearized part='all' LWA,
-(R_j + E[j]), after centering on the profile midpoint.  Its plain version
is the JAX package's ``_lwa_lin_xla``.

K4 (:func:`lwa_dense`) replaces ``_kernel`` of the same file (pairwise,
variant2=False): the reference's 3-valued mask times qe*W summed over y,
parts all/upper/lower.  Its plain version is ``_lwa_dense_xla``.  Both the
kernel and the plain version zero NaN weights like ``_lwa_dense_xla`` (the
TPU kernel does not).

Shapes: q (B, Ny, Nx) tracer, Q (B, Ny) sorted profile, W (Ny, Nx) composed
weight -> (B, Ny, Nx), surface index j along axis 1.  The surface mask is
the index form (row >= j), exact for a strictly monotone coordinate.
"""

from __future__ import annotations

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle

KERNEL_LIN = Kernel("lwa_lin", "xcontour_tpu_torch/csrc/lwa.cu",
                    "xcontour_tpu/kernels/lwa_pallas.py:86")
KERNEL_DENSE = Kernel("lwa_dense", "xcontour_tpu_torch/csrc/lwa.cu",
                      "xcontour_tpu/kernels/lwa_pallas.py:216")

_PARTS = {"all": 0, "upper": 1, "lower": 2}


def _center(q, Q):
    """Shift by the mean of the finite profile values (exact for LWA: the
    mask depends only on sign(q - Q_j)); it keeps the R and E terms from
    cancelling large magnitudes in float32."""
    validQ = torch.isfinite(Q)
    mean = torch.nanmean(torch.where(validQ, Q, torch.full_like(Q, float("nan"))), -1)
    c0 = torch.where(validQ.any(-1), mean, torch.zeros_like(mean)).to(q.dtype)
    qc = q - c0[:, None, None]
    Qc = Q - c0[:, None]
    Qt = torch.where(validQ, Qc, torch.zeros_like(Qc))
    return qc, Qc, Qt


# surfaces per step of the plain versions: bounds their (B, chunk, Ny, Nx)
# temporaries
_CHUNK = 16


def _surface_chunks(Ny: int):
    return [slice(j, min(Ny, j + _CHUNK)) for j in range(0, Ny, _CHUNK)]


def lwa_lin_plain(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
                  increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA in plain PyTorch (``_lwa_lin_xla``): the
    E t-term by the telescoping recurrence plus a chunked 4-op c-term
    reduction per surface."""
    B, Ny, Nx = q.shape
    qc, Qc, Qt = _center(q, Q)
    sent = float("inf") if increase else float("-inf")
    valid = torch.isfinite(q) & torch.isfinite(W)
    qk = torch.where(valid, qc, torch.full_like(qc, sent))
    Wv = torch.where(valid, W, torch.zeros_like(qc))
    qt = torch.where(valid, qc, torch.zeros_like(qc))
    P0 = torch.cumsum(Wv, dim=1) - Wv
    inc = ((Qt[:, 1:, None] - qt[:, :-1]) * Wv[:, :-1]
           + (Qt[:, 1:] - Qt[:, :-1])[..., None] * P0[:, :-1])
    E = torch.cat([torch.zeros((B, 1, Nx), dtype=q.dtype, device=q.device),
                   torch.cumsum(inc, dim=1)], dim=1)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    rows = []
    for js in _surface_chunks(Ny):
        Qj = Qc[:, js, None, None]                        # (B, c, 1, 1)
        qe = qk[:, None] - Qj                             # (B, c, Ny, Nx)
        ext = torch.minimum(qe, zero) if increase else torch.maximum(qe, zero)
        R = (ext * Wv[:, None]).sum(2)                    # (B, c, Nx)
        row = -(R + E[:, js])
        rows.append(torch.where(torch.isnan(Qj[..., 0]), zero, row))
    return torch.cat(rows, dim=1)


def _mask3(qe, m, increase: bool):
    """The reference's 3-valued LWA mask: -1 where the deviation pokes out
    equatorward/below of the contour, +1 poleward/above, 0 else."""
    one = torch.ones((), dtype=qe.dtype, device=qe.device)
    zero = torch.zeros_like(one)
    pos, neg = (qe > 0, qe < 0) if increase else (qe < 0, qe > 0)
    mask2 = torch.where(m, zero, torch.where(pos, -one, zero))
    return torch.where(neg & m, one, mask2)


def _part_zero(mask, part: str, increase: bool):
    if part == "all":
        return mask
    if part == "upper":
        keep = mask > 0 if increase else mask < 0
    else:
        keep = mask < 0 if increase else mask > 0
    return torch.where(keep, mask, torch.zeros_like(mask))


def lwa_dense_plain(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
                    increase: bool, part: str = "all") -> torch.Tensor:
    """Pairwise LWA in plain PyTorch (``_lwa_dense_xla``): excluded and NaN
    terms are exact zeros, NaN weights count as zero."""
    if part not in _PARTS:
        raise ValueError("part must be in ['all', 'upper', 'lower']")
    B, Ny, Nx = q.shape
    Wz = torch.where(torch.isnan(W), torch.zeros_like(W), W)
    iy = torch.arange(Ny, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    rows = []
    for js in _surface_chunks(Ny):
        jj = torch.arange(js.start, js.stop, device=q.device)
        qe = q[:, None] - Q[:, js, None, None]             # (B, c, Ny, Nx)
        m = (iy[None, :] >= jj[:, None])[None, :, :, None]
        mz = _part_zero(_mask3(qe, m, increase), part, increase)
        qz = torch.where(torch.isnan(qe), zero, qe)
        rows.append(-(qz * mz * Wz).sum(2))
    return torch.cat(rows, dim=1)


def _check_shapes(name, q, Q, W):
    if q.dim() != 3 or Q.dim() != 2 or W.dim() != 2:
        raise ValueError(f"{name}: expected q (B, Ny, Nx), Q (B, Ny), W (Ny, Nx)")
    B, Ny, Nx = q.shape
    if Q.shape != (B, Ny) or W.shape != (Ny, Nx):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(Q.shape)}, "
                         f"{tuple(W.shape)} disagree")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")


def lwa_lin(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
            increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA.  CPU tensors take the plain version; CUDA
    tensors launch K3 (a prep kernel, then the surface kernel)."""
    if q.device.type == "cpu":
        return lwa_lin_plain(q, Q, W, increase=increase)
    check_cuda_inputs(KERNEL_LIN.name, q=q, Q=Q, W=W)
    _check_shapes(KERNEL_LIN.name, q, Q, W)
    from ._build import library
    B, Ny, Nx = q.shape
    qc, Qc, Qt = _center(q, Q)
    Wz = torch.where(torch.isfinite(W), W, torch.zeros_like(W))
    qk = torch.empty_like(q)
    Wv = torch.empty_like(q)
    E = torch.empty_like(q)
    out = torch.empty_like(q)
    status = library().xc_lwa_lin(
        qc.data_ptr(), Wz.data_ptr(), Qt.data_ptr(), Qc.data_ptr(),
        qk.data_ptr(), Wv.data_ptr(), E.data_ptr(), out.data_ptr(),
        B, Ny, Nx, int(increase), stream_handle())
    check_status(KERNEL_LIN.name, status)
    KERNEL_LIN.launches += 1
    return out


def lwa_dense(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
              increase: bool, part: str = "all") -> torch.Tensor:
    """Pairwise LWA for part all/upper/lower.  CPU tensors take the plain
    version; CUDA tensors launch K4."""
    if part not in _PARTS:
        raise ValueError("part must be in ['all', 'upper', 'lower']")
    if q.device.type == "cpu":
        return lwa_dense_plain(q, Q, W, increase=increase, part=part)
    check_cuda_inputs(KERNEL_DENSE.name, q=q, Q=Q, W=W)
    _check_shapes(KERNEL_DENSE.name, q, Q, W)
    from ._build import library
    B, Ny, Nx = q.shape
    Wz = torch.where(torch.isnan(W), torch.zeros_like(W), W)
    out = torch.empty_like(q)
    status = library().xc_lwa_dense(
        q.data_ptr(), Wz.data_ptr(), Q.data_ptr(), out.data_ptr(),
        B, Ny, Nx, int(increase), _PARTS[part], stream_handle())
    check_status(KERNEL_DENSE.name, status)
    KERNEL_DENSE.launches += 1
    return out
