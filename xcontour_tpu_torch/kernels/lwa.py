"""K3-K6: local wave activity kernels (CUDA: ``csrc/lwa.cu``).

K3 (:func:`lwa_lin`) replaces ``_kernel_lin`` of
``xcontour_tpu/kernels/lwa_pallas.py``: the linearized part='all' LWA,
-(R_j + E[j]), centered on the mean of the finite profile values (the
kernels center as they read; E is scanned in 32-row chunks).  Its plain
version is the JAX package's ``_lwa_lin_xla``.

K5 (:func:`lwa_lin2`) replaces ``_kernel_lin2`` of the same file: the
linearized part='all' impulse-Casimir LWA2, qe = q(y_j, x) - Q(y).  Its
plain version is ``_lwa_lin_xla(variant2=True)``.

K4 (:func:`lwa_dense`) replaces ``_kernel`` of the same file (pairwise,
both variants): the reference's 3-valued mask times qe*W summed over y,
parts all/upper/lower.  Its plain version is ``_lwa_dense_xla``.  A fourth
part, 'split', has no JAX counterpart: the upper and lower halves, stacked
as (2, B, Ny, Nx), from one pass over the pairs (one launch), each equal
to its single part's output.  Both the kernel and the plain version zero
NaN weights like ``_lwa_dense_xla`` (the TPU kernel does not).  K6 replaces ``_kernel_yblocked``, the TPU's form of
the same sum for Ny > 3072; here one CUDA kernel serves every Ny, and a
launch at such a Ny counts as K6's.

Shapes: q (B, Ny, Nx) tracer, Q (B, Ny) sorted profile, W (Ny, Nx) composed
weight -> (B, Ny, Nx), surface index j along axis 1.  The surface mask is
the index form (row >= j), exact for a strictly monotone coordinate.  The
kernels take any batch (launched in chunks of 65,535 elements, CUDA's cap
on a grid's y and z) and fewer than 2^31 cells (32-bit offsets within a
snapshot's rows and columns); Ny and Nx each up to 65,535 * 32, the grid
y dimension of their row chunks and column strips.
"""

from __future__ import annotations

import functools

import torch

from . import Kernel, check_cuda_inputs, check_status, stream_handle, vjp

KERNEL_LIN = Kernel("lwa_lin", "xcontour_tpu_torch/csrc/lwa.cu",
                    "xcontour_tpu/kernels/lwa_pallas.py:86")
KERNEL_DENSE = Kernel("lwa_dense", "xcontour_tpu_torch/csrc/lwa.cu",
                      "xcontour_tpu/kernels/lwa_pallas.py:216")
KERNEL_LIN2 = Kernel("lwa_lin2", "xcontour_tpu_torch/csrc/lwa.cu",
                     "xcontour_tpu/kernels/lwa_pallas.py:157")
KERNEL_DENSE_TALL = Kernel("lwa_dense_tall", "xcontour_tpu_torch/csrc/lwa.cu",
                           "xcontour_tpu/kernels/lwa_pallas.py:262")

_PARTS = {"all": 0, "upper": 1, "lower": 2, "split": 3}

# rows per chunk of K3's E prep (kCH in csrc/lwa.cu)
E_CHUNK = 32
# the longest side the launches take: 65,535 row chunks or column strips of
# 32 in a grid's y dimension
_MAX_SIDE = 65535 * 32

# the JAX package's y-blocked regime: a (Ny, 128) float32 panel over its
# 1.5 MB VMEM budget (lwa_pallas.py:430)
TALL_NY = 3072


def _shift(Q):
    """Mean of each profile's finite values (0 for an all-invalid one)."""
    validQ = torch.isfinite(Q)
    mean = torch.nanmean(torch.where(validQ, Q, torch.full_like(Q, float("nan"))), -1)
    return torch.where(validQ.any(-1), mean, torch.zeros_like(mean))


def _center(q, Q):
    """Shift by the mean of the finite profile values (exact for LWA: the
    mask depends only on sign(q - Q_j)); it keeps the R and E terms from
    cancelling large magnitudes in float32."""
    c0 = _shift(Q).to(q.dtype)
    qc = q - c0[:, None, None]
    Qc = Q - c0[:, None]
    Qt = torch.where(torch.isfinite(Q), Qc, torch.zeros_like(Qc))
    return qc, Qc, Qt


# surfaces per step of the plain versions: bounds their (B, chunk, Ny, Nx)
# temporaries
_CHUNK = 16


def _surface_chunks(Ny: int):
    return [slice(j, min(Ny, j + _CHUNK)) for j in range(0, Ny, _CHUNK)]


def _prefix_E(inc):
    """E[0] = 0, E[j] = sum of the increments below j, along axis 1."""
    B, _, Nx = inc.shape
    zero = torch.zeros((B, 1, Nx), dtype=inc.dtype, device=inc.device)
    return torch.cat([zero, torch.cumsum(inc, dim=1)], dim=1)


def _lin_parts(q, Q, W, *, increase: bool):
    """lwa_lin_plain's per-field terms (qk, Qc, Wv, E)."""
    qc, Qc, Qt = _center(q, Q)
    sent = float("inf") if increase else float("-inf")
    valid = torch.isfinite(q) & torch.isfinite(W)
    qk = torch.where(valid, qc, torch.full_like(qc, sent))
    Wv = torch.where(valid, W, torch.zeros_like(qc))
    qt = torch.where(valid, qc, torch.zeros_like(qc))
    P0 = torch.cumsum(Wv, dim=1) - Wv
    E = _prefix_E((Qt[:, 1:, None] - qt[:, :-1]) * Wv[:, :-1]
                  + (Qt[:, 1:] - Qt[:, :-1])[..., None] * P0[:, :-1])
    return qk, Qc, Wv, E


def _lin_rows(parts, js: slice, *, increase: bool):
    """lwa_lin_plain's surfaces ``js`` (B, c, Nx) from its parts."""
    qk, Qc, Wv, E = parts
    zero = torch.zeros((), dtype=qk.dtype, device=qk.device)
    Qj = Qc[:, js, None, None]                            # (B, c, 1, 1)
    qe = qk[:, None] - Qj                                 # (B, c, Ny, Nx)
    ext = torch.minimum(qe, zero) if increase else torch.maximum(qe, zero)
    R = (ext * Wv[:, None]).sum(2)                        # (B, c, Nx)
    row = -(R + E[:, js])
    return torch.where(torch.isnan(Qj[..., 0]), zero, row)


def lwa_lin_plain(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
                  increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA in plain PyTorch (``_lwa_lin_xla``): the
    E t-term by the telescoping recurrence plus a chunked 4-op c-term
    reduction per surface."""
    parts = _lin_parts(q, Q, W, increase=increase)
    return torch.cat([_lin_rows(parts, js, increase=increase)
                      for js in _surface_chunks(q.shape[1])], dim=1)


def _lin2_parts(q, Q, W, *, increase: bool):
    """lwa_lin2_plain's per-field terms (qc, Qs, Wv, E)."""
    qc, Qc, Qt = _center(q, Q)
    validQ = torch.isfinite(Q)
    sent = float("inf") if increase else float("-inf")
    Qs = torch.where(validQ, Qc, torch.full_like(Qc, sent))
    Wv = torch.where(validQ[:, :, None] & torch.isfinite(W), W,
                     torch.zeros_like(qc))
    P0 = torch.cumsum(Wv, dim=1) - Wv
    qt = torch.where(torch.isfinite(q), qc, torch.zeros_like(qc))
    E = _prefix_E((Qt[:, :-1, None] - qt[:, 1:]) * Wv[:, :-1]
                  - (qt[:, 1:] - qt[:, :-1]) * P0[:, :-1])
    return qc, Qs, Wv, E


def _lin2_rows(parts, js: slice, *, increase: bool):
    """lwa_lin2_plain's surfaces ``js`` (B, c, Nx) from its parts."""
    qc, Qs, Wv, E = parts
    zero = torch.zeros((), dtype=qc.dtype, device=qc.device)
    qrow = qc[:, js]                                      # (B, c, Nx)
    qe = qrow[:, :, None, :] - Qs[:, None, :, None]       # (B, c, Ny, Nx)
    ext = torch.maximum(qe, zero) if increase else torch.minimum(qe, zero)
    R = (ext * Wv[:, None]).sum(2)                        # (B, c, Nx)
    row = -(R + E[:, js])
    return torch.where(torch.isfinite(qrow), row, zero)


def lwa_lin2_plain(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
                   increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA2 in plain PyTorch
    (``_lwa_lin_xla(variant2=True)``): invalid profile rows become
    sentinels with zero weight, the t-term E follows the variant-2
    telescoping recurrence, and a non-finite surface value gives 0."""
    parts = _lin2_parts(q, Q, W, increase=increase)
    return torch.cat([_lin2_rows(parts, js, increase=increase)
                      for js in _surface_chunks(q.shape[1])], dim=1)


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
                    increase: bool, part: str = "all",
                    variant2: bool = False) -> torch.Tensor:
    """Pairwise LWA in plain PyTorch (``_lwa_dense_xla``): excluded and NaN
    terms are exact zeros, NaN weights count as zero.  ``variant2`` takes
    qe = q(y_j, x) - Q(y) with the mask built from ``not increase`` and
    the part selected with ``increase`` (the reference's LWA2).
    ``part='split'`` gives the upper and lower halves stacked, (2, B, Ny,
    Nx), each the same values as its own part gives."""
    _check_part(part)
    parts = _dense_parts(q, Q, W)
    kw = dict(increase=increase, part=part, variant2=variant2)
    return torch.cat([_dense_rows(parts, js, **kw)
                      for js in _surface_chunks(q.shape[1])], dim=-2)


def _dense_parts(q, Q, W):
    """lwa_dense_plain's per-field terms: q, Q and W with NaN weights
    zeroed."""
    return q, Q, torch.where(torch.isnan(W), torch.zeros_like(W), W)


def _check_part(part: str) -> None:
    if part not in _PARTS:
        raise ValueError(f"part must be in {list(_PARTS)}")


def _dense_rows(parts, js: slice, *, increase: bool, part: str,
                variant2: bool):
    """lwa_dense_plain's surfaces ``js`` (B, c, Nx) from its parts; (2, B,
    c, Nx) for part='split'."""
    q, Q, Wz = parts
    iy = torch.arange(q.shape[1], device=q.device)
    jj = torch.arange(js.start, js.stop, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    if variant2:
        qe = q[:, js, None, :] - Q[:, None, :, None]       # (B, c, Ny, Nx)
    else:
        qe = q[:, None] - Q[:, js, None, None]              # (B, c, Ny, Nx)
    m = (iy[None, :] >= jj[:, None])[None, :, :, None]
    mask = _mask3(qe, m, increase != variant2)
    qz = torch.where(torch.isnan(qe), zero, qe)
    halves = ("upper", "lower") if part == "split" else (part,)
    rows = [-(qz * _part_zero(mask, h, increase) * Wz).sum(2)
            for h in halves]
    return torch.stack(rows) if part == "split" else rows[0]


def lwa_vjp(kind: str, q, Q, W, g, needs, **kw):
    """Cotangents of (q, Q, W) of the plain version ``kind`` ('lin',
    'lin2' or 'dense', keyword arguments ``kw``) for the cotangent g
    (B, Ny, Nx), or (2, B, Ny, Nx) for 'dense' with part='split' (the
    halves' cotangents): its per-field terms once, its surfaces recomputed
    and differentiated 16 at a time, so the backward holds one chunk's
    (B, 16, Ny, Nx) temporaries (the JAX package differentiates the same
    twins: 'lin' for method 'lin', 'dense' for 'dense' and parts)."""
    prep, rows = {"lin": (_lin_parts, _lin_rows),
                  "lin2": (_lin2_parts, _lin2_rows),
                  "dense": (_dense_parts, _dense_rows)}[kind]
    if kind != "dense":
        prep = functools.partial(prep, **kw)
    pieces = [(functools.partial(rows, js=js, **kw), g[..., js, :])
              for js in _surface_chunks(q.shape[1])]
    return vjp(pieces, (q, Q, W), needs, prep=prep)


def _check_shapes(name, q, Q, W):
    if q.dim() != 3 or Q.dim() != 2 or W.dim() != 2:
        raise ValueError(f"{name}: expected q (B, Ny, Nx), Q (B, Ny), W (Ny, Nx)")
    B, Ny, Nx = q.shape
    if Q.shape != (B, Ny) or W.shape != (Ny, Nx):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(Q.shape)}, "
                         f"{tuple(W.shape)} disagree")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 cells")
    if max(Ny, Nx) > _MAX_SIDE:
        raise ValueError(f"{name}: Ny or Nx over {_MAX_SIDE}")


def lwa_lin(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
            increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA.  CPU tensors take the plain version; CUDA
    tensors launch K3 (a chunked prep kernel for E, then the surface kernel;
    both center and sanitize on the fly, so E and its chunk totals are the
    only scratch)."""
    if q.device.type == "cpu":
        return lwa_lin_plain(q, Q, W, increase=increase)
    check_cuda_inputs(KERNEL_LIN.name, q=q, Q=Q, W=W)
    _check_shapes(KERNEL_LIN.name, q, Q, W)
    from ._build import library
    B, Ny, Nx = q.shape
    c0 = _shift(Q).contiguous()
    E = torch.empty_like(q)
    tot = torch.empty((B, -(-Ny // E_CHUNK), 2, Nx), dtype=q.dtype,
                      device=q.device)
    out = torch.empty_like(q)
    status = library().xc_lwa_lin(
        q.data_ptr(), W.data_ptr(), Q.data_ptr(), c0.data_ptr(),
        E.data_ptr(), tot.data_ptr(), out.data_ptr(), B, Ny, Nx,
        int(increase), stream_handle())
    check_status(KERNEL_LIN.name, status)
    KERNEL_LIN.count()
    return out


def lwa_lin2(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
             increase: bool) -> torch.Tensor:
    """Linearized part='all' LWA2.  CPU tensors take the plain version;
    CUDA tensors launch K5 (a prep kernel for E, then the surface kernel;
    both center on the fly, so E is the only scratch)."""
    if q.device.type == "cpu":
        return lwa_lin2_plain(q, Q, W, increase=increase)
    check_cuda_inputs(KERNEL_LIN2.name, q=q, Q=Q, W=W)
    _check_shapes(KERNEL_LIN2.name, q, Q, W)
    from ._build import library
    B, Ny, Nx = q.shape
    c0 = _shift(Q).contiguous()
    E = torch.empty_like(q)
    out = torch.empty_like(q)
    status = library().xc_lwa_lin2(
        q.data_ptr(), Q.data_ptr(), W.data_ptr(), c0.data_ptr(),
        E.data_ptr(), out.data_ptr(), B, Ny, Nx, int(increase),
        stream_handle())
    check_status(KERNEL_LIN2.name, status)
    KERNEL_LIN2.count()
    return out


def lwa_dense(q: torch.Tensor, Q: torch.Tensor, W: torch.Tensor, *,
              increase: bool, part: str = "all",
              variant2: bool = False) -> torch.Tensor:
    """Pairwise LWA (or LWA2 with ``variant2``) for part all/upper/lower,
    or both halves stacked, (2, B, Ny, Nx), for part='split'.  CPU tensors
    take the plain version; CUDA tensors launch K4 (one launch for any
    part, split included), counted as K6 when Ny > ``TALL_NY``."""
    _check_part(part)
    if q.device.type == "cpu":
        return lwa_dense_plain(q, Q, W, increase=increase, part=part,
                               variant2=variant2)
    record = KERNEL_DENSE_TALL if q.shape[-2] > TALL_NY else KERNEL_DENSE
    check_cuda_inputs(record.name, q=q, Q=Q, W=W)
    _check_shapes(record.name, q, Q, W)
    from ._build import library
    B, Ny, Nx = q.shape
    Wz = torch.where(torch.isnan(W), torch.zeros_like(W), W)
    split = part == "split"
    out = q.new_empty((2,) + q.shape if split else q.shape)
    first, second = out.unbind(0) if split else (out, None)
    status = library().xc_lwa_dense(
        q.data_ptr(), Wz.data_ptr(), Q.data_ptr(), first.data_ptr(),
        second.data_ptr() if split else None, B, Ny, Nx, int(increase),
        _PARTS[part], int(variant2), stream_handle())
    check_status(record.name, status)
    record.count()
    return out
