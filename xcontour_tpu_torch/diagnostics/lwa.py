"""Local finite-amplitude wave activity (LWA, Huang-Nakamura 2016).

Counterpart of ``xcontour_tpu/diagnostics/lwa.py`` for ``local_wave_activity``
and ``local_wave_activity2`` (the impulse-Casimir variant) with the 'lin',
'dense' and 'fast' methods, and ``lwa_masks_at`` (the masks at chosen
surfaces, for plotting).  'lin' runs the K3 (LWA) or K5 (LWA2) wrapper (the
exact mask linearization for part='all': 4 ops per pair, float32 noise
floor ~5e-5 of the field max); 'dense' runs the K4 wrapper (the
reference's pairwise 3-valued mask and summation order, ~1e-6, any part).
'fast' is the same linearization at sort cost (part='all'): the pairwise
sum over surfaces j becomes a suffix sum along y, a weighted CDF of the
tracer at the profile values and a total,

    LWA_j = -[ suffix_j(qe W) + CDF(qe W at Q_j) - total(qe W) ],

O(Ny Nx log Ny) in plain PyTorch (sort, cumsum, searchsorted, gather: the
JAX package's XLA library operations; its float32 floor ~3e-5 of the max).

The kernels and their plain versions (the JAX package's ``_lwa_lin_xla``
and ``_lwa_dense_xla``) live side by side in ``kernels/lwa.py``.

Conventions: fields are (..., Ny, Nx) with the equivalent dim at axis -2;
sorted profiles Q are (..., Ny).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import lwa as _kl
from ..kernels import needs_grad
from ..ops.sort import prefix_sums


def nanmax(t: torch.Tensor) -> torch.Tensor:
    """Maximum over all elements, skipping NaN (NaN if all are NaN)."""
    return torch.where(torch.isnan(t), float("-inf"), t).amax().where(
        ~torch.isnan(t).all(), float("nan"))


def _suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last axis."""
    return x.flip(-1).cumsum(-1).flip(-1)


def _centre(Q):
    """(c0, Qc): the NaN-skipping profile mean (0 where it is not finite),
    and the centred profile, 0 at invalid rows.  The mask depends only on
    sign(q - Q_j), so the common shift is exact, and it keeps the suffix,
    CDF and total terms from cancelling in float32."""
    validQ = torch.isfinite(Q)
    c0 = torch.nanmean(Q, dim=-1, keepdim=True)
    c0 = torch.where(torch.isfinite(c0), c0, torch.zeros_like(c0))
    return c0, torch.where(validQ, Q - c0, torch.zeros_like(Q))


def _cdf_at(values, w0, w1, queries):
    """(S0, S1) (B, R, m): per row, the sums of w0 and of w1 (B, R, n) over
    the values strictly below each query (B, R, m).  ``values`` is
    (B, R, n), or (B, 1, n) for one set of values shared by the R rows,
    sorted once.  Each row's values are sorted, the weights' prefix sums
    taken in that order and the queries searched strictly to the left, so
    a value tied with its query is left out: it would add
    w (value - query) = 0 to S1 - query S0 anyway."""
    B, R, m = queries.shape
    vs, order = torch.sort(values, dim=-1)
    V = values.shape[1]
    pos = torch.searchsorted(vs, queries.reshape(B, V, -1).contiguous(),
                             side="left").reshape(B, R, m)
    order = order.expand(B, R, -1)
    return [torch.gather(prefix_sums(torch.gather(w, -1, order)), -1, pos)
            for w in (w0, w1)]


def _columns(q, W):
    """The field and the weight with each column's y values contiguous,
    (B, Nx, Ny) and (Nx, Ny): the suffix sums, sorts and prefix sums all
    run along the innermost axis."""
    return q.transpose(1, 2).contiguous(), W.t().contiguous()


def _lwa_fast(q, Q, W, increase: bool):
    """part='all' LWA by the linearization.  q (B, Ny, Nx), Q (B, Ny),
    W (Ny, Nx) -> (B, Ny, Nx).

    The c-term is each column's weighted CDF of the tracer at the profile
    values (:func:`_cdf_at`).  Invalid cells sort to +inf with zero
    weight; NaN profile rows give zero rows."""
    B, Ny, Nx = q.shape
    qT, WT = _columns(q, W)                                  # (B, Nx, Ny)
    valid = torch.isfinite(qT) & torch.isfinite(WT)
    validQ = torch.isfinite(Q)[:, None, :]
    c0, Qc = _centre(Q)
    qc = qT - c0[..., None]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    wq = torch.where(valid, WT, zero)
    qwq = torch.where(valid, qc * WT, zero)
    sfxW, sfxQW = _suffix(wq), _suffix(qwq)
    T0, T1 = sfxW[..., :1], sfxQW[..., :1]
    Qj = Qc[:, None, :]
    S0, S1 = _cdf_at(torch.where(valid, qc, float("inf")).detach(), wq, qwq,
                     Qj.detach().expand(B, Nx, Ny))
    # increase: the mass strictly below Q_j; else its complement
    if not increase:
        S0, S1 = T0 - S0, T1 - S1
    out = -((sfxQW - Qj * sfxW) + (S1 - Qj * S0) - (T1 - Qj * T0))
    return torch.where(validQ, out, zero).transpose(1, 2).contiguous()


def _lwa2_fast(q, Q, W, increase: bool):
    """part='all' LWA2 by the linearization: qe = q(y_j, x) - Q(y).  The
    c-term's CDF runs over the profile values, shared by every column, so
    each profile is sorted once and every cell searches its own value.
    With the mask's flipped flag the mass is that of Q < q for
    increase=True, its complement else.  Invalid profile rows sort to +inf
    with zero weight; non-finite tracer cells give zeros."""
    B, Ny, Nx = q.shape
    qT, WT = _columns(q, W)                                  # (B, Nx, Ny)
    validQ = torch.isfinite(Q)
    v = validQ[:, None, :] & torch.isfinite(WT)
    c0, Qc = _centre(Q)
    qc = qT - c0[..., None]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    wq = torch.where(v, WT, zero)
    qwq = Qc[:, None, :] * wq
    sfxW, sfxQW = _suffix(wq), _suffix(qwq)
    T0, T1 = sfxW[..., :1], sfxQW[..., :1]
    key = torch.where(validQ, Qc, float("inf")).detach()[:, None, :]
    S0, S1 = _cdf_at(key, wq, qwq, qc.detach())
    if not increase:
        S0, S1 = T0 - S0, T1 - S1
    out = -((qc * sfxW - sfxQW) + (qc * S0 - S1) - (qc * T0 - T1))
    return torch.where(torch.isfinite(qT), out, zero).transpose(1, 2) \
        .contiguous()


# The Ny from which 'auto' takes 'fast' for part='all', measured on an
# NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py's ladder (4 x Ny x 512
# through local_wave_activity[2], PERF.md): 'fast' LWA is faster from 3072
# rows on (2.58 ms against K3's 3.62; 2.54 against 2.12 at 2048), 'fast'
# LWA2 from 2048; at ERA5's 721 rows K3 and K5 stay faster.
_FAST_NY_CROSSOVER = 3072


def _resolve_method(method: str, part: str, ny: int) -> str:
    """'auto' gives 'dense' for part selections ('split' among them),
    'fast' at Ny >= ``_FAST_NY_CROSSOVER`` and 'lin' below it; 'lin' and
    'fast' take only part='all'."""
    if method not in ("auto", "lin", "dense", "fast"):
        raise ValueError(f"method={method!r} not in "
                         "['auto', 'lin', 'dense', 'fast']")
    if method == "auto":
        if part != "all":
            return "dense"
        return "fast" if ny >= _FAST_NY_CROSSOVER else "lin"
    if method in ("lin", "fast") and part != "all":
        raise ValueError(f"method={method!r} only supports part='all' "
                         "(W+/W- selections multiply the two indicators)")
    return method


def _launch(q, Q, W, method, increase, part, variant2):
    """The kernel wrapper of ``method``: K3/K5 for 'lin', K4/K6 else."""
    if method == "lin":
        lin = _kl.lwa_lin2 if variant2 else _kl.lwa_lin
        return lin(q, Q, W, increase=increase)
    return _kl.lwa_dense(q, Q, W, increase=increase, part=part,
                         variant2=variant2)


class _LWA(torch.autograd.Function):
    """K3/K5 ('lin') or K4/K6 ('dense') with the plain twin's VJP (JAX:
    ``diagnostics/lwa._lwa_pallas_ad``): the lin twin for 'lin', the dense
    twin for 'dense' and part selections, recomputed 16 surfaces at a time
    (:func:`..kernels.lwa.lwa_vjp`).  For part='split' the output is the
    two halves stacked, and each half's cotangent goes through its own
    part's twin."""

    @staticmethod
    def forward(ctx, q, Q, W, method, increase, part, variant2):
        ctx.save_for_backward(q, Q, W)
        ctx.args = (method, increase, part, variant2)
        return _launch(q.detach(), Q.detach(), W.detach(), *ctx.args)

    @staticmethod
    def backward(ctx, g):
        method, increase, part, variant2 = ctx.args
        if method == "lin":
            kind, kw = ("lin2" if variant2 else "lin"), dict(increase=increase)
        else:
            kind = "dense"
            kw = dict(increase=increase, part=part, variant2=variant2)
        grads = _kl.lwa_vjp(kind, *ctx.saved_tensors, g,
                            ctx.needs_input_grad[:3], **kw)
        return (*grads, None, None, None, None)


def _lwa(q, Q, dA, ydef, increase, part, weight, method, variant2):
    part = part.lower()
    batch = q.shape[:-2]
    Ny, Nx = q.shape[-2:]
    method = _resolve_method(method, part, Ny)
    W = dA / nanmax(dA) * dA if weight is None else weight
    if ydef.shape != (Ny,):
        raise ValueError(f"ydef {tuple(ydef.shape)} does not match Ny={Ny}")
    qf = q.reshape(-1, Ny, Nx).contiguous()
    Qf = torch.broadcast_to(Q, batch + (Ny,)).reshape(-1, Ny).contiguous()
    W = torch.broadcast_to(W, (Ny, Nx)).contiguous()
    if method == "fast":
        fast = _lwa2_fast if variant2 else _lwa_fast
        return fast(qf, Qf, W, increase).reshape(batch + (Ny, Nx))
    args = (method, increase, part, variant2)
    if needs_grad(qf, Qf, W):
        out = _LWA.apply(qf, Qf, W, *args)
    else:
        out = _launch(qf.detach(), Qf.detach(), W.detach(), *args)
    if part == "split":
        return tuple(out.reshape((2,) + batch + (Ny, Nx)).unbind(0))
    return out.reshape(batch + (Ny, Nx))


def local_wave_activity(q: torch.Tensor, Q: torch.Tensor, dA: torch.Tensor,
                        ydef: torch.Tensor, *, increase: bool,
                        part: str = "all",
                        weight: Optional[torch.Tensor] = None,
                        method: str = "auto") -> torch.Tensor:
    """LWA (..., Ny, Nx) with the surface index j along axis -2.

    q : (..., Ny, Nx) tracer;  Q : (..., Ny) sorted profile on ``ydef``;
    dA : (Ny, Nx) cell areas;  ydef : (Ny,), strictly monotone.
    ``weight`` is the composed integration weight W(y, x); the default is
    the reference's wei*dA with wei = dA/max(dA).
    ``method``: 'auto', 'lin', 'dense' or 'fast' (module docstring);
    :func:`_resolve_method` gives the 'auto' policy.  'fast' runs no kernel
    and is differentiated by autograd through sort, gather and cumsum.
    ``part``: 'all', 'upper' (W+, the mask's +1 side), 'lower' (W-, its -1
    side), or 'split', which returns the tuple (upper, lower) from one
    pairwise pass ('dense'; one K4 launch on the card).
    """
    return _lwa(q, Q, dA, ydef, increase, part, weight, method, False)


def local_wave_activity2(q: torch.Tensor, Q: torch.Tensor, dA: torch.Tensor,
                         ydef: torch.Tensor, *, increase: bool,
                         part: str = "all",
                         weight: Optional[torch.Tensor] = None,
                         method: str = "auto") -> torch.Tensor:
    """Impulse-Casimir LWA2: qe = q(y_j, x) - Q(y), the mask built with the
    flipped ``increase`` flag while the part selection keeps the original.
    Arguments as in :func:`local_wave_activity`."""
    return _lwa(q, Q, dA, ydef, increase, part, weight, method, True)


def lwa_masks_at(q: torch.Tensor, Q: torch.Tensor, dA: torch.Tensor,
                 ydef: torch.Tensor, mask_idx, *, increase: bool,
                 variant2: bool = False):
    """The reference's 3-valued LWA masks and contour values at the
    surface indices ``mask_idx``, for plotting (its ``mask_idx`` outputs,
    core.py:768-770).  Returns (contours (..., K), masks (K, ..., Ny, Nx)).

    ``variant2`` takes LWA2's deviation, row j of q against the whole
    profile, qe = q(y_j, x) - Q(y), with the direction flipped.  Plain
    PyTorch, one surface at a time (K is a handful; the masks are
    K * B * Ny * Nx values).  ``dA`` is unused, as in the JAX package."""
    del dA
    idx = [int(j) for j in torch.as_tensor(mask_idx).reshape(-1).tolist()]
    coord_incre = ydef[-1] > ydef[0]
    masks = []
    for j in idx:
        if variant2:
            qe = q[..., j, :][..., None, :] - Q[..., :, None]
            inc = not increase
        else:
            qe = q - Q[..., j][..., None, None]
            inc = increase
        yj = ydef[j]
        m = torch.where(coord_incre, ydef >= yj, ydef <= yj)[:, None]
        masks.append(_kl._mask3(qe, m, inc))
    contours = Q[..., idx]
    return contours, torch.stack(masks)
