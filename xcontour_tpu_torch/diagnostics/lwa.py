"""Local finite-amplitude wave activity (LWA, Huang-Nakamura 2016).

Counterpart of ``xcontour_tpu/diagnostics/lwa.py`` for ``local_wave_activity``
and ``local_wave_activity2`` (the impulse-Casimir variant) with the 'lin'
and 'dense' methods.  'lin' runs the K3 (LWA) or K5 (LWA2) wrapper (the
exact mask linearization for part='all': 4 ops per pair, float32 noise
floor ~5e-5 of the field max); 'dense' runs the K4 wrapper (the
reference's pairwise 3-valued mask and summation order, ~1e-6, any part).

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


def nanmax(t: torch.Tensor) -> torch.Tensor:
    """Maximum over all elements, skipping NaN (NaN if all are NaN)."""
    return torch.where(torch.isnan(t), float("-inf"), t).amax().where(
        ~torch.isnan(t).all(), float("nan"))


def _resolve_method(method: str, part: str) -> str:
    """'auto' gives 'dense' for part selections and 'lin' otherwise, at every
    Ny.  'fast' (the sort-merge path) is not ported: ROADMAP Queue 1 item 13,
    which also re-measures its crossover on the H100."""
    if method not in ("auto", "lin", "dense", "fast"):
        raise ValueError(f"method={method!r} not in "
                         "['auto', 'lin', 'dense', 'fast']")
    if method == "fast":
        raise NotImplementedError(
            "lwa method 'fast' (sort-merge) is not ported yet: ROADMAP "
            "Queue 1 item 13")
    if method == "auto":
        return "dense" if part != "all" else "lin"
    if method == "lin" and part != "all":
        raise ValueError("method='lin' only supports part='all' "
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
    (:func:`..kernels.lwa.lwa_vjp`)."""

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
    method = _resolve_method(method, part)
    W = dA / nanmax(dA) * dA if weight is None else weight
    batch = q.shape[:-2]
    Ny, Nx = q.shape[-2:]
    if ydef.shape != (Ny,):
        raise ValueError(f"ydef {tuple(ydef.shape)} does not match Ny={Ny}")
    qf = q.reshape(-1, Ny, Nx).contiguous()
    Qf = torch.broadcast_to(Q, batch + (Ny,)).reshape(-1, Ny).contiguous()
    W = torch.broadcast_to(W, (Ny, Nx)).contiguous()
    args = (method, increase, part, variant2)
    if needs_grad(qf, Qf, W):
        out = _LWA.apply(qf, Qf, W, *args)
    else:
        out = _launch(qf.detach(), Qf.detach(), W.detach(), *args)
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
