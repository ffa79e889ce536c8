"""Contour-space core: the conservative-rearrangement engine.

Counterpart of ``xcontour_tpu/core.py``: contour levels, the conditional
integrals (histogram, broadcast and exact sort-based paths), the A(Y_eq)
lookup tables, the Keff algebra (d/dA, Leq^2, normalized Keff), the contour
means, the contour -> coordinate interpolation with the contour levels at
prescribed coordinates, and the reference-compatible :class:`Contour2D`
facade over all of them (and over LWA and the contour geometry).

Array conventions: plane fields (..., Ny, Nx) with the equivalent dim at
axis -2; contour-space tensors (..., N) with the contour index last.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .diagnostics import length as _length
from .diagnostics import lwa as _lwa
from .grid import Grid, _device, from_metrics, to_numpy
from .kernels import needs_grad, vjp
from .kernels import extrema as _extrema
from .ops.gradient import gradient_index
from .ops.histogram import weighted_cdf, weighted_cdf_both
from .ops.interp import interp1d
from .ops.sort import exact_conditional_integral
from .utils.checks import check_monotonic
from .utils.ncio import Dataset


def cal_contours(tracer: torch.Tensor, N: int, *,
                 increase: bool = True) -> torch.Tensor:
    """N equally spaced levels between each batch element's NaN-skipping
    min and max, min->max if ``increase`` else max->min.  The last level is
    pinned to the extremum (np.linspace semantics), so the extreme cell is
    never dropped from a >=-CDF; an all-NaN element gives NaN levels.  One
    call of E (:mod:`.kernels.extrema`) on the card, its plain version on
    the CPU.  On the card the tracer is float32 or float64: E raises
    ``TypeError`` for any other dtype (float16, bfloat16), which the plain
    chain ran before E."""
    x = _snapshots(tracer)
    if needs_grad(x):
        levels = _ContourLevels.apply(x, N, increase)
    else:
        levels = _extrema.contour_levels(x, N, increase=increase)
    return levels.reshape(tracer.shape[:-2] + (N,))


def masked_extrema(tracer: torch.Tensor):
    """(min, max) of each batch element over its plane with NaN cells
    skipped: +inf and -inf where every cell is NaN.  The sharded levels
    reduce these over the x axis before :func:`levels_from_extrema` maps
    the infinities to NaN, so an all-NaN slab does not poison the
    reduction.  E's extrema mode on the card, float32 or float64 there
    (``TypeError`` for any other dtype, as :func:`cal_contours`)."""
    x = _snapshots(tracer)
    if needs_grad(x):
        mmin, mmax = _MaskedExtrema.apply(x)
    else:
        mmin, mmax = _extrema.masked_extrema(x)
    return mmin.reshape(tracer.shape[:-2]), mmax.reshape(tracer.shape[:-2])


# :func:`cal_contours`' levels from :func:`masked_extrema` (the sharded
# levels reduce the extrema between the two)
levels_from_extrema = _extrema.levels_plain


def _snapshots(tracer: torch.Tensor) -> torch.Tensor:
    """(..., Ny, Nx) as contiguous (B, Ny, Nx)."""
    return tracer.reshape((-1,) + tracer.shape[-2:]).contiguous()


class _ContourLevels(torch.autograd.Function):
    """E's levels with the plain chain's VJP: ``amin`` and ``amax`` split
    an extremum's cotangent equally between the cells that attain it (as
    JAX's min and max do)."""

    @staticmethod
    def forward(ctx, x, N, increase):
        ctx.save_for_backward(x)
        ctx.kw = (N, increase)
        return _extrema.contour_levels(x.detach(), N, increase=increase)

    @staticmethod
    def backward(ctx, g):
        N, increase = ctx.kw

        def plain(p):
            return _extrema.levels_plain(*_extrema.masked_extrema_plain(p[0]),
                                         N, increase=increase)
        return (*vjp([(plain, g)], ctx.saved_tensors, (True,)), None, None)


class _MaskedExtrema(torch.autograd.Function):
    """E's extrema mode with the plain version's VJP."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        return _extrema.masked_extrema(x.detach())

    @staticmethod
    def backward(ctx, g_min, g_max):
        pieces = [(lambda p, i=i: _extrema.masked_extrema_plain(p[0])[i], g)
                  for i, g in enumerate((g_min, g_max)) if g is not None]
        if not pieces:
            return None
        return tuple(vjp(pieces, ctx.saved_tensors, (True,)))


def cal_integral_within_contours_hist(tracer, contours, dA, integrand=None, *,
                                      lt: bool = False):
    """Histogram conditional integrals: weights = integrand*dA, NaN -> 0."""
    wei = dA if integrand is None else integrand * dA
    return weighted_cdf(tracer, contours, torch.broadcast_to(wei, tracer.shape),
                        lt)


def cal_integral_within_contours_exact(tracer, contours, dA, integrand=None,
                                       *, lt: bool = False):
    """Exact sort-based path (:mod:`.ops.sort`): the broadcast path's strict
    conditional sums at sort cost, with no binning and no (contour x grid)
    temporaries."""
    wei = dA if integrand is None else integrand * dA
    wei = torch.broadcast_to(wei, tracer.shape)
    return exact_conditional_integral(tracer, contours, wei, lt)


# contour levels per step of the broadcast paths: bounds their
# (..., chunk, Ny, Nx) temporaries
_CHUNK = 16


def cal_integral_within_contours(tracer, contours, dA, integrand=None, *,
                                 lt: bool = False):
    """Broadcast path: for each contour C, the NaN-skipping integral of
    ``integrand`` * dA where tracer < C (``lt``) or > C, chunked over
    contour levels."""
    if integrand is None:
        integrand = tracer - tracer + 1.0     # NaN where the tracer is NaN
    batch = tracer.shape[:-2]
    ctr = torch.broadcast_to(contours, batch + contours.shape[-1:])
    f_dA = (integrand * dA)[..., None, :, :]
    t = tracer[..., None, :, :]
    zero = torch.zeros((), dtype=f_dA.dtype, device=f_dA.device)
    outs = []
    for k in range(0, ctr.shape[-1], _CHUNK):
        c = ctr[..., k:k + _CHUNK, None, None]            # (..., c, 1, 1)
        cond = t < c if lt else t > c
        outs.append(torch.nansum(torch.where(cond, f_dA, zero), dim=(-2, -1)))
    return torch.cat(outs, dim=-1)


@dataclasses.dataclass(frozen=True)
class Table:
    """One-to-one map y = F(x) between area (values) and equivalent
    coordinate (coords), direction-aware both ways."""

    values: torch.Tensor  # (..., Ny) table values (e.g. area A)
    coords: torch.Tensor  # (Ny,) equivalent coordinates

    @classmethod
    def from_numpy(cls, values, coords, *, dtype=None, device=None) -> "Table":
        """A precomputed table carried across as numpy arrays, on the card
        unless ``device`` says otherwise (as the grid constructors)."""
        device = _device(device)

        def t(a):
            out = torch.as_tensor(np.array(a), device=device)
            return out if dtype is None else out.to(dtype)
        return cls(values=t(values), coords=t(coords))

    def to(self, device) -> "Table":
        return Table(values=self.values.to(device),
                     coords=self.coords.to(device))

    def _inc_values(self) -> bool:
        """Direction of the values.  Every batch element must agree (the
        reference raises "not every time or level is increasing/decreasing");
        the check reads the device once per Table."""
        cached = self.__dict__.get("_inc")
        if cached is not None:
            return cached
        v = self.values.reshape(-1, self.values.shape[-1])
        inc = (v[:, -1] > v[:, 0]).cpu()
        if not bool((inc == inc[0]).all()):
            raise ValueError(
                "Table: not every batch element (time/level) is "
                "increasing/decreasing — mixed-direction table values")
        object.__setattr__(self, "_inc", bool(inc[0]))
        return self.__dict__["_inc"]

    def check_direction(self) -> None:
        """Raise ValueError unless every batch element of the values runs in
        one direction (the JAX package's checkify guard, as an explicit
        check).  It reads the device once per Table, with the lookups."""
        self._inc_values()

    def lookup_coordinates(self, values: torch.Tensor) -> torch.Tensor:
        """Given values (y), return coordinates (x)."""
        return interp1d(values, self.values, self.coords,
                        increasing=self._inc_values())

    def lookup_values(self, coords: torch.Tensor) -> torch.Tensor:
        """Given coordinates (x), return values (y)."""
        inc_cd = self.coords[-1] > self.coords[0]
        return interp1d(coords, self.coords, self.values, increasing=inc_cd)


def cal_area_eqCoord_table(mask, ydef, dA, *, increase: bool,
                           lt: bool) -> Table:
    """Conditional-integration A(y_eq) table: for each surface y_j, the
    fluid area on one side of it, the side set by the coordinate's
    direction relative to ``increase`` and by ``lt``, chunked over
    surfaces.  The increasing end is forced to the total fluid area."""
    y = ydef
    # the area where y < y_j, or where y > y_j; selected on the device
    below = ((y[-1] > y[0]) == increase) == lt
    mdA = (mask * dA)[..., None, :, :]
    zero = torch.zeros((), dtype=mdA.dtype, device=mdA.device)
    outs = []
    for k in range(0, y.shape[0], _CHUNK):
        yj = y[k:k + _CHUNK, None]                          # (c, 1)
        cond = torch.where(below, y[None, :] < yj, y[None, :] > yj)
        w = torch.where(cond[:, :, None], mdA, zero)       # (..., c, Ny, Nx)
        outs.append(torch.abs(torch.nansum(w, dim=(-2, -1))))
    tbl = torch.cat(outs, dim=-1)
    max_area = torch.abs(torch.nansum(mask * dA, dim=(-2, -1)))
    incr = tbl[..., -1] > tbl[..., 0]
    last = torch.where(incr, max_area, tbl[..., -1])
    first = torch.where(incr, tbl[..., 0], max_area)
    tbl[..., -1] = last
    tbl[..., 0] = first
    return Table(values=tbl, coords=ydef)


def cal_area_eqCoord_table_hist(mask, ydef, dA, *, increase: bool,
                                lt: bool) -> Table:
    """Histogram A(y_eq) table: the masked y-coordinate field itself,
    histogrammed with dA weights.  Which comparison applies depends on the
    coordinate's direction relative to ``increase``; both CDFs are finished
    from one digitize and the right one selected, so no device value is
    read."""
    y = ydef
    y_incre = ~(y[-1] < y[0])
    ctr_var = torch.broadcast_to(y[:, None], mask.shape)
    ctr_var = torch.where(mask == 1, ctr_var,
                          torch.full_like(ctr_var, float("nan")))
    w = torch.broadcast_to(dA, mask.shape)
    cdf_lt, cdf_gt = weighted_cdf_both(ctr_var, y, w, lt)
    values = torch.where(y_incre == increase, cdf_lt, cdf_gt)
    return Table(values=values, coords=ydef)


def _finite_or_zero(t):
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


class _GradSafeDiv(torch.autograd.Function):
    """``num / den``: the plain division's primal (0/0 NaN, x/0 inf), and
    the JAX package's grad-safe VJP (``core._grad_safe_div``).  Degenerate
    lanes (den == 0, a non-finite operand) and non-finite products take
    the zero subgradient, so a zero cotangent never meets a NaN jacobian
    in the Keff tail; the live lanes' cotangents are factored, g/d before
    the next /d, so no den^2 under- or overflows.  The backward is plain
    torch ops, so it can be differentiated again."""

    @staticmethod
    def forward(ctx, num, den):
        ctx.save_for_backward(num, den)
        return num / den

    @staticmethod
    def backward(ctx, g):
        num, den = ctx.saved_tensors
        bad = (den == 0) | ~torch.isfinite(den) | ~torch.isfinite(num)
        d = torch.where(bad, torch.ones_like(den), den)
        gd = g / d
        zero = torch.zeros_like(gd)
        gnum = _finite_or_zero(torch.where(bad, zero, gd))
        gden = _finite_or_zero(torch.where(bad, zero, -gd * (num / d)))
        return gnum.sum_to_size(num.shape), gden.sum_to_size(den.shape)


class _GradSafeDivSq(torch.autograd.Function):
    """``num / (den * den)`` (the Leq^2 form) with the plain primal and
    JAX's fused, factored VJP (``core._grad_safe_div_sq``): the cotangent
    into den is -2 (g (num/d/d)) / d, each intermediate in float32 range
    where a den^2 followed by a division would overflow; lanes where den^2
    underflows to 0 count as degenerate too."""

    @staticmethod
    def forward(ctx, num, den):
        ctx.save_for_backward(num, den)
        return num / (den * den)

    @staticmethod
    def backward(ctx, g):
        num, den = ctx.saved_tensors
        bad = ((den == 0) | (den * den == 0) | ~torch.isfinite(den)
               | ~torch.isfinite(num))
        d = torch.where(bad, torch.ones_like(den), den)
        gd = g / d
        L = (num / d) / d
        zero = torch.zeros_like(gd)
        gnum = _finite_or_zero(torch.where(bad, zero, gd / d))
        gden = _finite_or_zero(torch.where(bad, zero, -2.0 * (g * L) / d))
        return gnum.sum_to_size(num.shape), gden.sum_to_size(den.shape)


def grad_safe_div(num, den):
    """``num / den`` whose gradient zeroes degenerate lanes
    (:class:`_GradSafeDiv`); the plain division where nothing needs a
    gradient."""
    if needs_grad(num, den):
        return _GradSafeDiv.apply(num, den)
    return num / den


def grad_safe_div_sq(num, den):
    """``num / (den * den)`` with the grad-safe VJP
    (:class:`_GradSafeDivSq`); plain where nothing needs a gradient."""
    if needs_grad(num, den):
        return _GradSafeDivSq.apply(num, den)
    return num / (den * den)


def cal_gradient_wrt_area(var, area):
    """dVar/dA via centered differences along the contour index (0/0 gives
    NaN, x/0 inf: the plain division, with the grad-safe VJP)."""
    return grad_safe_div(gradient_index(var, -1), gradient_index(area, -1))


def cal_contour_weigh_mean(tracer, contours, dA, integrand, area=None, *,
                           lt: bool = False):
    """Thickness-weighted line average d(int f dA)/dA, broadcast
    integrals."""
    intA = cal_integral_within_contours(tracer, contours, dA, integrand, lt=lt)
    if area is None:
        area = cal_integral_within_contours(tracer, contours, dA, lt=lt)
    return cal_gradient_wrt_area(intA, area)


def cal_contour_weigh_mean_hist(tracer, contours, dA, integrand, area=None, *,
                                lt: bool = False):
    """:func:`cal_contour_weigh_mean` with histogram integrals."""
    intA = cal_integral_within_contours_hist(tracer, contours, dA, integrand,
                                             lt=lt)
    if area is None:
        area = cal_integral_within_contours_hist(tracer, contours, dA, lt=lt)
    return cal_gradient_wrt_area(intA, area)


def cal_contour_mean(tracer, contours, dA, integrand, grdm, area=None, *,
                     lt: bool = False):
    """Along-contour mean <f |grad q|> / <|grad q|>, broadcast integrals
    (0/0 gives NaN: the plain division, with the grad-safe VJP)."""
    upper = cal_contour_weigh_mean(tracer, contours, dA, integrand * grdm,
                                   area, lt=lt)
    lower = cal_contour_weigh_mean(tracer, contours, dA, grdm, area, lt=lt)
    return grad_safe_div(upper, lower)


def cal_contour_mean_hist(tracer, contours, dA, integrand, grdm, area=None, *,
                          lt: bool = False):
    """:func:`cal_contour_mean` with histogram integrals."""
    upper = cal_contour_weigh_mean_hist(tracer, contours, dA, integrand * grdm,
                                        area, lt=lt)
    lower = cal_contour_weigh_mean_hist(tracer, contours, dA, grdm, area,
                                        lt=lt)
    return grad_safe_div(upper, lower)


def cal_sqared_equivalent_length(dgrdSdA, dqdA):
    """Leq^2 = (d int|grad q|^2 dA / dA) / (dq/dA)^2, with the grad-safe
    VJP.  (The name keeps the reference API's typo.)"""
    return grad_safe_div_sq(dgrdSdA, dqdA)


def cal_normalized_Keff(Leq2, Lmin, mask: float = 1e5):
    """nkeff = Leq^2 / Lmin / Lmin, NaN at and above ``mask``.  Two
    sequential divisions, not /(Lmin*Lmin): that is how the reference and
    the float64 oracle round, and the fused form can flip the threshold.
    Both take the grad-safe VJP."""
    nkeff = grad_safe_div(grad_safe_div(Leq2, Lmin), Lmin)
    return torch.where(nkeff < mask, nkeff,
                       torch.full_like(nkeff, float("nan")))


def get_extrema_extend(data, N: int):
    """(min - step, max + step) with step = (max - min) / N over every
    element, skipping NaN (NaN if all are NaN): the reference's
    endpoint-extension helper."""
    nan = torch.isnan(data)
    some = ~nan.all()
    lo = torch.where(nan, float("inf"), data).amin()
    hi = torch.where(nan, float("-inf"), data).amax()
    vmin, vmax = lo.where(some, float("nan")), hi.where(some, float("nan"))
    step = (vmax - vmin) / N
    return vmin - step, vmax + step


def interp_to_coords(predef, eq_coords, var, increasing=None, axis: int = -1):
    """Remap a contour-indexed variable onto prescribed coordinate values.
    The direction of ``eq_coords`` is taken from its first batch element,
    like the reference, unless ``increasing`` is given.

    ``axis`` is the interpolation axis in both ``eq_coords`` and ``var``
    (the reference's ``interpDim``): a negative axis counts from the end of
    each array, a non-negative one needs equal ranks."""
    if axis != -1:
        if axis >= 0 and eq_coords.dim() != var.dim():
            raise ValueError(
                "interp_to_coords: a non-negative axis is ambiguous when "
                f"eq_coords (ndim {eq_coords.dim()}) and var (ndim "
                f"{var.dim()}) differ in rank; use a negative axis")
        eq_coords = torch.movedim(eq_coords, axis, -1)
        var = torch.movedim(var, axis, -1)
    if increasing is None:
        flat = eq_coords.reshape(-1, eq_coords.shape[-1])
        increasing = flat[0, 0] < flat[0, -1]
    out = interp1d(predef, eq_coords, var, increasing=increasing)
    return out if axis == -1 else torch.movedim(out, -1, axis)


_INTEGRALS = {"exact": cal_integral_within_contours_exact,
              "broadcast": cal_integral_within_contours,
              "hist": cal_integral_within_contours_hist}


def cal_contours_at(predef, table: Table, tracer, dA, *, increase: bool,
                    lt: bool, method: str = "exact"):
    """Contour levels lying at prescribed equivalent coordinates ``predef``:
    N = len(predef) rough levels -> their enclosed areas -> Y_eq through
    ``table`` -> the levels interpolated onto ``predef``.

    method: 'exact' (sort-based, the default), 'broadcast' or 'hist'.  The
    'hist' path keeps the reference's assumption that the bins span the
    tracer's extrema: for interior prescribed coordinates it under-counts
    the area (everything below the prepended edge is left out), as the
    reference's ``cal_contours_at_hist`` does.  The exact path has no such
    window and round-trips cleanly."""
    if method not in _INTEGRALS:
        raise ValueError(f"method={method!r} not in {list(_INTEGRALS)}")
    ctr = cal_contours(tracer, predef.shape[-1], increase=increase)
    area = _INTEGRALS[method](tracer, ctr, dA, lt=lt)
    return interp_to_coords(predef, table.lookup_coordinates(area), ctr)


class Contour2D:
    """The reference's ``Contour2D`` (reference core.py:20-70 and the
    grid-first form its tests call, tests/test_Keff_atmos.py:37-41): one
    tracer on one grid, and every analysis as a method.

    ``grid`` carries the metrics; ``trcr`` is (..., Ny, Nx) with the
    equivalent dimension at axis -2.  ``dims``/``dimEq`` are accepted for
    the reference's signature and validated against ``grid.dim_names``.

    Inputs given as numpy arrays or lists go to the grid's device in
    ``dtype``; a tensor must already be on the grid's device (a
    ``ValueError`` names both devices: nothing is copied silently).  The
    LWA methods take the port's ``method='auto'``: from
    ``diagnostics.lwa._FAST_NY_CROSSOVER`` rows on that is 'fast' (the JAX
    package's 'auto' takes 'lin' there).
    """

    def __init__(self, grid: Grid, trcr, dims: Optional[dict] = None,
                 dimEq: Optional[dict] = None, arakawa: str = "A",
                 increase: bool = True, lt: bool = False,
                 check_mono: bool = False, dtype=torch.float32):
        if dimEq is not None and len(dimEq) != 1:
            raise ValueError('dimEq should be one dimension e.g., {"Y": "lat"}')
        if dims is not None:
            if len(dims) != 2:
                raise ValueError("dims should be a 2D plane")
            names = set(dims.values())
            if not names.issuperset(set(grid.dim_names)) and \
                    not set(grid.dim_names).issuperset(names):
                raise ValueError(
                    f"dims {dims} do not match grid dims {grid.dim_names}")
        if arakawa not in ("A", "C"):
            # the reference stores this flag without using it in the math
            # (core.py:60); other grid letters fail loudly here
            raise ValueError(f"unsupported arakawa grid {arakawa!r}; "
                             "expected 'A' or 'C'")
        self.grid = grid
        self.dtype = dtype
        self.device = grid.dA.device
        self.tracer = self._on_grid(trcr, "tracer").to(dtype)
        self.dA = grid.dA.to(dtype)
        self.increase = bool(increase)
        self.lt = bool(lt)
        self.check_mono = bool(check_mono)
        self.arakawa = arakawa

    def _on_grid(self, a, name: str = "input") -> torch.Tensor:
        """``a`` as a tensor on the grid's device: numpy arrays and lists
        are copied there in the facade's dtype; a tensor elsewhere raises."""
        if isinstance(a, torch.Tensor):
            if a.device != self.device:
                raise ValueError(f"{name} is on {a.device} but the grid is on "
                                 f"{self.device}; move it with .to()")
            return a
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    @classmethod
    def from_arrays(cls, trcr, dA, ydef, xdef=None, *, latlon: bool = False,
                    periodic_x: bool = False, increase: bool = True,
                    lt: bool = False, check_mono: bool = False,
                    dtype=torch.float32, device=None) -> "Contour2D":
        """The vendored-generation constructor (reference core.py:20-21): a
        tracer and an explicit cell-area array, no grid object.  ``ydef``
        is the equivalent coordinate the xarray version read off the
        tracer's coords; ``xdef`` defaults to an index coordinate.  The
        grid is built by :func:`..grid.from_metrics` on ``device``, the
        card unless told otherwise."""
        dA = to_numpy(dA)
        if xdef is None:
            xdef = np.arange(dA.shape[-1])
        grid = from_metrics(to_numpy(ydef), to_numpy(xdef), dA, latlon=latlon,
                            periodic_x=periodic_x, dtype=dtype, device=device)
        return cls(grid, trcr, increase=increase, lt=lt,
                   check_mono=check_mono, dtype=dtype)

    # -- contour levels ---------------------------------------------------
    def cal_contours(self, levels: Union[int, Sequence, torch.Tensor] = 10):
        """``levels`` equally spaced levels per batch element, or the given
        levels as a tensor."""
        if isinstance(levels, int):
            return cal_contours(self.tracer, levels, increase=self.increase)
        return self._on_grid(levels, "levels").to(self.dtype)

    # -- tables -----------------------------------------------------------
    def _ydef(self) -> torch.Tensor:
        return self.grid.ydef.to(self.dtype)

    def cal_area_eqCoord_table(self, mask) -> Table:
        tbl = cal_area_eqCoord_table(self._on_grid(mask, "mask").to(self.dtype),
                                     self._ydef(), self.dA,
                                     increase=self.increase, lt=self.lt)
        self._maybe_check_mono(tbl.values)
        return tbl

    def cal_area_eqCoord_table_hist(self, mask) -> Table:
        tbl = cal_area_eqCoord_table_hist(
            self._on_grid(mask, "mask").to(self.dtype), self._ydef(), self.dA,
            increase=self.increase, lt=self.lt)
        self._maybe_check_mono(tbl.values)
        return tbl

    # -- conditional integrals -------------------------------------------
    def _integral(self, fn, contour, tracer, integrand):
        out = fn(self.tracer if tracer is None else tracer, contour, self.dA,
                 integrand, lt=self.lt)
        self._maybe_check_mono(out)
        return out

    def cal_integral_within_contours(self, contour, tracer=None,
                                     integrand=None):
        return self._integral(cal_integral_within_contours, contour, tracer,
                              integrand)

    def cal_integral_within_contours_hist(self, contour, tracer=None,
                                          integrand=None):
        return self._integral(cal_integral_within_contours_hist, contour,
                              tracer, integrand)

    def cal_integral_within_contours_exact(self, contour, tracer=None,
                                           integrand=None):
        """Sort-based exact conditional integrals (beyond the reference)."""
        return self._integral(cal_integral_within_contours_exact, contour,
                              tracer, integrand)

    # -- calculus ---------------------------------------------------------
    def cal_gradient_wrt_area(self, var, area):
        return cal_gradient_wrt_area(var, area)

    def cal_contour_weigh_mean(self, contour, integrand, area=None):
        return cal_contour_weigh_mean(self.tracer, contour, self.dA, integrand,
                                      area, lt=self.lt)

    def cal_contour_weigh_mean_hist(self, contour, integrand, area=None):
        return cal_contour_weigh_mean_hist(self.tracer, contour, self.dA,
                                           integrand, area, lt=self.lt)

    def cal_contour_mean(self, contour, integrand, grdm, area=None):
        return cal_contour_mean(self.tracer, contour, self.dA, integrand, grdm,
                                area, lt=self.lt)

    def cal_contour_mean_hist(self, contour, integrand, grdm, area=None):
        return cal_contour_mean_hist(self.tracer, contour, self.dA, integrand,
                                     grdm, area, lt=self.lt)

    def cal_sqared_equivalent_length(self, dgrdSdA, dqdA):
        return cal_sqared_equivalent_length(dgrdSdA, dqdA)

    def cal_normalized_Keff(self, Leq2, Lmin, mask: float = 1e5):
        return cal_normalized_Keff(Leq2, Lmin, mask)

    # -- LWA family -------------------------------------------------------
    def _lwa(self, q, Q, mask_idx, part: str, variant2: bool):
        q, Q = self._on_grid(q, "q"), self._on_grid(Q, "Q")
        fn = _lwa.local_wave_activity2 if variant2 else \
            _lwa.local_wave_activity
        out = fn(q, Q, self.dA, self._ydef(), increase=self.increase,
                 part=part)
        if mask_idx is None:
            return out
        contours, masks = _lwa.lwa_masks_at(q, Q, self.dA, self._ydef(),
                                            mask_idx, increase=self.increase,
                                            variant2=variant2)
        return (out, [contours[..., i] for i in range(contours.shape[-1])],
                list(masks.unbind(0)))

    def cal_local_wave_activity(self, q, Q, mask_idx=None, part: str = "all"):
        """LWA (reference core.py:696-799); with ``mask_idx``, also the
        contour values and the 3-valued masks at those surfaces, as lists:
        ``(lwa, contours, masks)``."""
        return self._lwa(q, Q, mask_idx, part, False)

    def cal_local_wave_activity2(self, q, Q, mask_idx=None, part: str = "all"):
        """LWA2 (reference core.py:802-905), returned as
        :meth:`cal_local_wave_activity` returns LWA."""
        return self._lwa(q, Q, mask_idx, part, True)

    def cal_local_APE(self, q, Q, mask_idx=None, part: str = "all"):
        """Local APE == LWA (reference core.py:908-942)."""
        return self.cal_local_wave_activity(q, Q, mask_idx, part)

    # -- geometry ---------------------------------------------------------
    def cal_contour_lengths(self, contours, tracer=None, latlon: bool = False):
        if isinstance(contours, (int, list)):
            contours = self.cal_contours(contours)
        data = self.tracer if tracer is None else tracer
        return _length.contour_lengths(data, contours, self._ydef(),
                                       self.grid.xdef.to(self.dtype),
                                       latlon=latlon)

    def cal_contour_crossing(self, ctr, stride=1, mode: str = "edge",
                             quirks: bool = False):
        return _length.contour_crossing(self.tracer,
                                        self._on_grid(ctr, "ctr"), self.dA,
                                        stride, mode=mode, quirks=quirks)

    # -- interpolation ----------------------------------------------------
    def _contours_at(self, predef, table: Table, method: str):
        return cal_contours_at(self._on_grid(predef, "predef").to(self.dtype),
                               table, self.tracer, self.dA,
                               increase=self.increase, lt=self.lt,
                               method=method)

    def cal_contours_at(self, predef, table: Table):
        """Contour levels at the prescribed coordinates ``predef`` by the
        reference's broadcast integral (reference core.py:269-360)."""
        return self._contours_at(predef, table, "broadcast")

    def cal_contours_at_hist(self, predef, table: Table):
        return self._contours_at(predef, table, "hist")

    def cal_contours_at_exact(self, predef, table: Table):
        """Windowing-free variant (beyond the reference): round-trips
        cleanly for interior prescribed coordinates."""
        return self._contours_at(predef, table, "exact")

    def interp_to_coords(self, predef, eq_coords, var, axis: int = -1):
        """``axis`` mirrors the reference's ``interpDim=`` (core.py:1050)."""
        return interp_to_coords(self._on_grid(predef, "predef").to(self.dtype),
                                eq_coords, var, axis=axis)

    def interp_to_dataset(self, predef, eq_coords, vs: dict,
                          batch_dims: tuple = (), batch_coords: dict = None):
        """The reference's Dataset merge (core.py:1017-1047): every variable
        interpolated onto the ``predef`` equivalent coordinates, returned as
        a labelled :class:`..utils.ncio.Dataset` (``.to_nc3``/``.to_nc4``
        write it out).  The new coordinate takes the grid's equivalent dim
        name; ``batch_dims`` names the leading axes (unnamed ones become
        ``dim{i}_{size}``), ``batch_coords`` attaches 1-D coordinates for
        them.  Each output is copied to the host once."""
        pre = self._on_grid(predef, "predef").to(self.dtype)
        pdim = self.grid.dim_names[0]
        batch_dims = tuple(batch_dims)
        ds = Dataset()
        ds.coords[pdim] = to_numpy(predef)
        for cname, cvals in (batch_coords or {}).items():
            ds.coords[cname] = to_numpy(cvals)
        for name, var in vs.items():
            a = to_numpy(interp_to_coords(pre, eq_coords, var))
            lead = tuple(batch_dims[i] if i < len(batch_dims)
                         else f"dim{i}_{s}"
                         for i, s in enumerate(a.shape[:-1]))
            ds.variables[name] = a
            ds.dims[name] = lead + (pdim,)
        return ds

    # -- checks -----------------------------------------------------------
    def _maybe_check_mono(self, var):
        """Opt-in monotonicity guard (reference core.py:144-145, 1328-1355)
        through :func:`..utils.checks.check_monotonic`: one boolean read
        back from the device, raising ``ValueError`` (or recorded inside
        ``utils.checks.checked``).  ``utils.checks.assert_monotonic_host``
        gives the offending index."""
        if self.check_mono:
            check_monotonic(var, axis=-1, name="contour-axis values")
