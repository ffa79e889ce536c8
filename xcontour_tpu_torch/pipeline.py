"""The Keff, LWA and contour-geometry pipelines.

Counterparts of ``keff_pipeline``, ``lwa_pipeline``, ``keff_lwa_pipeline``,
``clength_pipeline`` and ``fractal_pipeline`` in
``xcontour_tpu/pipeline.py``: the effective-diffusivity chain, the
sorted-state + local wave activity chain, the combined step that runs both
from one shared sorted state, the contour-length chain and the
fractal-dimension chain, over a batch of (..., Ny, Nx) snapshots; and
:func:`local_length_pipeline`, the windowed local contour lengths of
``diagnostics/local_length.py`` in the same signature.  The JAX versions'
static flags are plain Python arguments.  :func:`flatten_output` and
:func:`as_dataset` label a step's outputs as a netCDF-ready
:class:`.utils.ncio.Dataset`.

A step replays as one CUDA graph (:class:`Graphs`) where its input allows:
a contiguous CUDA tracer, no gradient needed, the whole plane (no mesh
layout), no capture already running, and the table given by the caller
(:func:`local_length_pipeline` takes none).  The first call with a key
runs eagerly and warms the caches a capture cannot fill (the library, the
plans, ``Table._inc_values``); the second captures the eager body and
replays it; later calls copy the tracer into the graph's input and replay.
Every other call runs the eager body, as on the CPU.

While tracing is on (:func:`.utils.prof.tracing`), a call on the card
is timed by stage (:class:`.utils.prof.Body`): its key is another, so its
graph is captured with the stages' timing events as nodes, and the
untraced calls replay a graph without them.  Each timed replay or eager
call leaves one record of :func:`.utils.prof.stage_times`, read at the
entry's next timed call, before its span opens.

The Keff, LWA and contour-length steps reach the grid's x axis through a
layout, at eight operations (the stencil, the levels, the histogram
table, the CDF, the contour-length chain's weights and CDF, the broadcast
integral, LWA and LWA2, K7's lengths) and the x block of ``dA`` the CDF
weights use.  :data:`_PLANE`, the default, holds the whole plane and
makes the unsharded calls; the sharded steps of :mod:`.parallel.pipeline`
are these steps given a mesh's layout through the private keyword
``_layout``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
import warnings
import weakref
from typing import Optional

import numpy as np
import torch

from . import core
from . import kernels
from .diagnostics import lwa as _lwa
from .diagnostics.fractal import fractal_dimension
from .diagnostics.length import box_counting_lengths, contour_lengths
from .diagnostics.local_length import local_lengths_and_means
from .grid import Grid, latitude_lengths_at, to_numpy
from .ops.histogram import weighted_cdf_multi, weighted_cdf_stacked
from .ops.interp import interp1d
from .ops.stencil import clength_weights, squared_gradient
from .utils import prof
from .utils.coarsen import coarsen
from .utils.constants import Rearth as _REARTH
from .utils.ncio import Dataset
from .utils.prof import span

_LMIN = ("analytic", "dxF", "frac")


def _check_modes(lmin: Optional[str] = None, metric: Optional[str] = None):
    if lmin is not None and lmin not in _LMIN:
        raise ValueError(f"unknown lmin mode {lmin!r}")
    if metric is not None and metric not in ("dA", "dy"):
        raise ValueError(f"unknown LWA metric {metric!r}")


def _lmin(lmin: str, Yeq, grid: Grid, mask, ydef):
    """The minimum contour length at each equivalent coordinate:
    'analytic' 2*pi*R*cos(Yeq); 'dxF' the masked zonal sum of dxF
    interpolated to Yeq; 'frac' latitude_lengths_at(lat) times the zonal
    fluid fraction."""
    if lmin == "analytic":
        return latitude_lengths_at(Yeq)
    if lmin == "dxF":
        pre_lmin = torch.sum(mask * grid.dxF.to(ydef.dtype), dim=-1)
    else:
        frac = torch.sum(mask, dim=-1) / mask.shape[-1]
        pre_lmin = frac * latitude_lengths_at(ydef)
    return interp1d(Yeq, ydef, pre_lmin, increasing=ydef[-1] > ydef[0])


def _keff(ctr, intArea, intgrdS, Lmin, nkeff_mask: float) -> dict:
    """d/dA of the |grad q|^2 integral and of the contours, Leq^2, nkeff."""
    dgrdSdA = core.cal_gradient_wrt_area(intgrdS, intArea)
    dqdA = core.cal_gradient_wrt_area(ctr, intArea)
    Leq2 = core.cal_sqared_equivalent_length(dgrdSdA, dqdA)
    nkeff = core.cal_normalized_Keff(Leq2, Lmin, nkeff_mask)
    return dict(dgrdSdA=dgrdSdA, dqdA=dqdA, Leq2=Leq2, nkeff=nkeff)


def _lwa_weight(metric: str, grid: Grid, dA):
    """The LWA weight: None for 'dA' (the default wei*dA), wei*dyF for
    'dy'."""
    if metric == "dA":
        return None
    return dA / _lwa.nanmax(dA) * grid.dyF.to(dA.dtype)


class _Plane:
    """The layout of a snapshot held whole: each operation that reaches
    the x axis is the unsharded call, and the x block of ``dA`` is
    ``dA``.  A mesh's layout (:mod:`.parallel.pipeline`) answers the same
    names on the rank's block."""

    __slots__ = ()

    @staticmethod
    def block(dA, nx: int):
        return dA

    @staticmethod
    def clength_cdf(tracer, grid: Grid, ctr, dA_x, lt: bool):
        """The contour-length chain's five integrals: G writes the weights
        as K2 reads them, one K2 launch digitizes them."""
        with span("stage.gradient"):
            w = clength_weights(tracer, grid, dA_x)
        with span("stage.cdf"):
            return weighted_cdf_stacked(tracer, ctr, w, lt)

    squared_gradient = staticmethod(squared_gradient)
    contours = staticmethod(core.cal_contours)
    hist_table = staticmethod(core.cal_area_eqCoord_table_hist)
    cdf = staticmethod(weighted_cdf_multi)
    integral = staticmethod(core.cal_integral_within_contours)
    lwa = staticmethod(_lwa.local_wave_activity)
    lwa2 = staticmethod(_lwa.local_wave_activity2)
    lengths = staticmethod(contour_lengths)


_PLANE = _Plane()


class _Graph:
    """One captured step: the CUDA graph, its input buffer, its outputs (in
    the graph's memory pool), the launches of each kernel record that its
    capture made, and the timing events it records (a timed capture's
    :class:`.utils.prof.Stages`, else None)."""

    __slots__ = ("graph", "static", "out", "launches", "stages")

    def __init__(self, graph, static, out, launches, stages):
        self.graph, self.static, self.out = graph, static, out
        self.launches, self.stages = launches, stages


# a key's state before it has a graph: its first call ran (the warm-up),
# or its capture failed and its calls stay eager
_WARM, _REFUSED = "warm", "refused"


def _needs_grad(args) -> bool:
    """Whether grad mode is on and a tensor among ``args``, or of a grid
    or table among them, requires grad."""
    if not torch.is_grad_enabled():
        return False
    for v in args:
        if isinstance(v, (Grid, core.Table)):
            if any(getattr(t, "requires_grad", False)
                   for t in vars(v).values()):
                return True
        elif getattr(v, "requires_grad", False):
            return True
    return False


# argument types a key takes as they are (a tensor's isinstance is slow)
_PLAIN = (int, float, str, bool, type(None))


def _part(v, held: list):
    """An argument's part of a graph key: a tensor, grid or table by
    identity (appended to ``held``), a list or tuple by its parts, any
    other value as it is."""
    if type(v) in _PLAIN:
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_part(x, held) for x in v)
    if isinstance(v, (torch.Tensor, Grid, core.Table)):
        held.append(v)
        return type(v).__name__, id(v)
    return v


def graph_key(fn, tracer: torch.Tensor, grid: Grid, args: tuple,
              kwargs: dict, stream: Optional[int] = None,
              timed: bool = False):
    """(key, held) of a call of the entry body ``fn``: the entry, the
    tracer's shape, dtype and device, the stream, the grid, tables and
    other tensors by identity (``held``, the objects to hold by weak
    reference), every other argument by value, and whether the body is
    timed by stage.  Raises TypeError for an argument that cannot be
    hashed."""
    held = []
    key = (fn, tuple(tracer.shape), tracer.dtype, tracer.device, stream,
           _part(grid, held), _part(args, held),
           tuple(sorted((k, _part(v, held)) for k, v in kwargs.items())),
           timed)
    hash(key)
    return key, held


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _fresh(out, copies: Optional[dict] = None):
    """A copy of an output dict whose tensors own their memory (a graph's
    outputs are overwritten by its next replay), by device copies alone,
    no kernel: a contiguous tensor cloned, any other the same view of a
    copy of its storage, each storage copied once (the CDF's channels
    share one, as the eager body returns them)."""
    copies = {} if copies is None else copies
    if isinstance(out, dict):
        return {k: _fresh(v, copies) for k, v in out.items()}
    if not isinstance(out, torch.Tensor):
        return out
    if out.is_contiguous():
        return out.clone()
    src = out.untyped_storage()
    whole = copies.get(src.data_ptr())
    if whole is None:
        whole = copies[src.data_ptr()] = out.new_empty(0).set_(src).clone()
    return whole.as_strided(out.shape, out.stride(), out.storage_offset())


class Graphs:
    """The pipeline entries' CUDA graphs, at most :attr:`SIZE`, the least
    recently used dropped first, and three counters of calls, read as
    ``Kernel.launches`` is: ``captures``; ``replays`` (a capturing call's
    replay among them); ``eager``, the calls that ran the eager body (not
    eligible, a key's first call, a failed capture).  A key's grid, table
    and tensor arguments are held by weak reference: freeing one drops its
    graph.

    A capture runs the eager body on ``torch.cuda.graph``'s side stream in
    ``capture_error_mode='thread_local'`` (other threads' copies neither
    break it nor are broken by it); the launches its wrappers count go to
    the graph (:func:`.kernels.capturing`), and each replay adds them to
    the kernels' ``launches``, since a replay launches those kernels.

    A timed call (tracing on, the tracer on the card, a
    :class:`.utils.prof.Body` given) has a key of its own: its graph holds
    the stages' timing events, and the call says in its body whether it
    replayed or ran eagerly, and which events timed its stages."""

    SIZE = 4

    def __init__(self):
        self.captures = self.replays = self.eager = 0
        self._entries = collections.OrderedDict()  # key -> (state, weakrefs)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def _drop(self, key) -> None:
        self._entries.pop(key, None)

    def hold(self, key, state, held) -> None:
        """Keep ``state`` under ``key`` until an object of ``held`` is
        freed or the key is the least recently used past :attr:`SIZE`."""
        refs = [weakref.ref(o, lambda _, key=key: self._drop(key))
                for o in held]
        self._entries[key] = (state, refs)
        self._entries.move_to_end(key)
        while len(self._entries) > self.SIZE:
            self._entries.popitem(last=False)

    def _key(self, fn, takes_table: bool, tracer, grid, args, kwargs,
             timed: bool):
        """The call's (key, held) where a graph may run it, else None."""
        if not (isinstance(tracer, torch.Tensor) and _on_card(tracer)
                and tracer.is_contiguous()):
            return None
        if kwargs.get("_layout", _PLANE) is not _PLANE or \
                (takes_table and kwargs.get("table") is None):
            return None
        if _needs_grad((tracer, grid, *args, *kwargs.values())):
            return None
        if torch.cuda.is_current_stream_capturing():
            return None
        stream = torch.cuda.current_stream(tracer.device).cuda_stream
        try:
            return graph_key(fn, tracer, grid, args, kwargs, stream, timed)
        except TypeError:
            return None

    def call(self, fn, takes_table: bool, tracer, grid, args, kwargs,
             body: Optional[prof.Body] = None):
        """``fn(tracer, grid, *args, **kwargs)``, by a graph's replay where
        the call is eligible and its key's graph exists or can be captured
        now, else eagerly; ``body``: the call's timing by stage."""
        found = self._key(fn, takes_table, tracer, grid, args, kwargs,
                          body is not None)
        if found is not None:
            key, held = found
            with self._lock:
                state = self._entries.get(key, (None,))[0]
                if isinstance(state, _Graph):
                    self._entries.move_to_end(key)
                    return self._replay(state, tracer, body)
                if state == _WARM:
                    state = self._capture(fn, tracer, grid, args, kwargs,
                                          body is not None)
                    self.hold(key, state or _REFUSED, held)
                    if state is not None:
                        return self._replay(state, None, body)
                elif state is None:
                    self.hold(key, _WARM, held)
        self.eager += 1
        if body is None:
            return fn(tracer, grid, *args, **kwargs)
        with prof.Stages(tracer.device, capturing=False) as stages:
            out = fn(tracer, grid, *args, **kwargs)
        body.took("eager", self.eager, stages)
        return out

    def _capture(self, fn, tracer, grid, args, kwargs, timed: bool):
        """A graph of ``fn`` on a copy of ``tracer`` (``timed``: with its
        stages' timing events); None, with a warning, where the capture
        fails."""
        with span("graph.capture"):
            static = tracer.clone()
            graph = torch.cuda.CUDAGraph()
            try:
                with kernels.capturing() as tally, torch.cuda.graph(
                        graph, capture_error_mode="thread_local"):
                    # made inside the capture: its events go on the
                    # capturing stream
                    stages = prof.Stages(static.device, capturing=True) \
                        if timed else None
                    with stages or contextlib.nullcontext():
                        out = fn(static, grid, *args, **kwargs)
            except RuntimeError as err:
                warnings.warn(f"{fn.__name__}: no CUDA graph ({err}); its "
                              "calls run eagerly", RuntimeWarning)
                return None
            self.captures += 1
            return _Graph(graph, static, out, tally, stages)

    def _replay(self, g: _Graph, tracer, body) -> dict:
        """Copy ``tracer`` into the graph's input (the capturing call's is
        there already), replay, and return fresh copies of the outputs."""
        with span("graph.replay"):
            if tracer is not None:
                g.static.copy_(tracer)
            g.graph.replay()
            for record, n in g.launches.items():
                record.launches += n
            self.replays += 1
            if body is not None:
                body.took("replay", self.replays, g.stages)
            return _fresh(g.out)


GRAPHS = Graphs()


def _entry(fn):
    """A pipeline entry: each call inside the span ``pipeline.<name>``,
    through :data:`GRAPHS`; timed by stage while tracing is on and the
    tracer is on the card, its previous timed call's records read first."""
    name = f"pipeline.{fn.__name__}"
    takes_table = "table" in inspect.signature(fn).parameters

    @functools.wraps(fn)
    def call(tracer, grid, *args, **kwargs):
        if not (prof.tracing() and isinstance(tracer, torch.Tensor)
                and _on_card(tracer)):
            with span(name):
                return GRAPHS.call(fn, takes_table, tracer, grid, args,
                                   kwargs)
        prof.settle(name)
        with span(name), prof.Body(name, tracer.device) as body:
            return GRAPHS.call(fn, takes_table, tracer, grid, args, kwargs,
                               body)
    return call


@_entry
def keff_pipeline(tracer: torch.Tensor, grid: Grid,
                  grdS: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  pre_y: Optional[torch.Tensor] = None, *, N: int = 251,
                  increase: bool = True, lt: bool = True, hist: bool = True,
                  lmin: str = "dxF", nkeff_mask: float = 2e7,
                  table: Optional[core.Table] = None,
                  _layout=_PLANE) -> dict:
    """The effective-diffusivity chain on (..., Ny, Nx) snapshots: contours
    -> conditional area and |grad q|^2 integrals -> A(Y_eq) lookup -> d/dA
    -> Leq^2 -> nkeff, plus interpolation onto ``pre_y``.

    hist : the histogram integrals and table (K2) if True, else the
        broadcast ones (:func:`core.cal_integral_within_contours`,
        :func:`core.cal_area_eqCoord_table`).
    lmin : 'dxF', 'analytic' or 'frac' (see ``keff_lwa_pipeline``).

    Returns ``{'origin': {...}}`` with contour, intArea, Yeq, intgrdS,
    dgrdSdA, dqdA, Leq2, Lmin, nkeff and table (the table's values), and
    with ``pre_y`` an ``'interp'`` section holding every origin key but
    table interpolated onto it.
    """
    _check_modes(lmin=lmin)
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    dA_x = _layout.block(dA, tracer.shape[-1])
    if mask is None:
        mask = grid.fluid_mask(dtype)
    if grdS is None:
        with span("stage.gradient"):
            grdS = _layout.squared_gradient(tracer, grid)

    with span("stage.contours"):
        ctr = _layout.contours(tracer, N, increase=increase)
    if table is None:
        with span("stage.table"):
            build = _layout.hist_table if hist else \
                core.cal_area_eqCoord_table
            table = build(mask, ydef, dA, increase=increase, lt=lt)
    with span("stage.cdf"):
        if hist:
            intArea, intgrdS = _layout.cdf(tracer, ctr,
                                           [dA_x, grdS * dA_x], lt)
        else:
            intArea = _layout.integral(tracer, ctr, dA_x, None, lt=lt)
            intgrdS = _layout.integral(tracer, ctr, dA_x, grdS, lt=lt)
    with span("stage.lookup"):
        Yeq = table.lookup_coordinates(intArea)
    with span("stage.lmin"):
        Lmin = _lmin(lmin, Yeq, grid, mask, ydef)
    with span("stage.keff"):
        k = _keff(ctr, intArea, intgrdS, Lmin, nkeff_mask)
    origin = dict(contour=ctr, intArea=intArea, Yeq=Yeq, intgrdS=intgrdS,
                  dgrdSdA=k["dgrdSdA"], dqdA=k["dqdA"], Leq2=k["Leq2"],
                  Lmin=Lmin, nkeff=k["nkeff"], table=table.values)
    out = dict(origin=origin)
    if pre_y is not None:
        with span("stage.interp"):
            pre_y = pre_y.to(dtype)
            out["interp"] = {key: core.interp_to_coords(pre_y, Yeq, v)
                             for key, v in origin.items() if key != "table"}
    return out


@_entry
def lwa_pipeline(tracer: torch.Tensor, grid: Grid,
                 mask: Optional[torch.Tensor] = None, *, N: int = 121,
                 increase: bool = True, lt: bool = True, part: str = "all",
                 metric: str = "dA", lwa_method: str = "auto",
                 table: Optional[core.Table] = None,
                 _layout=_PLANE) -> dict:
    """The sorted-state + local wave activity chain: contours -> areas ->
    latEq -> the sorted profile Q on the grid's coordinates -> LWA and the
    impulse-Casimir LWA2.

    metric : 'dA' (wei*dA) or 'dy' (wei*dyF).
    lwa_method : 'auto', 'lin', 'dense' or 'fast' (see
        :func:`diagnostics.lwa.local_wave_activity`).
    table : a precomputed A(Y_eq) table, reusable across snapshots.
    part : 'all', 'upper', 'lower' or 'split': both halves from one sorted
        state and one pairwise pass each for LWA and LWA2.

    Returns a dict with contour, intArea, latEq, Q, lwa and lwa2; for
    part='split' lwa_upper, lwa_lower, lwa2_upper and lwa2_lower in place
    of lwa and lwa2.
    """
    _check_modes(metric=metric)
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    dA_x = _layout.block(dA, tracer.shape[-1])
    weight = _lwa_weight(metric, grid, dA)
    if mask is None:
        mask = grid.fluid_mask(dtype)

    if table is None:
        with span("stage.table"):
            table = _layout.hist_table(mask, ydef, dA, increase=increase,
                                       lt=lt)
    with span("stage.contours"):
        ctr = _layout.contours(tracer, N, increase=increase)
    with span("stage.cdf"):
        intArea, = _layout.cdf(tracer, ctr, [dA_x], lt)
    with span("stage.lookup"):
        latEq = table.lookup_coordinates(intArea)
    with span("stage.interp"):
        Q = core.interp_to_coords(ydef, latEq, ctr)
    kw = dict(increase=increase, part=part, weight=weight, method=lwa_method)
    with span("stage.lwa"):
        lwa = _layout.lwa(tracer, Q, dA, ydef, **kw)
    with span("stage.lwa2"):
        lwa2 = _layout.lwa2(tracer, Q, dA, ydef, **kw)
    out = dict(contour=ctr, intArea=intArea, latEq=latEq, Q=Q)
    if part.lower() == "split":
        out.update(lwa_upper=lwa[0], lwa_lower=lwa[1], lwa2_upper=lwa2[0],
                   lwa2_lower=lwa2[1])
    else:
        out.update(lwa=lwa, lwa2=lwa2)
    return out


@_entry
def keff_lwa_pipeline(tracer: torch.Tensor, grid: Grid,
                      grdS: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      pre_y: Optional[torch.Tensor] = None, *, N: int = 121,
                      increase: bool = True, lt: bool = True,
                      lmin: str = "analytic", metric: str = "dA",
                      with_lwa2: bool = False, lwa_method: str = "auto",
                      table: Optional[core.Table] = None,
                      _layout=_PLANE) -> dict:
    """Keff chain + LWA on (..., Ny, Nx) snapshots.

    lmin : 'analytic' — 2*pi*R*cos(Yeq);
           'dxF'      — masked zonal sum of dxF interpolated to Yeq;
           'frac'     — latitude_lengths_at(lat) * zonal fluid fraction.
    metric : LWA weight, 'dA' (wei*dA) or 'dy' (wei*dyF).
    lwa_method : 'auto', 'lin', 'dense' or 'fast', as in ``lwa_pipeline``.
    with_lwa2 : also return the impulse-Casimir LWA2 (``lwa2``).
    table : a precomputed A(Y_eq) table.  It depends only on (mask, ydef,
        dA), so a loop over many snapshots builds it once with
        core.cal_area_eqCoord_table_hist and passes it in.
    pre_y : optional coordinates to interpolate Leq2, nkeff, Lmin onto
        (``*_at`` keys).

    Returns a dict with contour, intArea, intgrdS, Yeq, Lmin, Leq2, nkeff,
    Q and lwa (and lwa2).
    """
    _check_modes(lmin=lmin, metric=metric)
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    dA_x = _layout.block(dA, tracer.shape[-1])
    if mask is None:
        mask = grid.fluid_mask(dtype)
    if grdS is None:
        with span("stage.gradient"):
            grdS = _layout.squared_gradient(tracer, grid)

    if table is None:
        with span("stage.table"):
            table = _layout.hist_table(mask, ydef, dA, increase=increase,
                                       lt=lt)
    with span("stage.contours"):
        ctr = _layout.contours(tracer, N, increase=increase)
    # the area and |grad q|^2 integrals share one digitize pass
    with span("stage.cdf"):
        intArea, intgrdS = _layout.cdf(tracer, ctr, [dA_x, grdS * dA_x], lt)
    with span("stage.lookup"):
        Yeq = table.lookup_coordinates(intArea)
    with span("stage.lmin"):
        Lmin = _lmin(lmin, Yeq, grid, mask, ydef)
    with span("stage.keff"):
        k = _keff(ctr, intArea, intgrdS, Lmin, 2e7)

    with span("stage.interp"):
        Q = core.interp_to_coords(ydef, Yeq, ctr)
    kw = dict(increase=increase, part="all",
              weight=_lwa_weight(metric, grid, dA), method=lwa_method)
    with span("stage.lwa"):
        lwa = _layout.lwa(tracer, Q, dA, ydef, **kw)
    out = dict(contour=ctr, intArea=intArea, intgrdS=intgrdS, Yeq=Yeq,
               Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"], Q=Q, lwa=lwa)
    if with_lwa2:
        with span("stage.lwa2"):
            out["lwa2"] = _layout.lwa2(tracer, Q, dA, ydef, **kw)
    if pre_y is not None:
        with span("stage.interp"):
            pre_y = pre_y.to(dtype)
            for key in ("Leq2", "nkeff", "Lmin"):
                out[key + "_at"] = core.interp_to_coords(pre_y, Yeq,
                                                         out[key])
    return out


@_entry
def clength_pipeline(tracer: torch.Tensor, grid: Grid,
                     mask: Optional[torch.Tensor] = None, *, N: int = 121,
                     increase: bool = True, lt: bool = True,
                     table: Optional[core.Table] = None,
                     _layout=_PLANE) -> dict:
    """The contour-length chain: perimeter lengths L (K7), the equivalent
    length Leq (through Leq^2), the minimum length Lmin (zonal fluid
    fraction times 2*pi*R*cos(lat) at Yeq), and the Cauchy-Schwarz contour
    means of |grad q| (cmGrd) and 1/|grad q| (cmInvGrd).  Consumers check
    Leq >= L >= Lmin.

    The five conditional integrals (area, |grad q|^2, and the numerators
    and denominator of the two contour means) share one digitize pass (one
    K2 launch, with or without gradients: a channel that no differentiated
    output uses carries no cotangent).  On the whole plane one G launch
    writes their weights as K2 reads them; a mesh's layout forms them from
    the sharded gradient.

    Returns a dict with contour, intArea, Yeq, lengths, Lmin, Leq2, nkeff,
    cmGrd and cmInvGrd.
    """
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    dA_x = _layout.block(dA, tracer.shape[-1])
    if mask is None:
        mask = grid.fluid_mask(dtype)
    if table is None:
        with span("stage.table"):
            table = _layout.hist_table(mask, ydef, dA, increase=increase,
                                       lt=lt)
    with span("stage.contours"):
        ctr = _layout.contours(tracer, N, increase=increase)
    # the weights as cal_contour_mean_hist forms them, (f * grdm) * dA, and
    # their integrals (spans stage.gradient and stage.cdf)
    intArea, intgrdS, int_gg, int_g, int_ig = _layout.clength_cdf(
        tracer, grid, ctr, dA_x, lt)
    with span("stage.lookup"):
        Yeq = table.lookup_coordinates(intArea)

    with span("stage.lengths"):
        lengths = _layout.lengths(tracer, ctr, grid.ydef, grid.xdef,
                                  latlon=grid.latlon)
    with span("stage.lmin"):
        Lmin = _lmin("frac", Yeq, grid, mask, ydef)
    with span("stage.keff"):
        # the contour means divide as cal_contour_mean_hist does
        lower = core.cal_gradient_wrt_area(int_g, intArea)
        cmGrd = core.grad_safe_div(
            core.cal_gradient_wrt_area(int_gg, intArea), lower)
        cmInvGrd = core.grad_safe_div(
            core.cal_gradient_wrt_area(int_ig, intArea), lower)
        k = _keff(ctr, intArea, intgrdS, Lmin, 1e5)
    return dict(contour=ctr, intArea=intArea, Yeq=Yeq, lengths=lengths,
                Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"], cmGrd=cmGrd,
                cmInvGrd=cmInvGrd)


@_entry
def fractal_pipeline(tracer: torch.Tensor, grid: Grid, *, N: int = 121,
                     strides=(1, 2, 4, 8, 16, 32), increase: bool = True,
                     lt: bool = True, box_counting: bool = True,
                     table: Optional[core.Table] = None) -> dict:
    """The fractal-dimension chain: contour lengths (K7) on a ladder of
    grid coarsenings by ``strides`` (block means of the tracer and of the
    coordinates), optionally box-counting crossing lengths, and the
    log-log slope D per contour.  Rulers: stride * cos(Yeq) * dlon * R.

    Returns a dict with contour, Yeq, lengths (..., N, S), rulers and D,
    and with ``box_counting`` bclens and D_bc.
    """
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    xdef = grid.xdef.to(dtype)
    dA = grid.dA.to(dtype)
    mask = grid.fluid_mask(dtype)

    if table is None:
        with span("stage.table"):
            table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                     increase=increase, lt=lt)
    with span("stage.contours"):
        ctr = core.cal_contours(tracer, N, increase=increase)
    with span("stage.cdf"):
        intArea = core.cal_integral_within_contours_hist(tracer, ctr, dA,
                                                         lt=lt)
    with span("stage.lookup"):
        Yeq = table.lookup_coordinates(intArea)

    lengths = []
    for s in strides:
        with span("stage.coarsen"):
            ys = ydef if s == 1 else ydef.reshape(-1, s).mean(dim=1)
            xs = xdef if s == 1 else xdef.reshape(-1, s).mean(dim=1)
            qs = coarsen(tracer, s)
        with span("stage.lengths"):
            lengths.append(contour_lengths(qs, ctr, ys, xs,
                                           latlon=grid.latlon))
    L = torch.stack(lengths, dim=-1)                   # (..., N, S)

    with span("stage.dimension"):
        reso = grid.xdef[1] - grid.xdef[0]
        rulers = (kernels.device_constant(tuple(strides), dtype,
                                          tracer.device)
                  * torch.cos(torch.deg2rad(Yeq))[..., None]
                  * torch.deg2rad(reso).to(dtype) * _REARTH)
        out = dict(contour=ctr, Yeq=Yeq, lengths=L, rulers=rulers,
                   D=fractal_dimension(L, rulers))
    if box_counting:
        with span("stage.boxcount"):
            out["bclens"] = box_counting_lengths(tracer, ctr, dA, strides)
        with span("stage.dimension"):
            out["D_bc"] = fractal_dimension(out["bclens"], rulers)
    return out


@_entry
def local_length_pipeline(tracer: torch.Tensor, grid: Grid, *,
                          window: int = 101, stride: int = 10,
                          min_count: int = 1) -> dict:
    """Windowed local contour lengths (xcontour's local length): for each
    window of ``window`` x ``window`` points anchored every ``stride``
    points, the length of the contour inside it at its own mean.  One
    rolling mean (integral images) and one K8 launch for the whole batch
    of (Ny, Nx) or (..., Ny, Nx) snapshots; great-circle metres on a
    latitude-longitude grid.

    Returns a dict with llen (..., Wy, Wx; NaN for a window with fewer
    than ``min_count`` finite points or an empty contour), means (the
    window-mean levels, the same shape), and the window centres y_window
    (Wy,) and x_window (Wx,).
    """
    llen, means, cy, cx = local_lengths_and_means(
        tracer, grid.ydef, grid.xdef, window=window, stride=stride,
        latlon=grid.latlon, min_count=min_count)
    return dict(llen=llen, means=means, y_window=cy, x_window=cx)


# ---------------------------------------------------------------------------
# labeled outputs: the reference pipelines return coordinate-labeled
# Datasets (core.py:251-266, interp_to_dataset core.py:1017-1047); this
# converts the raw pipeline dicts into the same shape, on the host.
# ---------------------------------------------------------------------------
_ATTRS = {
    "levels": dict(long_name="contour level value"),
    "intArea": dict(long_name="area enclosed by contour", units="m2"),
    "intgrdS": dict(long_name="integral of |grad q|^2 within contour"),
    "Yeq": dict(long_name="equivalent coordinate of contour"),
    "Lmin": dict(long_name="minimum possible contour length", units="m"),
    "Leq2": dict(long_name="squared equivalent length", units="m2"),
    "nkeff": dict(long_name="normalized effective diffusivity Keff/Lmin^2"),
    "Q": dict(long_name="sorted tracer profile on the equivalent coordinate"),
    "lwa": dict(long_name="local finite-amplitude wave activity"),
    "lwa2": dict(long_name="local wave activity (impulse-Casimir form)"),
    "lwa_upper": dict(long_name="local wave activity, upper half (W+)"),
    "lwa_lower": dict(long_name="local wave activity, lower half (W-)"),
    "lwa2_upper": dict(long_name="impulse-Casimir local wave activity, "
                       "upper half (W+)"),
    "lwa2_lower": dict(long_name="impulse-Casimir local wave activity, "
                       "lower half (W-)"),
    "lengths": dict(long_name="contour perimeter length", units="m"),
    "cmGrd": dict(long_name="contour mean of |grad q|"),
    "cmInvGrd": dict(long_name="contour mean of 1/|grad q|"),
    "D": dict(long_name="fractal dimension (marching-squares lengths)"),
    "D_bc": dict(long_name="fractal dimension (box counting)"),
    "rulers": dict(long_name="box-counting ruler length", units="m"),
    "bclens": dict(long_name="box-counting crossing length", units="m"),
}


def flatten_output(out: dict) -> dict:
    """Flatten a pipeline output dict to plain name -> array.

    Nested sections use the labeled-output naming convention: ``origin``
    children keep their bare names, ``interp`` children get an ``_at``
    suffix (the reference's interp_to_dataset variables, core.py:1017-1047),
    any other section is prefixed.  Leaves without a shape and
    :class:`~.core.Table` objects are dropped.  This is the input
    :func:`as_dataset` labels."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                name = k2 if k == "origin" else f"{k2}_at" if k == "interp" \
                    else f"{k}_{k2}"
                flat[name] = v2
        else:
            flat[k] = v
    return {k: v for k, v in flat.items()
            if hasattr(v, "shape") and not hasattr(v, "lookup_coordinates")}


def as_dataset(out: dict, grid: Grid, pre_y=None,
               batch_dims: tuple = ("time",), extra_coords: dict = None,
               dim_hints: dict = None):
    """Label a pipeline output dict with coordinates, returning an
    :class:`xcontour_tpu_torch.utils.ncio.Dataset` ready for ``.to_nc3()``
    / ``.to_nc4()``.  Every tensor (the outputs, ``grid.ydef``,
    ``grid.xdef``, ``pre_y``) is copied to the host once.

    Dim inference (documented heuristic): trailing ``grid.shape`` axes are
    the plane (``grid.dim_names``); a trailing axis matching ``len(pre_y)``
    on interp-section / ``*_at`` variables is the predefined equivalent
    coordinate; a trailing axis matching the contour count is ``contour``
    (coordinate = level index, like the reference core.py:241-249); a
    trailing axis matching Ny is the equivalent dim (sorted profiles Q);
    leading axes are ``batch_dims``.  ``dim_hints`` overrides per variable.
    """
    ydim, xdim = grid.dim_names
    Ny, Nx = grid.shape
    hints = dict(Q=(ydim,))
    hints.update(dim_hints or {})

    # flatten the keff_pipeline origin/interp sections
    flat = flatten_output(out)

    N = int(flat["contour"].shape[-1]) if "contour" in flat else None
    # the 'contour' DIM is the level index (reference core.py:241-249); the
    # level values themselves are stored as 'levels' so the names don't clash
    if "contour" in flat:
        flat["levels"] = flat.pop("contour")
    if "contour_at" in flat:
        flat["levels_at"] = flat.pop("contour_at")
    pre = None if pre_y is None else to_numpy(pre_y)
    P = None if pre is None else int(pre.shape[0])
    ydef = to_numpy(grid.ydef)

    ds = Dataset()
    ds.coords[ydim] = ydef
    ds.coords[xdim] = to_numpy(grid.xdef)
    if N is not None:
        ds.coords["contour"] = np.arange(N, dtype=np.int32)
    pdim = None
    if P is not None:
        # the interp coordinate gets its own dim unless it IS the grid's
        # equivalent coordinate (never alias two different axes to one name)
        same = P == Ny and np.array_equal(pre, ydef)
        pdim = ydim if same else f"{ydim}_interp"
        ds.coords[pdim] = pre
    for cname, cvals in (extra_coords or {}).items():
        ds.coords[cname] = to_numpy(cvals)

    stride_vars = ("lengths", "bclens", "rulers")
    for name, arr in flat.items():
        a = to_numpy(arr)
        tail = list(hints.get(name, ()))
        if not tail:
            shape = a.shape
            if len(shape) >= 2 and shape[-2:] == (Ny, Nx):
                tail = [ydim, xdim]
            elif len(shape) >= 2 and N is not None and shape[-2] == N and \
                    name in stride_vars:
                # fractal-ladder outputs carry a trailing stride axis
                tail = ["contour", "stride"]
                if "stride" not in ds.coords:
                    ds.coords["stride"] = np.arange(shape[-1])
            elif shape and pdim is not None and shape[-1] == P and \
                    (name.endswith("_at") or P != N):
                tail = [pdim]
            elif shape and N is not None and shape[-1] == N:
                tail = ["contour"]
            elif shape and shape[-1] == Ny:
                tail = [ydim]
        lead_shape = a.shape[:a.ndim - len(tail)]
        lead = [batch_dims[i] if i < len(batch_dims) else f"dim{i}_{s}"
                for i, s in enumerate(lead_shape)]
        ds.variables[name] = a
        ds.dims[name] = tuple(lead + tail)
        base = name[:-3] if name.endswith("_at") else name
        if base in _ATTRS:
            ds.attrs[name] = dict(_ATTRS[base])
    return ds
