"""The port's sharded functions and steps (``xcontour_tpu_torch.parallel``)
over gloo CPU ranks, against the JAX package's unsharded functions and the
port's own, on the same numpy inputs in float64.

Ranks are processes (``parallel.launch.run_ranks``), four a mesh, each
running every case of ``tests/torch_parallel_cases.py`` once per mesh
shape (a module-scoped fixture) and saving its local blocks; the 1x1
mesh runs in this process as a group of one (the ring of one: no
collective runs).  This process joins the blocks (a replicated output
must be bit for bit the same on every x rank) and compares:

* the CDF, sort, stencil, LWA and length pieces at the JAX suite's rtol
  1e-12 (tests/test_parallel.py), with an atol of 1e-13 of the largest
  magnitude where cells cancel to ~0 (the stencil's walls, LWA's empty
  cells, the JAX suite's atol 1e-15 at unit scale);
* the pipeline keys at rtol 1e-9, atol 1e-12 (test_parallel.py:77-95).

The inputs hold the JAX suite's hard cases: x-varying dA and weights, a
NaN land patch across shard edges, an all-NaN window, batched (B, N) bins
in both directions, non-periodic x with each bc_y, and a snapshot whose
x slab (two, on four x ranks) is all NaN.
"""

import contextlib
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from xcontour_tpu import config as jconfig
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.diagnostics import length as jlength
from xcontour_tpu.diagnostics import local_length as jlocal
from xcontour_tpu.diagnostics import lwa as jlwa
from xcontour_tpu.ops import histogram as jhist
from xcontour_tpu.ops import sort as jsort
from xcontour_tpu.ops import stencil as jstencil
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import parallel as P
from xcontour_tpu_torch.ops.histogram import weighted_cdf
from xcontour_tpu_torch.ops.sort import exact_conditional_integral
from xcontour_tpu_torch.parallel import _comm
from xcontour_tpu_torch.parallel.launch import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
CASES_FILE = os.path.join(HERE, "torch_parallel_cases.py")
_spec = importlib.util.spec_from_file_location("torch_parallel_cases",
                                               CASES_FILE)
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)

MESHES = ("1x1", "2x2", "1x4", "4x1")
PIECE_RTOL, PIECE_ATOL = 1e-12, 1e-13
PIPE_RTOL, PIPE_ATOL = 1e-9, 1e-12
# the ring of one leaves these the unsharded operations (the lengths
# measure one NaN halo column more, whose zeros change the sums' rounding)
BITWISE_1X1 = ("cdf", "sort", "stencil", "lwa", "local_w9", "local_w7")
PIPES = ("keff_lwa_auto", "keff_lwa_dense", "keff_hist", "keff_broadcast",
         "lwa_dy", "lwa_upper", "clength")


def _join(outdir, world):
    """{(case, key): whole array} from the ranks' blocks."""
    blocks = [dict(np.load(os.path.join(outdir, f"out{r}.npz")))
              for r in range(world)]
    coords = [tuple(int(c) for c in b.pop("coords")) for b in blocks]
    nb = 1 + max(c[0] for c in coords)
    nx = 1 + max(c[1] for c in coords)
    at = {c: b for c, b in zip(coords, blocks)}
    out = {}
    for key in blocks[0]:
        kind, case, name = key.split("|")
        if kind == "r":
            for b in blocks[1:]:
                assert np.array_equal(b[key], blocks[0][key], equal_nan=True)
            out[case, name] = blocks[0][key]
            continue
        rows = []
        for i in range(nb):
            parts = [at[i, j][key] for j in range(nx)]
            if kind == "b":
                for p in parts[1:]:     # replicated over x, bit for bit
                    assert np.array_equal(p, parts[0], equal_nan=True), key
                rows.append(parts[0])
            else:
                rows.append(np.concatenate(parts, axis=-1))
        out[case, name] = np.concatenate(rows, axis=0)
    return out


@pytest.fixture(scope="module", params=MESHES)
def run(request, tmp_path_factory):
    """(mesh spec, joined outputs, collectives run) of one launch."""
    spec = request.param
    d = str(tmp_path_factory.mktemp(f"mesh{spec}"))
    if spec == "1x1":
        before = dict(_comm.CALLS)
        with _group_of_one(d):
            C.rank_cases(d, spec)
        assert dict(_comm.CALLS) == before, "a ring of one ran a collective"
        return spec, _join(d, 1)
    run_ranks(CASES_FILE + ":rank_cases", 4, d, args=[spec], timeout=240)
    return spec, _join(d, 4)


@contextlib.contextmanager
def _group_of_one(d):
    """A gloo group of one in this process, its store under ``d``."""
    store = dist.FileStore(os.path.join(d, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """{step: (its sharded step's span names, its own)} on the 1x1 mesh."""
    with _group_of_one(str(tmp_path_factory.mktemp("stages"))):
        return C.stage_names(P.make_mesh(x_size=1))


def _jgrids():
    ll = jgrid.from_latlon(C.LAT, C.LON, dtype=jnp.float64)
    cart = jgrid.from_cartesian(C.CART_Y, C.CART_X, periodic_x=False,
                                dtype=jnp.float64)
    return ll, {bc: jgrid.Grid(**{**{f.name: getattr(cart, f.name)
                                     for f in dataclasses.fields(cart)},
                                  "bc_y": bc})
                for bc in ("extend", "reflect", "fill")}


def _jax_refs():
    """{(case, key): the JAX package's unsharded result}."""
    d = C.inputs()
    j = {k: jnp.asarray(a) for k, a in d.items()}
    ll, carts = _jgrids()
    out = {}
    for lt in (True, False):
        for o, bins in (("inc", j["bins"]), ("dec", j["bins"][::-1])):
            out["cdf", f"{lt}_{o}"] = jhist.weighted_cdf(j["v"], bins,
                                                         j["w"], lt)
        for o, bins in (("rep", j["bins"]), ("bat", j["bins_b"]),
                        ("batdec", j["bins_b"][:, ::-1])):
            out["sort", f"{lt}_{o}"] = jsort.exact_conditional_integral(
                j["v"], bins, j["w"], lt)
    out["stencil", "latlon"] = jstencil.squared_gradient(j["q"], ll)
    for bc, g in carts.items():
        out["stencil", f"cart_{bc}"] = jstencil.squared_gradient(j["q"], g)
    for name, g in (("latlon", ll), ("cart", carts["fill"])):
        out["stencil", f"grad_y_{name}"], out["stencil", f"grad_x_{name}"] = \
            jstencil.gradient(j["q"], g)
    ydef = jnp.asarray(C.LAT)
    kw = dict(increase=True)
    out["lwa", "auto"] = jlwa.local_wave_activity(j["v"], j["Q"], j["w"],
                                                  ydef, **kw)
    out["lwa", "dense"] = jlwa.local_wave_activity(j["v"], j["Q"], j["w"],
                                                   ydef, method="dense", **kw)
    out["lwa", "upper_dec"] = jlwa.local_wave_activity(
        j["v"], j["Q"], j["w"], ydef, increase=False, part="upper")
    out["lwa", "lwa2"] = jlwa.local_wave_activity2(j["v"], j["Q"], j["w"],
                                                   ydef, **kw)
    out["length", "latlon"] = jlength.contour_lengths(
        j["q"], j["ctr"], jnp.asarray(C.LAT), jnp.asarray(C.LON), latlon=True)
    out["length", "cart"] = jlength.contour_lengths(
        j["q"], j["ctr"], jnp.asarray(C.CART_Y), jnp.asarray(C.CART_X))
    with jconfig.use_pallas_scope(False):
        for window, stride, latlon in C.WINDOWS:
            y, x = (C.LAT, C.LON) if latlon else (C.CART_Y, C.CART_X)
            L, cy, cx = jlocal.local_contour_lengths(
                j["field"], jnp.asarray(y), jnp.asarray(x), window=window,
                stride=stride, latlon=latlon)
            out.update({(f"local_w{window}", "lengths"): L,
                        (f"local_w{window}", "cy"): cy,
                        (f"local_w{window}", "cx"): cx})
    t, pre = j["tracer"], j["pre_y"]
    pipes = {
        "keff_lwa_auto": lambda: jpipe.keff_lwa_pipeline(
            t, ll, pre_y=pre, N=C.N, with_lwa2=True),
        "keff_lwa_dense": lambda: jpipe.keff_lwa_pipeline(
            t, ll, N=C.N, lmin="dxF", lwa_method="dense", metric="dy"),
        "keff_hist": lambda: jpipe.keff_pipeline(t, ll, pre_y=pre, N=C.N),
        "keff_broadcast": lambda: jpipe.keff_pipeline(
            t, ll, N=C.N, hist=False, lt=False, lmin="frac"),
        "lwa_dy": lambda: jpipe.lwa_pipeline(t, ll, N=C.N, metric="dy"),
        "lwa_upper": lambda: jpipe.lwa_pipeline(t, ll, N=C.N, part="upper",
                                                increase=False),
        "clength": lambda: jpipe.clength_pipeline(t, ll, N=C.N),
    }
    for name, fn in pipes.items():
        for k, v in jpipe.flatten_output(fn()).items():
            out[f"pipe_{name}", k] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _port_refs():
    """{(case, key): the port's unsharded result on the CPU}."""
    d = {k: C._t(a) for k, a in C.inputs().items()}
    ll, carts = C.grids()
    out = {}
    for lt in (True, False):
        for o, bins in (("inc", d["bins"]), ("dec", d["bins"].flip(0))):
            out["cdf", f"{lt}_{o}"] = weighted_cdf(d["v"], bins, d["w"], lt)
        for o, bins in (("rep", d["bins"]), ("bat", d["bins_b"]),
                        ("batdec", d["bins_b"].flip(-1))):
            out["sort", f"{lt}_{o}"] = exact_conditional_integral(
                d["v"], bins, d["w"], lt)
    out["stencil", "latlon"] = xt.squared_gradient(d["q"], ll)
    for bc, g in carts.items():
        out["stencil", f"cart_{bc}"] = xt.squared_gradient(d["q"], g)
    for name, g in (("latlon", ll), ("cart", carts["fill"])):
        out["stencil", f"grad_y_{name}"], out["stencil", f"grad_x_{name}"] = \
            xt.gradient(d["q"], g)
    ydef = C._t(C.LAT)
    v, Q, w = d["v"], d["Q"], d["w"]
    out["lwa", "auto"] = xt.local_wave_activity(v, Q, w, ydef, increase=True)
    out["lwa", "dense"] = xt.local_wave_activity(v, Q, w, ydef, increase=True,
                                                 method="dense")
    out["lwa", "upper_dec"] = xt.local_wave_activity(v, Q, w, ydef,
                                                     increase=False,
                                                     part="upper")
    out["lwa", "lwa2"] = xt.local_wave_activity2(v, Q, w, ydef, increase=True)
    out["length", "latlon"] = xt.contour_lengths(
        d["q"], d["ctr"], C._t(C.LAT), C._t(C.LON), latlon=True)
    out["length", "cart"] = xt.contour_lengths(d["q"], d["ctr"],
                                               C._t(C.CART_Y),
                                               C._t(C.CART_X))
    for window, stride, latlon in C.WINDOWS:
        y, x = (C.LAT, C.LON) if latlon else (C.CART_Y, C.CART_X)
        L, cy, cx = xt.local_contour_lengths(d["field"], C._t(y), C._t(x),
                                             window=window, stride=stride,
                                             latlon=latlon)
        out.update({(f"local_w{window}", "lengths"): L,
                    (f"local_w{window}", "cy"): cy,
                    (f"local_w{window}", "cx"): cx})
    t, pre = d["tracer"], d["pre_y"]
    pipes = {
        "keff_lwa_auto": lambda: xt.keff_lwa_pipeline(
            t, ll, pre_y=pre, N=C.N, with_lwa2=True),
        "keff_lwa_dense": lambda: xt.keff_lwa_pipeline(
            t, ll, N=C.N, lmin="dxF", lwa_method="dense", metric="dy"),
        "keff_hist": lambda: xt.keff_pipeline(t, ll, pre_y=pre, N=C.N),
        "keff_broadcast": lambda: xt.keff_pipeline(
            t, ll, N=C.N, hist=False, lt=False, lmin="frac"),
        "lwa_dy": lambda: xt.lwa_pipeline(t, ll, N=C.N, metric="dy"),
        "lwa_upper": lambda: xt.lwa_pipeline(t, ll, N=C.N, part="upper",
                                             increase=False),
        "clength": lambda: xt.clength_pipeline(t, ll, N=C.N),
    }
    for name, fn in pipes.items():
        for k, val in xt.pipeline.flatten_output(fn()).items():
            out[f"pipe_{name}", k] = val
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def refs():
    return dict(jax=_jax_refs(), port=_port_refs())


def _close(got, want, rtol, atol_frac, what):
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * scale,
                               equal_nan=True, err_msg=what)


def _check(run, refs, case, rtol, atol):
    spec, got = run
    keys = [k for k in got if k[0] == case]
    assert keys, case
    want_keys = {k for k in refs["jax"] if k[0] == case}
    assert set(keys) == want_keys, (case, sorted(set(keys) ^ want_keys))
    for k in keys:
        for side in ("jax", "port"):
            _close(got[k], refs[side][k], rtol, atol,
                   f"{spec} {k} against the {side} unsharded result")
    if spec == "1x1" and case in BITWISE_1X1:
        # the ring of one: the same operations as unsharded
        for k in keys:
            assert np.array_equal(got[k], refs["port"][k], equal_nan=True), k


@pytest.mark.parametrize("case", ["cdf", "sort", "stencil", "lwa", "length",
                                  "local_w9", "local_w7"])
def test_sharded_piece_matches_unsharded(run, refs, case):
    _check(run, refs, case, PIECE_RTOL, PIECE_ATOL)


@pytest.mark.parametrize("name", PIPES)
def test_sharded_pipeline_matches_unsharded(run, refs, name):
    _check(run, refs, f"pipe_{name}", PIPE_RTOL, PIPE_ATOL)


def test_all_nan_slab_levels(run, refs):
    """The snapshot whose x slab is all NaN gets the whole field's levels:
    its ranks' +inf/-inf extrema do not poison the min/max reduce."""
    _, got = run
    lv = got["pipe_keff_lwa_auto", "contour"][1]
    assert np.isfinite(lv).all()
    np.testing.assert_array_equal(
        lv, refs["port"]["pipe_keff_lwa_auto", "contour"][1])


@pytest.mark.parametrize("step", ["keff", "lwa", "keff_lwa", "clength"])
def test_sharded_step_spans_its_unsharded_stages(stages, step):
    """A sharded step is its unsharded step on a mesh layout: the same
    entry span and ``stage.*`` spans."""
    sharded, unsharded = stages[step]
    assert f"pipeline.{step}_pipeline" in unsharded
    assert {"stage.contours", "stage.cdf", "stage.lookup"} <= set(unsharded)
    assert sharded == unsharded
