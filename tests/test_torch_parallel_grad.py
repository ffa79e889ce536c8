"""Gradients through the port's sharded functions and steps
(``xcontour_tpu_torch.parallel``) over gloo CPU ranks, against ``jax.grad``
of the JAX package's unsharded functions on the same numpy inputs in
float64.

Ranks are processes (``parallel.launch.run_ranks``), one launch a mesh
shape (a module-scoped fixture; the 1x1 mesh is one rank, a group of
one), each running every case of ``tests/torch_parallel_cases.py``'s
``GRAD_CASES``: the rank takes the gradient of its part of
``sum(r * out)`` (r seeded, of the whole output's shape; a replicated
output through ``parallel.once_per_mesh``), and this process joins the
ranks' gradients (an x-sharded input's blocks side by side, a replicated
input's shares summed over 'x') and compares them with ``jax.grad`` of
``sum(r * out)`` of the unsharded function: the same non-finite pattern,
rtol 1e-9, atol 1e-12 of the largest |gradient| (the JAX suite's sharded
adjoint bound, tests/test_parallel.py:310).

The cases: the halo stencil (periodic, and non-periodic with each bc_y),
the gradient, the CDF's and the exact integral's weights, LWA and LWA2
(q and Q), contour lengths (data and levels), windowed lengths (a window
row block empty on the last of four x ranks), the JAX suite's adjoint,
the levels of a field whose extrema tie across x-shard edges, a table
made replicated (the broadcast's backward), a Hessian-vector product,
and the steps (one with a supplied grdS that is differentiated too).  Each step also runs without a gradient: no autograd Function, and
the collectives of the forward-only steps.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xcontour_tpu import config as jconfig
from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.diagnostics import length as jlength
from xcontour_tpu.diagnostics import local_length as jlocal
from xcontour_tpu.diagnostics import lwa as jlwa
from xcontour_tpu.ops import histogram as jhist
from xcontour_tpu.ops import sort as jsort
from xcontour_tpu.ops import stencil as jstencil
from xcontour_tpu_torch.parallel.launch import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
CASES_FILE = os.path.join(HERE, "torch_parallel_cases.py")
_spec = importlib.util.spec_from_file_location("torch_parallel_cases",
                                               CASES_FILE)
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)

MESHES = ("1x1", "2x2", "1x4", "4x1")
RTOL, ATOL = 1e-9, 1e-12
# the collectives of each step without a gradient where 'x' has more than
# one rank: the halo shifts (two for the stencil, one for the lengths),
# the table's broadcast, the levels' min and max, the integrals' sums
STEP_CALLS = {
    "keff_lwa_auto": dict(shift=2, broadcast=1, min=1, max=1, sum=1),
    "keff_lwa_dense": dict(shift=2, broadcast=1, min=1, max=1, sum=1),
    "keff_hist": dict(shift=2, broadcast=1, min=1, max=1, sum=1),
    "keff_broadcast": dict(shift=2, min=1, max=1, sum=2),
    "lwa_upper": dict(broadcast=1, min=1, max=1, sum=1),
    "clength": dict(shift=3, broadcast=1, min=1, max=1, sum=2),
}


def _join(outdir, world):
    """({(case, input): the joined gradient}, [each rank's step counts])."""
    blocks = [dict(np.load(os.path.join(outdir, f"grad{r}.npz")))
              for r in range(world)]
    calls = [json.load(open(os.path.join(outdir, f"calls{r}.json")))
             for r in range(world)]
    coords = [tuple(int(c) for c in b.pop("coords")) for b in blocks]
    nb = 1 + max(c[0] for c in coords)
    nx = 1 + max(c[1] for c in coords)
    at = {c: b for c, b in zip(coords, blocks)}
    out = {}
    for key in blocks[0]:
        kind, case, name = key.split("|")
        rows = []
        for i in range(nb):
            parts = [at[i, j][key] for j in range(nx)]
            rows.append(np.concatenate(parts, axis=-1) if kind == "x"
                        else sum(parts[1:], parts[0]))
        if rows[0].ndim < 3 and kind == "x":
            # a plane the batch axis does not split: every batch row of
            # the mesh differentiates the same field
            for r in rows[1:]:
                assert np.array_equal(r, rows[0], equal_nan=True), key
            out[case, name] = rows[0]
        else:
            out[case, name] = np.concatenate(rows, axis=0)
    return out, calls


@pytest.fixture(scope="module", params=MESHES)
def run(request, tmp_path_factory):
    """(mesh spec, joined gradients, each rank's step counts)."""
    spec = request.param
    b, x = (int(s) for s in spec.split("x"))
    d = str(tmp_path_factory.mktemp(f"grad{spec}"))
    run_ranks(CASES_FILE + ":rank_grads", b * x, d, args=[spec], timeout=240)
    return (spec,) + _join(d, b * x)


def _jgrids():
    ll = jgrid.from_latlon(C.LAT, C.LON, dtype=jnp.float64)
    cart = jgrid.from_cartesian(C.CART_Y, C.CART_X, periodic_x=False,
                                dtype=jnp.float64)
    return ll, {bc: jgrid.Grid(**{**{f.name: getattr(cart, f.name)
                                     for f in dataclasses.fields(cart)},
                                  "bc_y": bc})
                for bc in ("extend", "reflect", "fill")}


def _jsteps(ll, pre):
    return {
        "keff_lwa_dense": lambda t: jpipe.keff_lwa_pipeline(
            t, ll, pre_y=pre, N=C.N, lmin="dxF", lwa_method="dense",
            metric="dy", with_lwa2=True),
        "keff_hist": lambda t: jpipe.keff_pipeline(t, ll, pre_y=pre, N=C.N),
        "keff_broadcast": lambda t: jpipe.keff_pipeline(
            t, ll, N=C.N, hist=False, lt=False, lmin="frac"),
        "lwa_upper": lambda t: jpipe.lwa_pipeline(t, ll, N=C.N,
                                                  part="upper",
                                                  increase=False),
        "clength": lambda t: jpipe.clength_pipeline(t, ll, N=C.N),
    }


def _jforward(case, x):
    """{key: whole output} of the JAX package's unsharded function of
    ``case`` on the whole inputs ``x`` (the differentiated ones) and the
    shared inputs."""
    d = {k: jnp.asarray(a) for k, a in C.grad_inputs().items()}
    ll, carts = _jgrids()
    kind, _, rest = case.partition("_")
    if kind == "stencil":
        g = ll if rest == "latlon" else carts[rest[5:]]
        return {"out": jstencil.squared_gradient(x["q"], g)}
    if kind == "gradient":
        g = ll if rest == "latlon" else carts["fill"]
        qy, qx = jstencil.gradient(x["q"], g)
        return {"qy": qy, "qx": qx}
    if kind == "cdf":
        lt, o = rest.split("_")
        bins = d["bins"] if o == "inc" else d["bins"][::-1]
        return {"out": jhist.weighted_cdf(d["v"], bins, x["wv"],
                                          lt == "True")}
    if kind == "sort":
        lt, o = rest.split("_")
        bins = d["bins"] if o == "rep" else d["bins_b"]
        return {"out": jsort.exact_conditional_integral(d["v"], bins,
                                                        x["wv"],
                                                        lt == "True")}
    if kind == "lwa":
        fn = jlwa.local_wave_activity2 if rest == "lwa2" else \
            jlwa.local_wave_activity
        kw = dict(method="dense") if rest == "dense" else {}
        return {"out": fn(x["v"], x["Q"], d["w"], jnp.asarray(C.LAT),
                          increase=True, **kw)}
    if kind == "length":
        y, xx = (C.LAT, C.LON) if rest == "latlon" else (C.CART_Y, C.CART_X)
        return {"out": jlength.contour_lengths(
            x["q"], x["ctr"], jnp.asarray(y), jnp.asarray(xx),
            latlon=rest == "latlon")}
    if kind == "local":
        window, stride, latlon = next(w for w in C.WINDOWS
                                      if f"w{w[0]}" == rest)
        y, xx = (C.LAT, C.LON) if latlon else (C.CART_Y, C.CART_X)
        return {"out": jlocal.local_contour_lengths(
            x["field"], jnp.asarray(y), jnp.asarray(xx), window=window,
            stride=stride, latlon=latlon)[0]}
    if kind == "adjoint":
        out = jpipe.keff_lwa_pipeline(x["adj"], ll, N=C.ADJ_N,
                                      increase=True, lt=True,
                                      lmin="analytic")
        return {"lwa": out["lwa"], "nkeff": out["nkeff"]}
    if kind == "hvp":
        out = jpipe.keff_lwa_pipeline(x["adj"], ll, N=C.HVP_N)
        return {"nkeff": out["nkeff"] * 1e-6}
    if kind == "table":
        return {"out": 2.0 * x["Q"]}      # replicated: no collective in JAX
    if kind == "tie":
        return {"out": jcore.cal_contours(x["tie"], C.N,
                                          increase=rest == "True")}
    if rest == "keff_lwa_grdS":
        flat = jpipe.flatten_output(jpipe.keff_lwa_pipeline(
            x["tracer"], ll, x["grdS"], N=C.N))
    else:
        flat = jpipe.flatten_output(
            _jsteps(ll, d["pre_y"])[rest](x["tracer"]))
    return {k: v for k, v in flat.items() if k != "table"}


def _jgrad(case):
    """{input: jax.grad of sum(r * out) over the case's outputs}."""
    whole = C.grad_inputs()
    names = list(C.GRAD_CASES[case])

    def loss(*xs):
        outs = _jforward(case, dict(zip(names, xs)))
        total = 0.0
        for key, o in outs.items():
            r = jnp.asarray(C.loss_weights(case, key, o.shape))
            ro = r * o
            total = total + jnp.nansum(jnp.where(jnp.isfinite(ro), ro, 0.0))
        return total
    args = [jnp.asarray(whole[n]) for n in names]
    with jconfig.use_pallas_scope(False):
        if case == "hvp":
            v = jnp.asarray(C.loss_weights(case, "v", args[0].shape))
            grads = (jax.grad(lambda a: jnp.vdot(jax.grad(loss)(a), v))(
                args[0]),)
        else:
            grads = jax.grad(loss, argnums=tuple(range(len(names))))(*args)
    return {n: np.asarray(g) for n, g in zip(names, grads)}


@pytest.fixture(scope="module")
def jax_grads():
    return {}


def _check(run, jax_grads, case):
    spec, got, _ = run
    if case not in jax_grads:
        jax_grads[case] = _jgrad(case)
    for name, want in jax_grads[case].items():
        g = got[case, name]
        what = f"{spec} {case} d/d{name}"
        assert g.shape == want.shape, what
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want), what)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(want),
                                      what)
        m = np.isfinite(want)
        scale = np.abs(want[m]).max() if m.any() else 0.0
        assert scale > 0, what
        np.testing.assert_allclose(g[m], want[m], rtol=RTOL,
                                   atol=ATOL * scale, err_msg=what)


@pytest.mark.parametrize("case", [c for c in C.GRAD_CASES
                                  if not c.startswith(("pipe_", "adjoint",
                                                       "hvp", "tie_"))])
def test_sharded_function_gradient_matches_jax(run, jax_grads, case):
    _check(run, jax_grads, case)


def test_sharded_adjoint_matches_jax(run, jax_grads):
    """tests/test_parallel.py:310's loss, nansum(lwa^2) + nansum(nkeff) of
    keff_lwa_pipeline(N=11, lmin='analytic') on 8x24x48 (sum(r * out) with
    seeded r here): each rank's block of the tracer's gradient."""
    _check(run, jax_grads, "adjoint")


def test_sharded_second_order_matches_jax(run, jax_grads):
    """A Hessian-vector product of the Keff step (finite nkeff, as
    tests/test_torch_grad_keff.py's unsharded one): the collectives'
    backwards are differentiable collectives, as ``jax.grad`` of
    ``jax.grad`` goes through ``shard_map``."""
    _check(run, jax_grads, "hvp")


@pytest.mark.parametrize("increase", [True, False])
def test_extrema_tied_across_shard_edges(run, jax_grads, increase):
    """The levels' gradient where the minimum (and the maximum) is taken
    by two cells on one side of an x-shard edge and one on the other: each
    tied cell gets an equal part on every mesh, as JAX splits it."""
    _check(run, jax_grads, f"tie_{increase}")
    spec, got, _ = run
    g = got[f"tie_{increase}", "tie"]
    for row, cols in ((7, slice(22, 25)), (15, slice(10, 13))):
        tied = g[1:, row, cols]
        np.testing.assert_allclose(tied, tied[:, :1].repeat(3, axis=1),
                                   rtol=1e-12)
        assert np.all(tied != 0)


@pytest.mark.parametrize("name", [c[5:] for c in C.GRAD_CASES
                                  if c.startswith("pipe_")])
def test_sharded_step_gradient_matches_jax(run, jax_grads, name):
    _check(run, jax_grads, f"pipe_{name}")


@pytest.mark.parametrize("step", list(STEP_CALLS))
def test_step_without_gradient_runs_no_function(run, step):
    """A step that takes no gradient (grad mode off, or no input requiring
    grad) runs no autograd Function and the collectives it ran forward
    only; with a gradient its forward runs the same collectives, and the
    backward one of each kind a collective's backward, none on a group of
    one."""
    spec, _, calls = run
    wide = spec.split("x")[1] != "1"
    want = STEP_CALLS[step] if wide else {}
    for rank, c in enumerate(calls):
        modes = c[step]
        for mode in ("no_grad", "plain"):
            assert modes[mode] == [want, {}], (spec, rank, step, mode)
        fwd, applied = modes["grad"]
        assert fwd == want, (spec, rank, step)
        comm = {k for k in applied
                if k in ("_Sum", "_Extremum", "_Broadcast", "_AllGather",
                         "_ReduceScatter", "_Shift", "_Keep")}
        assert bool(comm) == wide, (spec, rank, step, applied)
        bwd, applied = modes["backward"]
        assert applied == {}, (spec, rank, step)
        assert set(bwd) <= {f"{k}_grad" for k in want}, (spec, rank, step)
        assert bool(bwd) == wide, (spec, rank, step)
