"""Rank-side cases of tests/test_torch_parallel.py (``rank_cases``,
``stage_names``),
tests/test_torch_parallel_grad.py (``rank_grads``) and
tests/test_torch_parallel_cli.py (``rank_runner``).

Loaded by path in each rank process (``xcontour_tpu_torch.parallel.launch``),
so it imports neither conftest nor jax: numpy, torch and the port only.
Every rank makes the same whole inputs from one seed, cuts its block,
runs each sharded function and saves its local outputs to
``out{rank}.npz``, each key tagged with how its blocks join:

* ``x``: (B_local, ..., Nx_local) blocks, sharded over batch and x;
* ``b``: (B_local, ...) blocks, replicated over x;
* ``r``: the whole output, the same on every rank.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import parallel as P
from xcontour_tpu_torch.parallel import _comm

B, NY, NX, N = 8, 24, 48, 11
LAT = np.linspace(-80.0, 80.0, NY)
LON = np.linspace(0.0, 360.0 - 360.0 / NX, NX)
CART_Y = np.arange(NY) * 50.0
CART_X = np.arange(NX) * 80.0
WINDOWS = ((9, 4, True), (7, 3, False))
F64 = torch.float64


def inputs():
    """The whole numpy inputs, from one seed."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(B, NY, NX))
    v[0, 3, 5] = np.nan                          # NaN values count nothing
    w = rng.uniform(0.5, 2.0, size=(NY, NX))     # x-varying weights and dA
    bins = np.linspace(np.nanmin(v), np.nanmax(v), N)
    bins_b = np.stack([np.linspace(np.nanmin(t), np.nanmax(t), N)
                       for t in v])
    q = (np.sin(np.deg2rad(LAT))[None, :, None]
         + 0.15 * rng.standard_normal((B, NY, NX)))
    q[:, 5:8, 8:28] = np.nan                     # land across shard edges
    ctr = np.stack([np.linspace(np.nanmin(t), np.nanmax(t), 9) for t in q])
    Q = np.sort(rng.normal(size=(B, NY)), axis=-1)
    field = (np.sin(np.deg2rad(LAT))[:, None]
             + 0.15 * rng.standard_normal((NY, NX)))
    field[4:16, 20:32] = np.nan                  # an all-NaN window
    tracer = (np.sin(np.deg2rad(LAT))[None, :, None]
              + 0.1 * rng.standard_normal((B, NY, NX)))
    tracer[1, :, :24] = np.nan                   # an all-NaN x slab
    tracer[2, 3:6, 10:14] = np.nan
    return dict(v=v, w=w, bins=bins, bins_b=bins_b, q=q, ctr=ctr, Q=Q,
                field=field, tracer=tracer, pre_y=np.linspace(-70, 70, 13))


def grids():
    """(lat-lon periodic grid, non-periodic Cartesian grids by bc_y)."""
    ll = xt.from_latlon(LAT, LON, dtype=F64, device="cpu")
    cart = xt.from_cartesian(CART_Y, CART_X, periodic_x=False, dtype=F64,
                             device="cpu")
    return ll, {bc: dataclasses.replace(cart, bc_y=bc)
                for bc in ("extend", "reflect", "fill")}


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=F64)


def cases(mesh):
    """{'kind|case|key': local output}."""
    d = {k: _t(a) for k, a in inputs().items()}
    s3, s2 = P.shard_batch_spec(mesh, 3), P.shard_batch_spec(mesh, 2)
    brows = s3.index(d["v"].shape)[0]
    ll, carts = grids()
    out = {}

    def put(kind, case, res):
        for k, t in res.items():
            out[f"{kind}|{case}|{k}"] = t

    vb, wb = s3.block(d["v"]), s2.block(d["w"])
    put("b", "cdf", {
        f"{lt}_{o}": P.sharded_weighted_cdf(vb, bins, wb, lt, mesh)
        for lt in (True, False)
        for o, bins in (("inc", d["bins"]), ("dec", d["bins"].flip(0)))})
    put("b", "sort", {
        f"{lt}_{o}": P.sharded_exact_conditional_integral(vb, bins, wb, lt,
                                                          mesh)
        for lt in (True, False)
        for o, bins in (("rep", d["bins"]), ("bat", d["bins_b"][brows]),
                        ("batdec", d["bins_b"][brows].flip(-1)))})

    qb = s3.block(d["q"])
    res = {"latlon": P.sharded_squared_gradient(qb, ll, mesh)}
    for bc, g in carts.items():
        res[f"cart_{bc}"] = P.sharded_squared_gradient(qb, g, mesh)
    for name, g in (("latlon", ll), ("cart", carts["fill"])):
        res[f"grad_y_{name}"], res[f"grad_x_{name}"] = \
            P.sharded_gradient(qb, g, mesh)
    put("x", "stencil", res)

    Qb, ydef = d["Q"][brows], _t(LAT)
    put("x", "lwa", {
        "auto": P.sharded_local_wave_activity(vb, Qb, d["w"], ydef, mesh,
                                              increase=True),
        "dense": P.sharded_local_wave_activity(vb, Qb, d["w"], ydef, mesh,
                                               increase=True, method="dense"),
        "upper_dec": P.sharded_local_wave_activity(
            vb, Qb, d["w"], ydef, mesh, increase=False, part="upper"),
        "lwa2": P.sharded_local_wave_activity2(vb, Qb, d["w"], ydef, mesh,
                                               increase=True)})

    ctrb = d["ctr"][brows]
    put("b", "length", {
        "latlon": P.sharded_contour_lengths(qb, ctrb, _t(LAT), _t(LON), mesh,
                                            latlon=True),
        "cart": P.sharded_contour_lengths(qb, ctrb, _t(CART_Y), _t(CART_X),
                                          mesh)})

    fb = s2.block(d["field"])
    for window, stride, latlon in WINDOWS:
        y, x = (LAT, LON) if latlon else (CART_Y, CART_X)
        L, cy, cx = P.sharded_local_lengths(fb, _t(y), _t(x), mesh,
                                            window=window, stride=stride,
                                            latlon=latlon)
        put("r", f"local_w{window}", dict(lengths=L, cy=cy, cx=cx))

    tb, pre = s3.block(d["tracer"]), d["pre_y"]
    runs = {
        "keff_lwa_auto": lambda: P.sharded_keff_lwa_pipeline(
            tb, ll, mesh, pre_y=pre, N=N, with_lwa2=True),
        "keff_lwa_dense": lambda: P.sharded_keff_lwa_pipeline(
            tb, ll, mesh, N=N, lmin="dxF", lwa_method="dense", metric="dy"),
        "keff_hist": lambda: P.sharded_keff_pipeline(tb, ll, mesh, pre_y=pre,
                                                     N=N),
        "keff_broadcast": lambda: P.sharded_keff_pipeline(
            tb, ll, mesh, N=N, hist=False, lt=False, lmin="frac"),
        "lwa_dy": lambda: P.sharded_lwa_pipeline(tb, ll, mesh, N=N,
                                                 metric="dy"),
        "lwa_upper": lambda: P.sharded_lwa_pipeline(tb, ll, mesh, N=N,
                                                    part="upper",
                                                    increase=False),
        "clength": lambda: P.sharded_clength_pipeline(tb, ll, mesh, N=N),
    }
    for name, run in runs.items():
        flat = xt.pipeline.flatten_output(run())
        for k, t in flat.items():
            kind = "x" if k in P.X_SHARDED else "r" if k == "table" else "b"
            put(kind, f"pipe_{name}", {k: t})
    return out


def stage_names(mesh):
    """{step: (the ``pipeline.*`` and ``stage.*`` ranges a CPU profiler
    records of the sharded step on the rank's block of ``tracer``, those
    of its unsharded twin on the whole snapshots)}."""
    d = {k: _t(a) for k, a in inputs().items()}
    t = d["tracer"]
    tb = P.shard_batch_spec(mesh, 3).block(t)
    ll = grids()[0]
    steps = {"keff": (P.sharded_keff_pipeline, xt.keff_pipeline),
             "lwa": (P.sharded_lwa_pipeline, xt.lwa_pipeline),
             "keff_lwa": (P.sharded_keff_lwa_pipeline, xt.keff_lwa_pipeline),
             "clength": (P.sharded_clength_pipeline, xt.clength_pipeline)}

    def names(run):
        cpu = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=cpu) as p:
            run()
        return sorted({e.name for e in p.events()
                       if e.name.startswith(("pipeline.", "stage."))})

    return {name: (names(lambda: sfn(tb, ll, mesh, N=N)),
                   names(lambda: fn(t, ll, N=N)))
            for name, (sfn, fn) in steps.items()}


def rank_cases(workdir, spec):
    """Every case on a ``spec`` ('BxX') mesh over the world; saves this
    rank's outputs and its (batch, x) coordinates."""
    b, x = (int(s) for s in spec.split("x"))
    assert b * x == dist.get_world_size()
    mesh = P.make_mesh(x_size=x)
    out = {k: t.numpy() for k, t in cases(mesh).items()}
    coords = np.array([mesh.get_local_rank("batch"), mesh.get_local_rank("x")])
    np.savez(os.path.join(workdir, f"out{dist.get_rank()}.npz"),
             coords=coords, **out)


class _FlakySource:
    """Snapshots whose first read of a block fails on one rank."""

    def __init__(self, arr, bad_rank):
        self.arr, self.shape, self.dtype = arr, arr.shape, arr.dtype
        self.fail = dist.get_rank() == bad_rank

    def __getitem__(self, key):
        if self.fail:
            self.fail = False
            raise OSError("injected read failure")
        return self.arr[key]


class _RecordingSource:
    """Snapshots that record each index they are read at."""

    def __init__(self, arr):
        self.arr, self.shape, self.dtype = arr, arr.shape, arr.dtype
        self.keys = []

    def __getitem__(self, key):
        self.keys.append(key)
        return self.arr[key]


def rank_runner(workdir, spec):
    """``run_batched(sharding=)`` on a ``spec`` mesh of 4 ranks, with
    failures on one rank only; and the mesh helpers' topology."""
    from xcontour_tpu_torch.runner import WireRangeError, run_batched

    assert tuple(P.make_mesh().shape) == (2, 2)      # x = 2 for an even n
    hm = P.make_hybrid_mesh(slice_of=lambda r: r // 2)
    assert tuple(hm.shape) == (2, 2)                 # a whole node on x
    assert all(len({r // 2 for r in row}) == 1 for row in hm.mesh.tolist())
    b, x = (int(s) for s in spec.split("x"))
    mesh = P.make_mesh(x_size=x)
    sharding = P.shard_batch_spec(mesh, 3)
    rank = dist.get_rank()
    snaps = inputs()["tracer"][:7]                    # a padded tail chunk
    ll = grids()[0]
    kw = dict(batch=4, device="cpu", sharding=sharding,
              x_keys=P.X_SHARDED, log=lambda msg: None)

    def step(t):
        return xt.pipeline.flatten_output(
            P.sharded_keff_lwa_pipeline(t, ll, mesh, N=N))

    calls = []

    def fails_on_rank1(t):
        out = step(t)                     # after the step's collectives
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            raise RuntimeError("injected step failure")
        return out

    run_batched(fails_on_rank1, snaps, out_stem=os.path.join(workdir, "skip"),
                on_error="skip", **kw)
    run_batched(step, _FlakySource(snaps, 2),
                out_stem=os.path.join(workdir, "heal"), retries=1,
                retry_wait=0.0, **kw)

    def validate(out):
        if out["contour"].shape[0] == 3:
            raise ValueError("rejected the tail chunk")
    src = _RecordingSource(snaps)
    before = dict(_comm.CALLS)
    got = run_batched(step, src, on_error="skip", validate=validate, **kw)
    gathers = _comm.CALLS["gather_to"] - before.get("gather_to", 0)
    assert (got is None) == (rank != 0)
    if rank == 0:
        np.savez(os.path.join(workdir, "memory.npz"), **got)
    reads = [[[s.start, s.stop] for s in key] for key in src.keys]

    def fails_everywhere(t):
        raise RuntimeError("injected failure of every chunk")
    none = run_batched(fails_everywhere, snaps, on_error="skip",
                       out_stem=os.path.join(workdir, "none"), **kw)
    with open(os.path.join(workdir, f"runner{rank}.json"), "w") as f:
        json.dump(dict(coords=[mesh.get_local_rank("batch"),
                               mesh.get_local_rank("x")],
                       reads=reads, gathers=gathers,
                       all_failed_returns=repr(none)), f)
    big = snaps.copy()
    big[0, 0, 0] = 1e6                    # past float16: rank 0's block
    try:
        run_batched(step, big, transfer_dtype=np.float16, **kw)
        wire = "no error"
    except WireRangeError as e:
        wire = str(e)
    with open(os.path.join(workdir, f"wire{rank}.txt"), "w") as f:
        f.write(wire)


# -- gradients (tests/test_torch_parallel_grad.py) -------------------------

ADJ_N = 11                      # tests/test_parallel.py:310's levels
HVP_N = 9                       # tests/test_torch_grad_keff.py's HVP's


def grad_inputs():
    """inputs() and the gradient cases' own: per-snapshot weights, the JAX
    suite's adjoint tracer (8x24x48, no NaN), and a field whose minimum
    and maximum tie across x-shard edges (columns 23 | 24 split both the
    2- and 4-way meshes, 11 | 12 the 4-way one), with more tied cells on
    one side than the other."""
    d = inputs()
    rng = np.random.default_rng(12)
    d["wv"] = rng.uniform(0.5, 2.0, size=(B, NY, NX))
    d["adj"] = (np.sin(np.deg2rad(LAT))[None, :, None]
                + 0.1 * rng.standard_normal((B, NY, NX)))
    tie = rng.standard_normal((B, NY, NX))
    lo, hi = tie.min() - 1.0, tie.max() + 1.0
    tie[:, 7, 22:25] = lo                   # two cells left of 24, one right
    tie[:, 15, 10:13] = hi                  # two left of 12, one right
    tie[0, 2, 40] = lo                      # and a third x shard's
    d["tie"] = tie
    d["grdS"] = rng.uniform(0.0, 1.0, size=(B, NY, NX))
    return d


# case -> {input: how its blocks are cut and its gradient joins}: 'x' the
# rank's (batch,) x block, 'b' its batch rows, replicated over x (the
# gradient on each x rank a share: the shares add up)
GRAD_CASES = {
    **{f"stencil_{g}": {"q": "x"}
       for g in ("latlon", "cart_extend", "cart_reflect", "cart_fill")},
    **{f"gradient_{g}": {"q": "x"} for g in ("latlon", "cart_fill")},
    **{f"cdf_{lt}_{o}": {"wv": "x"} for lt in (True, False)
       for o in ("inc", "dec")},
    **{f"sort_{lt}_{o}": {"wv": "x"} for lt in (True, False)
       for o in ("rep", "bat")},
    **{f"lwa_{m}": {"v": "x", "Q": "b"} for m in ("auto", "dense", "lwa2")},
    **{f"length_{g}": {"q": "x", "ctr": "b"} for g in ("latlon", "cart")},
    **{f"local_w{w}": {"field": "x"} for w, _, _ in WINDOWS},
    "adjoint": {"adj": "x"},
    "hvp": {"adj": "x"},
    "table_replicated": {"Q": "b"},
    **{f"tie_{inc}": {"tie": "x"} for inc in (True, False)},
    **{f"pipe_{name}": {"tracer": "x"}
       for name in ("keff_lwa_dense", "keff_hist", "keff_broadcast",
                    "lwa_upper", "clength")},
    "pipe_keff_lwa_grdS": {"tracer": "x", "grdS": "x"},
}


def grad_steps(ll, pre):
    """The sharded steps of the gradient cases: name -> fn(block, mesh)."""
    return {
        "keff_lwa_dense": lambda t, m: P.sharded_keff_lwa_pipeline(
            t, ll, m, pre_y=pre, N=N, lmin="dxF", lwa_method="dense",
            metric="dy", with_lwa2=True),
        "keff_hist": lambda t, m: P.sharded_keff_pipeline(t, ll, m,
                                                          pre_y=pre, N=N),
        "keff_broadcast": lambda t, m: P.sharded_keff_pipeline(
            t, ll, m, N=N, hist=False, lt=False, lmin="frac"),
        "lwa_upper": lambda t, m: P.sharded_lwa_pipeline(
            t, ll, m, N=N, part="upper", increase=False),
        "clength": lambda t, m: P.sharded_clength_pipeline(t, ll, m, N=N),
    }


def step_outputs(out):
    """{key: (kind, output)} of a step, the table left out (no input of
    the cases reaches it)."""
    flat = xt.pipeline.flatten_output(out)
    return {k: ("x" if k in P.X_SHARDED else "b", t)
            for k, t in flat.items() if k != "table"}


def grad_forward(case, x, mesh):
    """{key: (kind, output)} of one case on the rank's input blocks ``x``;
    kind 'x' (the rank's block), 'b' (its batch rows, replicated over x)
    or 'r' (the whole output on every rank)."""
    d = {k: _t(a) for k, a in inputs().items()}
    s3 = P.shard_batch_spec(mesh, 3)
    brows = s3.index(d["v"].shape)[0]
    ll, carts = grids()
    kind, _, rest = case.partition("_")
    if kind == "stencil":
        g = ll if rest == "latlon" else carts[rest[5:]]
        return {"out": ("x", P.sharded_squared_gradient(x["q"], g, mesh))}
    if kind == "gradient":
        g = ll if rest == "latlon" else carts["fill"]
        qy, qx = P.sharded_gradient(x["q"], g, mesh)
        return {"qy": ("x", qy), "qx": ("x", qx)}
    vb = s3.block(d["v"])
    if kind in ("cdf", "sort"):
        lt, o = rest.split("_")
        lt = lt == "True"
        if kind == "cdf":
            bins = d["bins"] if o == "inc" else d["bins"].flip(0)
            out = P.sharded_weighted_cdf(vb, bins, x["wv"], lt, mesh)
        else:
            bins = d["bins"] if o == "rep" else d["bins_b"][brows]
            out = P.sharded_exact_conditional_integral(vb, bins, x["wv"], lt,
                                                       mesh)
        return {"out": ("b", out)}
    if kind == "lwa":
        fn = P.sharded_local_wave_activity2 if rest == "lwa2" else \
            P.sharded_local_wave_activity
        kw = dict(method="dense") if rest == "dense" else {}
        return {"out": ("x", fn(x["v"], x["Q"], d["w"], _t(LAT), mesh,
                                increase=True, **kw))}
    if kind == "length":
        y, xx = (LAT, LON) if rest == "latlon" else (CART_Y, CART_X)
        return {"out": ("b", P.sharded_contour_lengths(
            x["q"], x["ctr"], _t(y), _t(xx), mesh,
            latlon=rest == "latlon"))}
    if kind == "local":
        window, stride, latlon = next(w for w in WINDOWS
                                      if f"w{w[0]}" == rest)
        y, xx = (LAT, LON) if latlon else (CART_Y, CART_X)
        L = P.sharded_local_lengths(x["field"], _t(y), _t(xx), mesh,
                                    window=window, stride=stride,
                                    latlon=latlon)[0]
        return {"out": ("r", L)}
    if kind == "adjoint":
        out = P.sharded_keff_lwa_pipeline(x["adj"], ll, mesh, N=ADJ_N,
                                          increase=True, lt=True,
                                          lmin="analytic")
        return {"lwa": ("x", out["lwa"]), "nkeff": ("b", out["nkeff"])}
    if kind == "hvp":
        out = P.sharded_keff_lwa_pipeline(x["adj"], ll, mesh, N=HVP_N)
        return {"nkeff": ("b", out["nkeff"] * 1e-6)}
    if kind == "table":
        table = xt.core.Table(values=2.0 * x["Q"], coords=_t(LAT))
        return {"out": ("b", P.replicated_table(table, mesh).values)}
    if kind == "tie":
        return {"out": ("b", P.sharded_contours(x["tie"], N, mesh,
                                                increase=rest == "True"))}
    if rest == "keff_lwa_grdS":         # a supplied grdS, differentiated
        return step_outputs(P.sharded_keff_lwa_pipeline(
            x["tracer"], ll, mesh, x["grdS"], N=N))
    return step_outputs(grad_steps(ll, d["pre_y"])[rest](x["tracer"], mesh))


def whole_shape(kind, shape, sizes):
    """The whole array's shape from a block's."""
    nb, nx = sizes
    if kind == "r":
        return tuple(shape)
    s = list(shape)
    if len(s) >= 3 or kind == "b":
        s[0] *= nb
    if kind == "x":
        s[-1] *= nx
    return tuple(s)


def loss_weights(case, key, shape):
    """r of ``sum(r * out)``: seeded normal draws of the whole output's
    shape."""
    seed = zlib.crc32(f"{case}|{key}".encode())
    return np.random.default_rng(seed).standard_normal(shape)


def block_of(kind, a, mesh):
    """The rank's block of a whole array ``a`` of a kind."""
    if kind == "r":
        return a
    spec = P.shard_batch_spec(mesh, 3 if kind == "b" else a.ndim)
    if kind == "b":
        (nb, _), (ib, _) = spec.sizes, spec.coords
        rows = a.shape[0] // nb
        return a[ib * rows:(ib + 1) * rows]
    return spec.block(a)


def finite_sum(t):
    return torch.nansum(torch.where(torch.isfinite(t), t,
                                    torch.zeros_like(t)))


def rank_loss(case, outs, mesh):
    """The rank's part of ``sum(r * out)`` over a case's outputs: a
    replicated output counted once per mesh."""
    sizes = P.shard_batch_spec(mesh, 3).sizes
    loss = 0.0
    for key, (kind, out) in outs.items():
        r = loss_weights(case, key, whole_shape(kind, out.shape, sizes))
        rb = _t(block_of(kind, r, mesh))
        o = out if kind == "x" else P.once_per_mesh(out, mesh)
        loss = loss + finite_sum(rb * o)
    return loss


def grad_case(case, mesh):
    """(the rank's gradient of each input of ``case``, the output kinds);
    for 'hvp' the Hessian-vector product with seeded v (the gradient's
    block dotted with v's, differentiated again)."""
    whole = grad_inputs()
    x = {k: _t(block_of(kind, whole[k], mesh)).requires_grad_()
         for k, kind in GRAD_CASES[case].items()}
    outs = grad_forward(case, x, mesh)
    loss = rank_loss(case, outs, mesh)
    if case == "hvp":
        g, = torch.autograd.grad(loss, x["adj"], create_graph=True)
        v = _t(block_of("x", loss_weights(case, "v", whole["adj"].shape),
                        mesh))
        loss = torch.sum(g * v)
    grads = torch.autograd.grad(loss, list(x.values()), allow_unused=True)
    return ({k: torch.zeros_like(x[k]) if g is None else g
             for k, g in zip(x, grads)},
            {k: kind for k, (kind, _) in outs.items()})


def _count_applies():
    """Patch every autograd Function the sharded path runs to count its
    applies: {name: count}."""
    from xcontour_tpu_torch import core
    from xcontour_tpu_torch.diagnostics import length, local_length, lwa
    from xcontour_tpu_torch.ops import histogram, stencil
    fns = [core._GradSafeDiv, core._GradSafeDivSq, histogram._WeightedCDF,
           stencil._SquaredGradient, lwa._LWA, length._ContourLengths,
           local_length._LocalLengths, _comm._Sum, _comm._Extremum,
           _comm._Broadcast, _comm._AllGather, _comm._ReduceScatter,
           _comm._Shift, _comm._Keep]
    counts = {}
    for fn in fns:
        def apply(*a, _orig=fn.apply, _name=fn.__name__):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(*a)
        fn.apply = apply
    return counts


def step_calls(mesh):
    """{step: {mode: (collectives run, Functions applied)}} of each
    sharded step on the rank's block of ``tracer``, under torch.no_grad(), in
    grad mode on inputs that need none, and with a gradient (its forward's
    collectives and its backward's apart)."""
    applies = _count_applies()
    ll = grids()[0]
    t = _t(block_of("x", grad_inputs()["tracer"], mesh))
    steps = dict(grad_steps(ll, _t(inputs()["pre_y"])),
                 keff_lwa_auto=lambda q, m: P.sharded_keff_lwa_pipeline(
                     q, ll, m, N=N, with_lwa2=True))
    res = {}
    for name, step in steps.items():
        res[name] = {}
        for mode in ("no_grad", "plain", "grad", "backward"):
            if mode == "backward":
                q = t.clone().requires_grad_()
                loss = rank_loss(f"pipe_{name}", step_outputs(step(q, mesh)),
                                 mesh)
            before, applies_before = dict(_comm.CALLS), dict(applies)
            if mode == "no_grad":
                with torch.no_grad():
                    step(t.clone().requires_grad_(), mesh)
            elif mode == "backward":
                torch.autograd.grad(loss, q)
            else:
                step(t.clone().requires_grad_(mode == "grad"), mesh)
            res[name][mode] = (
                {k: v - before.get(k, 0) for k, v in _comm.CALLS.items()
                 if v != before.get(k, 0)},
                {k: v - applies_before.get(k, 0) for k, v in applies.items()
                 if v != applies_before.get(k, 0)})
    return res


def rank_grads(workdir, spec):
    """Every gradient case on a ``spec`` ('BxX') mesh over the world; saves
    this rank's gradients, its (batch, x) coordinates and the steps'
    collective and Function counts."""
    b, x = (int(s) for s in spec.split("x"))
    assert b * x == dist.get_world_size()
    mesh = P.make_mesh(x_size=x)
    out = {}
    for case in GRAD_CASES:
        grads, kinds = grad_case(case, mesh)
        for k, g in grads.items():
            out[f"{GRAD_CASES[case][k]}|{case}|{k}"] = g.numpy()
    coords = np.array([mesh.get_local_rank("batch"), mesh.get_local_rank("x")])
    np.savez(os.path.join(workdir, f"grad{dist.get_rank()}.npz"),
             coords=coords, **out)
    with open(os.path.join(workdir, f"calls{dist.get_rank()}.json"),
              "w") as f:
        json.dump(step_calls(mesh), f)
