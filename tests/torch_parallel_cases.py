"""Rank-side cases of tests/test_torch_parallel.py (``rank_cases``) and
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
