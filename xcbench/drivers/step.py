"""Drive a pipeline entry on device-resident snapshots.

Set-up builds the program's grid, a ring of ``ring`` distinct times of the
configuration's field on the device, and (``table``) the A(Y_eq) table
once, then calls the entry on every time of the ring once.  A step is the
entry on the next time of the ring followed by a synchronise: a closed
loop with one caller, as ``runner.run_batched`` synchronises once a chunk.
The answer of a step is the entry's output dict, compared key by key with
the cell's reference chain on the same time (float64).
"""

from __future__ import annotations

import inspect

import torch

from xcbench import compare, harness
from xcbench.reference import core as ref_core


def setup(ctx) -> dict:
    from xcontour_tpu_torch import core, grid as pgrid
    cfg, cell = ctx.config, ctx.cell
    lat, lon = harness.coords(cfg)
    grid = pgrid.from_latlon(lat, lon, device=ctx.device)
    maker = harness.load_module(harness.ROOT / "fields"
                                / f"{cfg['field']['maker']}.py")
    ring = [maker.make(cfg["field"], lat, lon, cfg["batch"], ctx.seed, t,
                       ctx.device) for t in range(int(cell["ring"]))]
    kw = dict(cell.get("kwargs", {}))
    if cell.get("table"):
        kw["table"] = core.cal_area_eqCoord_table_hist(
            grid.fluid_mask(), grid.ydef, grid.dA,
            increase=kw.get("increase", True), lt=kw.get("lt", True))
    st = dict(ctx=ctx, lat=lat, lon=lon, grid=grid, ring=ring, kw=kw,
              entry=harness.resolve(cell["entry"]), work={})
    for t in range(len(ring)):
        step(st, t, False)
    return st


def step(st, i: int, traced: bool):
    q = st["ring"][i % len(st["ring"])]
    dev = q.device
    if traced:
        with torch.profiler.record_function("xcbench.step"):
            out = st["entry"](q, st["grid"], **st["kw"])
        with torch.profiler.record_function("xcbench.sync"):
            harness.sync(dev)
    else:
        out = st["entry"](q, st["grid"], **st["kw"])
        harness.sync(dev)
    return out, q.shape[0]


def release(st) -> None:
    """Drop the program's state that no check needs."""
    st.pop("grid", None)
    st["kw"] = {}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(st, t: int, dtype) -> dict:
    """The cell's reference chain on time ``t`` of the ring, in ``dtype``."""
    ctx = st["ctx"]
    chain = harness.load_module(harness.ROOT / "reference"
                                / f"{ctx.cell['reference']}.py")
    q = st["ring"][t]
    g = ref_core.latlon_grid(st["lat"], st["lon"], dtype, q.device)
    return chain.run(q.to(dtype), g, **ctx.cell.get("reference_kwargs", {}))


def check(st, kept, dtype=None) -> list:
    """One reading a kept answer: each compared key's gap to the float64
    reference; with ``dtype`` the reference in that precision stands in
    for the program (the control)."""
    spec = st["ctx"].cell["compare"]
    cache, out = {}, []
    R = len(st["ring"])
    for i, ans in kept:
        t = i % R
        if t not in cache:
            cache[t] = reference(st, t, torch.float64)
        got = ans if dtype is None else reference(st, t, dtype)
        out.append(compare.gaps(got, cache[t], spec))
    return out


def work(st, i: int) -> dict:
    """Each listed kernel's work a launch in step ``i``, by the function
    its ``kernels/<K>.json`` names, given the quantities it asks for:
    B, Ny, Nx, G, the launch's N and C, the snapshots q, the reference's
    levels, the coordinates yc and xc (radians) and latlon; a launch per
    stride (block means of q and of the coordinates) where the cell lists
    strides."""
    t = i % len(st["ring"])
    if t not in st["work"]:
        st["work"][t] = _work(st, st["ring"][t])
    return st["work"][t]


def _work(st, q) -> dict:
    specs = harness.kernel_specs()
    lat = torch.as_tensor(st["lat"], dtype=torch.float32, device=q.device)
    lon = torch.as_tensor(st["lon"], dtype=torch.float32, device=q.device)
    out = {}
    for K, launch in st["ctx"].cell.get("kernels", {}).items():
        fn = harness.resolve(specs[K]["work"])
        params = inspect.signature(fn).parameters
        ws = []
        for s in launch.get("strides", [1]):
            qs = ref_core.block_mean(q, s)
            have = dict(B=q.shape[0], Ny=qs.shape[-2], Nx=qs.shape[-1],
                        G=qs.shape[-2] * qs.shape[-1], latlon=True, q=qs,
                        yc=torch.deg2rad(lat if s == 1 else
                                         lat.reshape(-1, s).mean(1)),
                        xc=torch.deg2rad(lon if s == 1 else
                                         lon.reshape(-1, s).mean(1)))
            have.update({k: v for k, v in launch.items() if k != "strides"})
            if "levels" in params:
                have["levels"] = ref_core.levels(q.double(),
                                                 launch["N"]).float()
            ws.append(fn(**{k: have[k] for k in params if k in have}))
        out[K] = ws
    return out


def close(st) -> None:
    st.clear()
