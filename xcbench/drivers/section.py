"""Drive a pipeline entry on device-resident snapshots of a vertical
section (an MITgcm x-z plane with partial cells).

As ``step.py``, on the grid of ``grid.from_xz``: set-up builds the
section's cell centres and open fractions (the field maker's
``section``), the program's grid with the fluid mask hFacC > 0, a ring of
``ring`` distinct times of the field on the device and (``table``) the
A(Z_eq) table once, with the entry's ``increase`` and ``lt``, then calls
the entry on every time of the ring once.  A step is the entry on the next
time of the ring followed by a synchronise (``step.py``'s).  The answer of
a step is the entry's output dict, compared key by key with the cell's
reference chain on the same time (float64), on the reference's own grid
made from the same centres and open fractions.
"""

from __future__ import annotations

import torch

from xcbench import compare, harness
from xcbench.roofline_work import cdf_work, lwa_work

_step = harness.load_module(harness.ROOT / "drivers" / "step.py")
step, release, close = _step.step, _step.release, _step.close

# each kernel's work a launch, from the step's shape and its launch
# parameters
_WORK = {"K2": lambda B, Ny, Nx, p: cdf_work(B, Ny * Nx, p["N"], p["C"]),
         "K3": lambda B, Ny, Nx, p: lwa_work(B, Ny, Nx),
         "K5": lambda B, Ny, Nx, p: lwa_work(B, Ny, Nx)}


def _maker(cfg):
    return harness.load_module(harness.ROOT / "fields"
                               / f"{cfg['field']['maker']}.py")


def setup(ctx) -> dict:
    from xcontour_tpu_torch import core, grid as pgrid
    cfg, cell = ctx.config, ctx.cell
    maker = _maker(cfg)
    z, x, hfac = maker.section(cfg["grid"])
    grid = pgrid.from_xz(z, x, hfac, mask=(hfac > 0).astype("float32"),
                         periodic_x=bool(cfg["grid"]["x"]["periodic"]),
                         device=ctx.device)
    ring = [maker.make(cfg["field"], z, x, hfac, cfg["batch"], ctx.seed, t,
                       ctx.device) for t in range(int(cell["ring"]))]
    kw = dict(cell.get("kwargs", {}))
    if cell.get("table"):
        kw["table"] = core.cal_area_eqCoord_table_hist(
            grid.fluid_mask(), grid.ydef, grid.dA,
            increase=kw.get("increase", True), lt=kw.get("lt", True))
    st = dict(ctx=ctx, z=z, x=x, hfac=hfac, grid=grid, ring=ring, kw=kw,
              entry=harness.resolve(cell["entry"]))
    for t in range(len(ring)):
        step(st, t, False)
    return st


def reference(st, t: int, dtype) -> dict:
    """The cell's reference chain on time ``t`` of the ring, in ``dtype``."""
    ctx = st["ctx"]
    chain = harness.load_module(harness.ROOT / "reference"
                                / f"{ctx.cell['reference']}.py")
    q = st["ring"][t]
    g = chain.xz_grid(st["z"], st["x"], st["hfac"], dtype, q.device)
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
    """Each listed kernel's work a launch in step ``i``: one launch of each
    a step, from B, Ny, Nx and the launch's parameters."""
    B, Ny, Nx = st["ring"][i % len(st["ring"])].shape
    return {K: [_WORK[K](B, Ny, Nx, p)]
            for K, p in st["ctx"].cell.get("kernels", {}).items()}
