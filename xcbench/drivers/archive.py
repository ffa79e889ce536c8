"""Drive the command-line tool over an archive, file to file.

Set-up writes the configuration's field for ``times`` times into a classic
netCDF file under TMPDIR, ``pv(time, level, latitude, longitude)`` float32
with latitude stored descending as ERA5 stores it, then makes one pass.
A step is one pass of ``xcontour_tpu_torch.cli.main`` in this process
(open, stream, label, write) with the cell's ``argv``, each pass into a
file of its own; its answer is that file, read back after the window and
compared with the reference chain on the archive's arrays (made again from
the seed), one time at a time.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from xcbench import compare, harness
from xcbench.reference import core as ref_core


def _field(st, t: int):
    cfg = st["ctx"].config
    maker = harness.load_module(harness.ROOT / "fields"
                                / f"{cfg['field']['maker']}.py")
    return maker.make(cfg["field"], st["lat"], st["lon"], cfg["batch"],
                      st["ctx"].seed, t, st["dev"])


def _write_archive(st, path: str) -> None:
    from scipy.io import netcdf_file
    cfg = st["ctx"].config
    T, B = int(st["ctx"].cell["times"]), int(cfg["batch"])
    lat, lon = st["lat"], st["lon"]
    with netcdf_file(path, "w", version=2) as f:
        f.createDimension("time", T)
        f.createDimension("level", B)
        f.createDimension("latitude", len(lat))
        f.createDimension("longitude", len(lon))
        for name, vals, dt in (("time", np.arange(T), "i4"),
                               ("level", cfg["field"]["levels"], "i4"),
                               ("latitude", lat[::-1], "f4"),
                               ("longitude", lon, "f4")):
            v = f.createVariable(name, dt, (name,))
            v[:] = np.asarray(vals, dt)
        pv = f.createVariable("pv", "f4", ("time", "level", "latitude",
                                           "longitude"))
        for t in range(T):
            pv[t] = _field(st, t).flip(-2).cpu().numpy()


def setup(ctx) -> dict:
    from xcontour_tpu_torch import cli
    lat, lon = harness.coords(ctx.config)
    st = dict(ctx=ctx, lat=lat, lon=lon, dev=ctx.device, cli=cli,
              archive=os.path.join(ctx.tmp, "archive.nc"))
    _write_archive(st, st["archive"])
    st["units"] = int(ctx.cell["times"]) * int(ctx.config["batch"])
    step(st, -1, False)
    return st


def _argv(st, out: str) -> list:
    sub = {"{archive}": st["archive"], "{out}": out}
    argv = [sub.get(a, a) for a in st["ctx"].cell["argv"]]
    if st["dev"].type != "cuda":
        argv += ["--device", "cpu"]
    return argv


def step(st, i: int, traced: bool):
    out = os.path.join(st["ctx"].tmp, f"out_{i}.nc")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        if traced:
            with torch.profiler.record_function("xcbench.pass"):
                rc = st["cli"].main(_argv(st, out))
        else:
            rc = st["cli"].main(_argv(st, out))
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return out, st["units"]


def release(st) -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _read(path: str) -> dict:
    """The variables of an output file, each (time * level, ...), its
    ``levels`` under the reference's name ``contour``."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        out = {}
        for name, v in f.variables.items():
            if v.dimensions[:2] == ("time", "level"):
                a = np.array(v[:], dtype=np.float64)
                out[name] = torch.as_tensor(a.reshape(-1, *a.shape[2:]))
    out["contour"] = out.pop("levels")
    return out


def reference(st, dtype) -> dict:
    """The cell's reference chain on every time of the archive, in
    ``dtype``, stacked to (time * level, ...)."""
    ctx = st["ctx"]
    chain = harness.load_module(harness.ROOT / "reference"
                                / f"{ctx.cell['reference']}.py")
    g = ref_core.latlon_grid(st["lat"], st["lon"], dtype, st["dev"])
    parts = [chain.run(_field(st, t).to(dtype), g,
                       **ctx.cell.get("reference_kwargs", {}))
             for t in range(int(ctx.cell["times"]))]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def check(st, kept, dtype=None) -> list:
    """One reading a kept pass: each compared key's gap, the file read
    back against the float64 reference; with ``dtype`` the reference in
    that precision stands in for the program (the control)."""
    want = reference(st, torch.float64)
    spec = st["ctx"].cell["compare"]
    if dtype is not None:
        return [compare.gaps(reference(st, dtype), want, spec)]
    return [compare.gaps({k: v.to(want["contour"].device) for k, v in
                          _read(path).items()}, want, spec)
            for _, path in kept]


def work(st, i: int) -> dict:
    return {}


def close(st) -> None:
    st.clear()
