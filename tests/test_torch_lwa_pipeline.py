"""The port's ``lwa_pipeline`` (and ``keff_lwa_pipeline(with_lwa2=True)``)
on the CPU against the JAX pipelines on the CPU, on the same numpy inputs:
global synthetic PV on a latitude-longitude grid, and the LAPE
configuration (buoyancy of ``synth_internalwave`` on the MITgcm x-z plane
``from_xz`` with its fluid mask, increase=False, lt=False).

Every output key is compared, NaN patterns included, with the tolerances
of ``test_torch_pipeline`` (float64 1e-10 of each key's maximum; float32
2e-5 for the sorted state, 1.5e-4 for lwa, 5e-5 for lwa2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.utils.synth import synth_internalwave
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.kernels import lwa

from test_torch_pipeline import _compare, _inputs

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def _lape_inputs(nt=2, nz=30, nx=64):
    """ex3's LAPE set-up at a few tens of rows: buoyancy from a linear EOS,
    NaN over rock, on the partial-cell x-z plane."""
    v, _ = synth_internalwave(nt=nt, nz=nz, nx=nx)
    T = np.where(v["maskC"][None] > 0, v["THETA"], np.nan)
    b = 2e-4 * (T.astype(np.float64) - 20.0) * 9.81
    return v, b


def _grids(kind, dt, masked=False):
    jdt, tdt = DTYPES[dt]
    if kind == "lape":
        v, b = _lape_inputs()
        args = (v["Z"], v["XC"], v["hFacC"])
        jg = jgrid.from_xz(*args, mask=v["maskC"], dtype=jdt)
        tg = xt.from_xz(*args, mask=v["maskC"], dtype=tdt, device=CPU)
        return b, jg, tg, v["maskC"]
    lat, lon, q, mask = _inputs(masked=masked)
    return (q, jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt),
            xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU), mask)


CASES = [
    # kind, part, metric, lwa_method, dtype, increase, lt, mask passed
    ("pv", "all", "dA", "auto", "f64", True, True, False),
    ("pv", "upper", "dy", "dense", "f64", True, True, False),
    ("pv", "all", "dy", "dense", "f64", True, True, True),
    ("pv", "upper", "dA", "auto", "f64", True, True, True),
    ("pv", "all", "dA", "auto", "f64", False, False, False),
    ("pv", "all", "dy", "auto", "f32", True, True, False),
    ("pv", "upper", "dA", "dense", "f32", True, True, True),
    ("lape", "all", "dA", "auto", "f64", False, False, True),
    ("lape", "all", "dy", "dense", "f64", False, False, True),
    ("lape", "all", "dA", "auto", "f32", False, False, True),
]


@pytest.mark.parametrize("kind,part,metric,method,dt,increase,lt,pass_mask",
                         CASES)
def test_lwa_pipeline_matches_jax(kind, part, metric, method, dt, increase,
                                  lt, pass_mask):
    jdt, tdt = DTYPES[dt]
    q, jg, tg, mask = _grids(kind, dt, masked=pass_mask)
    kw = dict(N=33, increase=increase, lt=lt, part=part, metric=metric,
              lwa_method=method)
    want = jpipe.lwa_pipeline(
        jnp.asarray(q, jdt), jg,
        None if not pass_mask else jnp.asarray(mask, jdt), **kw)
    got = xt.lwa_pipeline(
        torch.as_tensor(q).to(tdt), tg,
        None if not pass_mask else torch.as_tensor(mask).to(tdt), **kw)
    _compare(got, want, dt)


def test_lape_is_positive_definite():
    """ex3's check on the port: -lwa >= -5e-5 of its maximum (the float32
    'lin' floor), at ex3's own grid (100x448, 3 snapshots)."""
    v, b = _lape_inputs(nt=3, nz=100, nx=448)
    grid = xt.from_xz(v["Z"], v["XC"], v["hFacC"], mask=v["maskC"], device=CPU)
    out = xt.lwa_pipeline(torch.as_tensor(b, dtype=torch.float32), grid,
                          torch.as_tensor(v["maskC"]), N=121, increase=False,
                          lt=False)
    lape = -out["lwa"].numpy()
    assert np.isfinite(lape).all() and lape.shape == b.shape
    assert lape.min() > -5e-5 * lape.max()


def test_table_reuse_and_carried_table():
    lat, lon, q, mask = _inputs(masked=True, seed=5)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    jt = jcore.cal_area_eqCoord_table_hist(jg.fluid_mask(jnp.float64),
                                           jg.ydef, jg.dA, increase=True,
                                           lt=True)
    tt = xt.cal_area_eqCoord_table_hist(tg.fluid_mask(torch.float64),
                                        tg.ydef, tg.dA, increase=True,
                                        lt=True)
    carried = xt.Table.from_numpy(np.asarray(jt.values), np.asarray(jt.coords),
                                  device=CPU)
    want = jpipe.lwa_pipeline(jnp.asarray(q), jg, N=33, metric="dy",
                              table=jt)
    for table in (tt, carried, None):
        _compare(xt.lwa_pipeline(torch.as_tensor(q), tg, N=33, metric="dy",
                                 table=table), want, "f64")


@pytest.mark.parametrize("method,dt,with_pre_y", [
    ("auto", "f64", True), ("dense", "f64", False), ("auto", "f32", False)])
def test_keff_lwa_pipeline_with_lwa2_matches_jax(method, dt, with_pre_y):
    jdt, tdt = DTYPES[dt]
    lat, lon, q, mask = _inputs(masked=True, seed=6)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU)
    pre_y = np.linspace(-70.0, 70.0, 15) if with_pre_y else None
    kw = dict(N=33, lmin="dxF", metric="dy", lwa_method=method,
              with_lwa2=True)
    want = jpipe.keff_lwa_pipeline(
        jnp.asarray(q, jdt), jg,
        pre_y=None if pre_y is None else jnp.asarray(pre_y, jdt), **kw)
    got = xt.keff_lwa_pipeline(
        torch.as_tensor(q).to(tdt), tg,
        pre_y=None if pre_y is None else torch.as_tensor(pre_y), **kw)
    assert "lwa2" in got
    _compare(got, want, dt)


def test_lwa_pipeline_rejects_unknown_modes_and_launches_nothing_on_cpu():
    lat, lon, q, _ = _inputs(nlat=16, nlon=32)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="metric"):
        xt.lwa_pipeline(torch.as_tensor(q), tg, N=9, metric="dz")
    with pytest.raises(ValueError, match="part='all'"):
        xt.lwa_pipeline(torch.as_tensor(q), tg, N=9, lwa_method="fast",
                        part="upper")
    with pytest.raises(ValueError, match="part='all'"):
        xt.lwa_pipeline(torch.as_tensor(q), tg, N=9, lwa_method="lin",
                        part="upper")
    records = [lwa.KERNEL_LIN, lwa.KERNEL_LIN2, lwa.KERNEL_DENSE,
               lwa.KERNEL_DENSE_TALL]
    before = [r.launches for r in records]
    for method in ("auto", "dense", "fast"):
        out = xt.lwa_pipeline(torch.as_tensor(q).float(),
                              xt.from_latlon(lat, lon, device=CPU), N=9,
                              lwa_method=method)
        assert out["lwa2"].shape == q.shape
    assert [r.launches for r in records] == before
