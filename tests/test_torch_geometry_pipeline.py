"""The geometry slice end to end: the contour means, ``clength_pipeline``
and ``fractal_pipeline`` of the port on the CPU against the JAX package's
on the same numpy inputs (a small ``synth_pv``).

Every output key is compared, NaN patterns included.  Tolerances, relative
to each key's largest magnitude: float64 1e-10 (summation order only);
float32 2e-5 for the sorted state, lengths and rulers; 1e-4 for the keys
that difference CDFs along the contour index (Leq2, cmGrd, cmInvGrd), as
``test_torch_pipeline`` bounds Leq2; 1e-3 for nkeff = Leq2 / Lmin^2, whose
Lmin ~ cos(Yeq) amplifies the area noise near the poles (2.8e-4 measured
on these inputs); 5e-4 for D and D_bc, least-squares slopes of the logs of
three lengths, where the shortest contours' relative error counts in full
(9e-5 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.utils.synth import synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.kernels import length as k78

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

F32_TOL = dict(Leq2=1e-4, nkeff=1e-3, cmGrd=1e-4, cmInvGrd=1e-4, D=5e-4,
               D_bc=5e-4)


def _inputs(nlat=64, nlon=128, seed=1):
    v, _ = synth_pv(nlev=2, nlat=nlat, nlon=nlon, seed=seed)
    q = v["pv"].astype(np.float64)
    q[0, 2:5, 10:20] = np.nan                 # a below-ground patch
    return (v["latitude"].astype(np.float64),
            v["longitude"].astype(np.float64), q)


def _compare(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy()
        b = np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        m = np.isfinite(b)
        assert np.array_equal(m, np.isfinite(a)), k
        tol = 1e-10 if dtype == "f64" else F32_TOL.get(k, 2e-5)
        scale = np.abs(b[m]).max() if m.any() else 1.0
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=tol * scale,
                                   err_msg=k)


def _dtypes(dt):
    return (jnp.float64, torch.float64) if dt == "f64" else \
        (jnp.float32, torch.float32)


@pytest.mark.parametrize("hist", [True, False])
def test_contour_means_match_jax(hist):
    lat, lon, q = _inputs(nlat=32, nlon=48)
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jctr = jcore.cal_contours(jq, 17)
    tctr = xt.cal_contours(tq, 17)
    rng = np.random.default_rng(3)
    f = rng.uniform(0.5, 2.0, q.shape[-2:])
    grdm = rng.uniform(0.1, 1.0, q.shape)
    sfx = "_hist" if hist else ""
    jmean = getattr(jcore, "cal_contour_mean" + sfx)
    tmean = getattr(xt, "cal_contour_mean" + sfx)
    jweigh = getattr(jcore, "cal_contour_weigh_mean" + sfx)
    tweigh = getattr(xt, "cal_contour_weigh_mean" + sfx)
    jarea = jcore.cal_integral_within_contours_hist(jq, jctr, jg.dA, lt=True)
    tarea = xt.cal_integral_within_contours_hist(tq, tctr, tg.dA, lt=True)
    for area in ((None, None), (jarea, tarea)):
        want = {"mean": jmean(jq, jctr, jg.dA, jnp.asarray(f), jnp.asarray(grdm),
                              area[0], lt=True),
                "weigh": jweigh(jq, jctr, jg.dA, jnp.asarray(f), area[0],
                                lt=True)}
        got = {"mean": tmean(tq, tctr, tg.dA, torch.as_tensor(f),
                             torch.as_tensor(grdm), area[1], lt=True),
               "weigh": tweigh(tq, tctr, tg.dA, torch.as_tensor(f), area[1],
                               lt=True)}
        _compare(got, want, "f64")


CLENGTH_CASES = [
    # dtype, masked, increase, lt
    ("f64", False, True, True),
    ("f64", True, False, False),
    ("f32", False, True, True),
    ("f32", True, True, True),
]


@pytest.mark.parametrize("dt,masked,increase,lt", CLENGTH_CASES)
def test_clength_pipeline_matches_jax(dt, masked, increase, lt):
    jdt, tdt = _dtypes(dt)
    lat, lon, q = _inputs()
    mask = None
    if masked:
        mask = np.ones(q.shape[-2:])
        mask[16:30, 40:60] = 0.0
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU)
    kw = dict(N=31, increase=increase, lt=lt)
    want = jpipe.clength_pipeline(jnp.asarray(q, jdt), jg, **kw)
    got = xt.clength_pipeline(torch.as_tensor(q).to(tdt), tg, **kw)
    _compare(got, want, dt)
    assert np.isnan(got["lengths"].numpy()[:, [0, -1]]).all()


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_fractal_pipeline_matches_jax(dt):
    jdt, tdt = _dtypes(dt)
    lat, lon, q = _inputs()
    jg = jgrid.from_latlon(lat, lon, dtype=jdt)
    tg = xt.from_latlon(lat, lon, dtype=tdt, device=CPU)
    kw = dict(N=31, strides=(1, 2, 4))
    want = jpipe.fractal_pipeline(jnp.asarray(q, jdt), jg, **kw)
    got = xt.fractal_pipeline(torch.as_tensor(q).to(tdt), tg, **kw)
    _compare(got, want, dt)
    assert got["lengths"].shape == (2, 31, 3)


def test_geometry_pipelines_reuse_a_table_and_launch_no_kernel_on_cpu():
    records = [k78.KERNEL_LENGTHS, k78.KERNEL_LOCAL_LENGTHS]
    for r in records:
        r.launches = 0
    lat, lon, q = _inputs(nlat=32, nlon=64)
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    jt = jcore.cal_area_eqCoord_table_hist(jg.fluid_mask(jnp.float64), jg.ydef,
                                           jg.dA, increase=True, lt=True)
    carried = xt.Table.from_numpy(np.asarray(jt.values), np.asarray(jt.coords),
                                  device=CPU)
    tq = torch.as_tensor(q)
    _compare(xt.clength_pipeline(tq, tg, N=17, table=carried),
             jpipe.clength_pipeline(jnp.asarray(q), jg, N=17, table=jt), "f64")
    _compare(xt.fractal_pipeline(tq, tg, N=17, strides=(1, 2), table=carried,
                                 box_counting=False),
             jpipe.fractal_pipeline(jnp.asarray(q), jg, N=17, strides=(1, 2),
                                    table=jt, box_counting=False), "f64")
    xt.local_contour_lengths(tq[0], tg.ydef, tg.xdef, window=9, stride=8)
    assert [r.launches for r in records] == [0, 0]
