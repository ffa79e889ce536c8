"""The slice end to end: the port's ``keff_lwa_pipeline`` on the CPU against
the JAX ``keff_lwa_pipeline`` on the CPU, on the same numpy inputs.

Every output key is compared, NaN patterns included.  Tolerances, relative
to each key's largest magnitude: float64 1e-10 (summation order only);
float32 2e-5 for the sorted state (contours, areas, Yeq, Lmin, Q), 1e-4 for
Leq2 and nkeff (differences of CDFs along the contour index amplify the
order-of-summation noise), and the 'lin' floors 1.5e-4 for lwa and 5e-5 for
lwa2 (``test_torch_lwa2``).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.utils.synth import synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import kernels
from xcontour_tpu_torch.kernels import hist, lwa, stencil

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(Leq2=1e-4, nkeff=1e-4, lwa=1.5e-4, Leq2_at=1e-4, nkeff_at=1e-4,
               lwa2=5e-5, dgrdSdA=1e-4, dqdA=1e-4, dgrdSdA_at=1e-4,
               dqdA_at=1e-4)


def _inputs(nlat=40, nlon=64, masked=False, seed=1):
    v, _ = synth_pv(nlev=3, nlat=nlat, nlon=nlon, seed=seed)
    lat = v["latitude"].astype(np.float64)
    lon = v["longitude"].astype(np.float64)
    q = v["pv"].astype(np.float64)
    q[0, 2:5, 10:20] = np.nan                 # a below-ground patch
    mask = None
    if masked:
        mask = np.ones((nlat, nlon))
        mask[nlat // 4: nlat // 2, nlon // 3: nlon // 2] = 0.0
    return lat, lon, q, mask


def _compare(got, want, dtype, f32_tol=F32_TOL):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy()
        b = np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        m = np.isfinite(b)
        assert np.array_equal(m, np.isfinite(a)), k
        tol = 1e-10 if dtype == "f64" else f32_tol.get(k, 2e-5)
        scale = np.abs(b[m]).max() if m.any() else 1.0
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=tol * scale,
                                   err_msg=k)


CASES = [
    # lmin, metric, lwa_method, masked, dtype, pre_y, increase, lt
    ("analytic", "dA", "auto", False, "f64", False, True, True),
    ("dxF", "dy", "dense", True, "f64", True, True, True),
    ("frac", "dA", "dense", True, "f64", False, True, True),
    ("frac", "dy", "auto", False, "f64", True, True, True),
    ("analytic", "dA", "auto", False, "f64", False, False, False),
    ("dxF", "dA", "dense", False, "f64", False, True, False),
    ("analytic", "dy", "auto", False, "f32", True, True, True),
    ("dxF", "dA", "dense", True, "f32", False, True, True),
]


@pytest.mark.parametrize(
    "lmin,metric,method,masked,dt,with_pre_y,increase,lt", CASES)
def test_pipeline_matches_jax(lmin, metric, method, masked, dt, with_pre_y,
                              increase, lt):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else \
        (jnp.float32, torch.float32)
    lat, lon, q, mask = _inputs(masked=masked)
    pre_y = np.linspace(-70.0, 70.0, 15) if with_pre_y else None
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU)
    kw = dict(N=33, lmin=lmin, metric=metric, lwa_method=method,
              increase=increase, lt=lt)
    want = jpipe.keff_lwa_pipeline(
        jnp.asarray(q, jdt), jg,
        pre_y=None if pre_y is None else jnp.asarray(pre_y, jdt), **kw)
    got = xt.keff_lwa_pipeline(
        torch.as_tensor(q).to(tdt), tg,
        pre_y=None if pre_y is None else torch.as_tensor(pre_y), **kw)
    _compare(got, want, dt)


def test_table_reuse_and_carried_table():
    lat, lon, q, mask = _inputs(masked=True, seed=4)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    jt = jcore.cal_area_eqCoord_table_hist(jg.fluid_mask(jnp.float64), jg.ydef,
                                           jg.dA, increase=True, lt=True)
    tt = xt.cal_area_eqCoord_table_hist(tg.fluid_mask(torch.float64), tg.ydef,
                                        tg.dA, increase=True, lt=True)
    np.testing.assert_allclose(tt.values.numpy(), np.asarray(jt.values),
                               rtol=1e-13)
    carried = xt.Table.from_numpy(np.asarray(jt.values), np.asarray(jt.coords),
                                  device=CPU)
    want = jpipe.keff_lwa_pipeline(jnp.asarray(q), jg, N=33, table=jt)
    for table in (tt, carried, None):
        _compare(xt.keff_lwa_pipeline(torch.as_tensor(q), tg, N=33,
                                      table=table), want, "f64")
    # lookup_values works (the reference's typo is fixed in both packages)
    ys = np.linspace(-60.0, 60.0, 9)
    np.testing.assert_allclose(tt.lookup_values(torch.as_tensor(ys)).numpy(),
                               np.asarray(jt.lookup_values(jnp.asarray(ys))),
                               rtol=1e-12)


def test_mixed_direction_table_raises():
    vals = torch.tensor([[0.0, 1.0, 2.0], [2.0, 1.0, 0.0]])
    table = xt.Table(values=vals, coords=torch.tensor([-1.0, 0.0, 1.0]))
    with pytest.raises(ValueError, match="mixed-direction"):
        table.lookup_coordinates(torch.tensor([[0.5], [0.5]]))


def test_unported_options_raise():
    lat, lon, q, _ = _inputs(nlat=16, nlon=32)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    out = xt.keff_lwa_pipeline(torch.as_tensor(q), tg, N=9, with_lwa2=True)
    assert out["lwa2"].shape == q.shape
    out = xt.keff_lwa_pipeline(torch.as_tensor(q), tg, N=9, with_lwa2=True,
                               lwa_method="fast")
    assert out["lwa"].shape == out["lwa2"].shape == q.shape
    with pytest.raises(ValueError, match="not in"):
        xt.keff_lwa_pipeline(torch.as_tensor(q), tg, N=9, lwa_method="sorted")
    with pytest.raises(ValueError, match="lmin"):
        xt.keff_lwa_pipeline(torch.as_tensor(q), tg, N=9, lmin="exact")


def test_cpu_tensors_launch_no_kernel():
    records = [stencil.KERNEL, hist.KERNEL, lwa.KERNEL_LIN, lwa.KERNEL_DENSE,
               lwa.KERNEL_LIN2, lwa.KERNEL_DENSE_TALL]
    assert all(isinstance(r, kernels.Kernel) for r in records)
    for r in records:
        r.launches = 0
    lat, lon, q, _ = _inputs(nlat=24, nlon=48)
    tg = xt.from_latlon(lat, lon, dtype=torch.float32, device=CPU)
    for method in ("auto", "dense", "fast"):
        out = xt.keff_lwa_pipeline(torch.as_tensor(q).float(), tg, N=17,
                                   lwa_method=method, with_lwa2=True)
        assert out["lwa"].shape == out["lwa2"].shape == q.shape
    assert [r.launches for r in records] == [0] * len(records)


def test_package_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules['jax'] = None
        sys.modules['xcontour_tpu'] = None
        import xcontour_tpu_torch
        for m in pkgutil.walk_packages(xcontour_tpu_torch.__path__,
                                       'xcontour_tpu_torch.'):
            importlib.import_module(m.name)
        assert not any(k == 'jax' or k.startswith('jax.')
                       for k, v in sys.modules.items() if v is not None)
        print('ok')
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
