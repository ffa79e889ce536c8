"""The port's ``keff_pipeline`` and its broadcast paths
(``cal_integral_within_contours``, ``cal_area_eqCoord_table``) on the CPU
against the JAX package on the CPU, on the same numpy inputs.

Every output key of the ``origin`` and ``interp`` sections is compared,
NaN patterns included: float64 to 1e-10 of each key's maximum; float32
with the bounds of ``test_torch_pipeline`` (2e-5 for the sorted state,
1e-4 for keys that difference CDFs along the contour index: dgrdSdA, dqdA,
Leq2 and nkeff), except nkeff on the broadcast path (below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import core as jcore
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
import xcontour_tpu_torch as xt

from test_torch_pipeline import F32_TOL, _compare, _inputs

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


# the broadcast path's float32 table is ~20x noisier than the histogram
# one (1.4e-6 against 6.6e-8 of the total area, JAX and port alike), and
# nkeff = Leq2 / Lmin^2 amplifies a Yeq error near the poles, where
# Lmin ~ cos(Yeq): on case (False, 'analytic', f32) the JAX package's own
# float32 nkeff is 5.3e-4 (nkeff_at 1.1e-4) of the maximum off its float64
# value, and the port 5.1e-4 (1.1e-4) off the JAX float32 value
BROADCAST_F32_TOL = dict(F32_TOL, nkeff=1e-3, nkeff_at=1e-3)


def _flat(out):
    """origin keys as they are, interp keys with an ``_at`` suffix."""
    flat = dict(out["origin"])
    flat.update({k + "_at": v for k, v in out.get("interp", {}).items()})
    return flat


CASES = [
    # hist, lmin, masked, dtype, pre_y, increase, lt, nkeff_mask
    (True, "dxF", False, "f64", True, True, True, 2e7),
    (False, "dxF", True, "f64", False, True, True, 2e7),
    (True, "analytic", True, "f64", False, True, True, 1e5),
    (False, "frac", False, "f64", True, True, True, 2e7),
    (True, "frac", True, "f64", False, False, False, 2e7),
    (False, "analytic", False, "f64", False, False, True, 2e7),
    (True, "dxF", True, "f32", True, True, True, 2e7),
    (False, "analytic", False, "f32", True, True, True, 2e7),
]


@pytest.mark.parametrize("hist,lmin,masked,dt,with_pre_y,increase,lt,nkm",
                         CASES)
def test_keff_pipeline_matches_jax(hist, lmin, masked, dt, with_pre_y,
                                   increase, lt, nkm):
    jdt, tdt = DTYPES[dt]
    lat, lon, q, mask = _inputs(masked=masked, seed=7)
    pre_y = np.linspace(-70.0, 70.0, 15) if with_pre_y else None
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU)
    kw = dict(N=33, hist=hist, lmin=lmin, increase=increase, lt=lt,
              nkeff_mask=nkm)
    want = jpipe.keff_pipeline(
        jnp.asarray(q, jdt), jg,
        pre_y=None if pre_y is None else jnp.asarray(pre_y, jdt), **kw)
    got = xt.keff_pipeline(
        torch.as_tensor(q).to(tdt), tg,
        pre_y=None if pre_y is None else torch.as_tensor(pre_y), **kw)
    assert set(got) == set(want)
    _compare(_flat(got), _flat(want), dt,
             F32_TOL if hist else BROADCAST_F32_TOL)


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("increase", [True, False])
def test_broadcast_table_and_integrals_match_jax(increase, lt):
    """Both coordinate directions, a NaN patch and a land mask; the
    integrand path includes NaN integrand cells."""
    lat, lon, q, mask = _inputs(masked=True, seed=8)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    for flip in (False, True):
        ydef = np.array(jg.ydef)[::-1].copy() if flip else np.array(jg.ydef)
        dA = np.array(jg.dA)
        want = jcore.cal_area_eqCoord_table(jnp.asarray(mask), jnp.asarray(ydef),
                                            jnp.asarray(dA), increase=increase,
                                            lt=lt)
        got = xt.cal_area_eqCoord_table(torch.as_tensor(mask),
                                        torch.as_tensor(ydef),
                                        torch.as_tensor(dA), increase=increase,
                                        lt=lt)
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                                   rtol=1e-12)
    ctr = np.array(jcore.cal_contours(jnp.asarray(q), 21, increase=increase))
    grdS = np.abs(q) * 1e3
    grdS[1, 5, 6] = np.nan
    for integrand in (None, grdS):
        want = jcore.cal_integral_within_contours(
            jnp.asarray(q), jnp.asarray(ctr), jnp.asarray(dA),
            None if integrand is None else jnp.asarray(integrand), lt=lt)
        got = xt.cal_integral_within_contours(
            torch.as_tensor(q), torch.as_tensor(ctr), torch.as_tensor(dA),
            None if integrand is None else torch.as_tensor(integrand), lt=lt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(want).max()))


def test_keff_pipeline_takes_a_table_and_rejects_unknown_lmin():
    lat, lon, q, mask = _inputs(masked=True, seed=9)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    jt = jcore.cal_area_eqCoord_table(jg.fluid_mask(jnp.float64), jg.ydef,
                                      jg.dA, increase=True, lt=True)
    want = jpipe.keff_pipeline(jnp.asarray(q), jg, N=33, hist=False, table=jt)
    carried = xt.Table.from_numpy(np.asarray(jt.values), np.asarray(jt.coords),
                                  device=CPU)
    _compare(_flat(xt.keff_pipeline(torch.as_tensor(q), tg, N=33, hist=False,
                                    table=carried)), _flat(want), "f64")
    with pytest.raises(ValueError, match="lmin"):
        xt.keff_pipeline(torch.as_tensor(q), tg, N=9, lmin="exact")
