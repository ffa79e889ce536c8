"""K1 (|grad q|^2 stencil): the port's plain version and ops layer against
the JAX package's XLA twin and its Pallas kernel in interpret mode.

Tolerances: the plain version multiplies by precomputed reciprocals like the
Pallas kernel, so against the kernel it agrees to the last bit (asserted at
rtol 1e-15 / 1e-7 to allow an FMA in XLA's CPU code); the XLA twin divides,
so against it the bound is a few ulp (rtol 1e-14 in float64, 1e-6 in
float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import grid as jgrid
from xcontour_tpu.kernels.stencil_pallas import squared_gradient_pallas
from xcontour_tpu.ops import stencil as jst
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.kernels import stencil as k1
from xcontour_tpu_torch.ops import stencil as tst

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

CASES = [(p, bc) for p in (True, False) for bc in ("extend", "fill", "reflect")]
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-14, 1e-15),
          "f32": (jnp.float32, torch.float32, 1e-6, 1e-7)}


def _field(seed, B=3, Ny=40, Nx=64, row1_nan=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx)).cumsum(-1).cumsum(-2)
    q[1, 5:8, 10:13] = np.nan
    if row1_nan:      # the 'reflect' walls follow row 1 (the XLA form)
        q[2, 1, 20] = np.nan
    dy = rng.uniform(0.5, 2.0, Ny)
    dx = rng.uniform(0.5, 2.0, (Ny, Nx))
    return q, dy, dx


def _close(got, want, rtol):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    scale = np.abs(want[m]).max()
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("periodic,bc", CASES)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_plain_matches_xla_twin(periodic, bc, dt):
    jdt, tdt, rtol, _ = DTYPES[dt]
    q, dy, dx = _field(1, row1_nan=True)
    want = jst._squared_gradient_xla(jnp.asarray(q, jdt), jnp.asarray(dy, jdt),
                                     jnp.asarray(dx, jdt), periodic_x=periodic,
                                     bc_y=bc)
    qt, dyt, dxt = (torch.as_tensor(a).to(tdt) for a in (q, dy, dx))
    got = k1.squared_gradient_plain(qt, 1.0 / dxt, 1.0 / dyt,
                                    periodic_x=periodic, bc_y=bc)
    _close(got.numpy(), want, rtol)


@pytest.mark.parametrize("periodic,bc", CASES)
def test_plain_matches_pallas_interpret(periodic, bc):
    jdt, tdt, _, rtol = DTYPES["f64"]
    q, dy, dx = _field(2, B=2, Ny=16, Nx=128)
    want = squared_gradient_pallas(jnp.asarray(q, jdt), jnp.asarray(dx, jdt),
                                   jnp.asarray(dy, jdt)[:, None],
                                   periodic_x=periodic, bc_y=bc,
                                   interpret=True)
    qt, dyt, dxt = (torch.as_tensor(a).to(tdt) for a in (q, dy, dx))
    got = k1.squared_gradient(qt, 1.0 / dxt, 1.0 / dyt, periodic_x=periodic,
                              bc_y=bc)
    _close(got.numpy(), want, rtol)


@pytest.mark.parametrize("bc", ["extend", "fill", "reflect"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_ops_squared_gradient_and_gradient_on_a_polar_grid(bc, dt):
    """The ERA-like grid includes the poles: the spacings are computed in the
    tracer's dtype, so in float32 cos(+-90 deg) is tiny but not zero and the
    pole rows are huge but finite — in both packages alike."""
    jdt, tdt, rtol, _ = DTYPES[dt]
    lat = np.linspace(-90.0, 90.0, 37)
    lon = np.linspace(0.0, 350.0, 36)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 37, 36)).cumsum(-2)
    jg = jgrid.from_latlon(lat, lon, dtype=jdt, bc_y=bc)
    tg = xt.from_latlon(lat, lon, dtype=tdt, bc_y=bc, device=CPU)
    want = jst.squared_gradient(jnp.asarray(q, jdt), jg)
    got = tst.squared_gradient(torch.as_tensor(q).to(tdt), tg)
    if dt == "f32":
        assert np.isfinite(got.numpy()).all()
        # the pole rows carry 1/cos(90 deg) ~ 1e7-scale factors; compare
        # them on their own scale, the interior on its own
        for rows in (slice(0, 1), slice(-1, None), slice(1, -1)):
            _close(got.numpy()[:, rows], np.asarray(want)[:, rows], rtol)
    else:
        _close(got.numpy(), want, rtol)
    for a, b in zip(tst.gradient(torch.as_tensor(q).to(tdt), tg),
                    jst.gradient(jnp.asarray(q, jdt), jg)):
        _close(a.numpy(), b, rtol)


def test_cartesian_spacing_and_bad_bc():
    y = np.linspace(0.0, 1e5, 20)
    x = np.linspace(0.0, 3e5, 30)
    q = np.random.default_rng(9).standard_normal((20, 30))
    jg = jgrid.from_cartesian(y, x, dtype=jnp.float64)
    tg = xt.from_cartesian(y, x, dtype=torch.float64, device=CPU)
    _close(tst.squared_gradient(torch.as_tensor(q), tg).numpy(),
           jst.squared_gradient(jnp.asarray(q), jg), 1e-14)
    with pytest.raises(ValueError, match="boundary"):
        tst.squared_gradient(torch.as_tensor(q), tg, bc_y="wrap")
