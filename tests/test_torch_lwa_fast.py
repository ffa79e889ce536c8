"""The sort-merge 'fast' LWA and LWA2 (``diagnostics.lwa._lwa_fast`` and
``_lwa2_fast``) against the JAX package's 'fast' path and the float64
oracle, modelled on tests/test_lwa_fast.py; the 'auto' dispatch at the
port's crossover; the pipelines with ``lwa_method='fast'`` against JAX's.

Tolerances: float64 1e-11 of the field maximum (the forms differ in
summation order only; the oracle 1e-10 absolute, as the JAX suite), and in
float32 the JAX suite's floor for 'fast', 1e-4 of the maximum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import compat
from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu.diagnostics import lwa as jlwa
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import lwa as tlwa
from xcontour_tpu_torch.kernels import lwa as kl

from test_torch_lwa import F64_RTOL, _close, _era_like, _t
from test_torch_pipeline import _compare, _inputs

CPU = "cpu"
FAST_F32_BOUND = 1e-4


def _case(seed, Ny=24, Nx=9, nan=True, ties=True):
    """tests/test_lwa_fast.py's case: NaN cells and weights, an exact
    tracer-profile tie each way."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Ny, Nx))
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    Q = np.sort(rng.standard_normal(Ny))
    if nan:
        q[rng.integers(0, Ny, 4), rng.integers(0, Nx, 4)] = np.nan
        W[rng.integers(0, Ny, 2), rng.integers(0, Nx, 2)] = np.nan
    if ties:
        Q[Ny // 2] = q[Ny // 3, Nx // 2]
        q[Ny // 4, 0] = Q[Ny // 4]
    return q, Q, W


def _fast(q, Q, W, increase, variant2):
    fn = tlwa._lwa2_fast if variant2 else tlwa._lwa_fast
    return fn(*_t(q, Q, W), increase).numpy()


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("coord_up", [True, False])
@pytest.mark.parametrize("q_dir", ["asc", "desc"])
def test_fast_matches_jax_fast_and_oracle(variant2, increase, coord_up, q_dir):
    q, Q, W = _case(1 + 2 * variant2 + increase)
    if q_dir == "desc":
        Q = Q[::-1].copy()
    ydef = np.linspace(-80, 80, q.shape[0])
    if not coord_up:
        ydef = ydef[::-1].copy()
    fn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity
    got = fn(*_t(q, Q, np.ones_like(W), ydef), increase=increase, weight=
             torch.as_tensor(W), method="fast").numpy()
    want = jlwa._lwa_via_fast(*(jnp.asarray(a) for a in (q, Q, W)), increase,
                              variant2)
    _close(got, want, F64_RTOL)
    oracle = (compat.local_wave_activity2 if variant2
              else compat.local_wave_activity)
    ref = oracle(q, Q, np.ones_like(W), ydef, increase=increase, part="all",
                 weight=W)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_nan_profile_rows(variant2):
    """NaN profile rows: zero rows for LWA; for LWA2 they only take cells
    out of every surface's sum (the oracle's nansum)."""
    q, Q, W = _case(5, nan=False)
    Q = Q.copy()
    Q[[0, 7]] = np.nan
    got = _fast(q[None], Q[None], W, True, variant2)[0]
    if variant2:
        want = compat.local_wave_activity2(q, Q, np.ones_like(W),
                                           np.linspace(-80, 80, q.shape[0]),
                                           increase=True, weight=W)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        assert (got[[0, 7]] == 0).all()
    want = jlwa._lwa_via_fast(*(jnp.asarray(a) for a in (q, Q, W)), True,
                              variant2)
    _close(got, want, F64_RTOL)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_nonfinite_cells_and_profiles(variant2):
    """+-inf tracer cells, a NaN weight and an all-NaN profile (its mean is
    NaN, so nothing is centred), against JAX."""
    rng = np.random.default_rng(6 + variant2)
    B, Ny, Nx = 3, 20, 11
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1)
    Q = np.sort(rng.standard_normal((B, Ny)) * 3, axis=-1)
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    q[0, 4, 2], q[1, 7, 3] = np.inf, -np.inf
    q[0, 10, 5] = np.nan
    W[3, 6] = np.nan
    Q[2] = np.nan
    for increase in (True, False):
        got = _fast(q, Q, W, increase, variant2)
        want = jlwa._lwa_via_fast(*(jnp.asarray(a) for a in (q, Q, W)),
                                  increase, variant2)
        _close(got, want, F64_RTOL)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_batched_matches_loop(variant2):
    rng = np.random.default_rng(8 + variant2)
    B, Ny, Nx = 3, 16, 7
    q = rng.standard_normal((B, Ny, Nx))
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    Q = np.sort(rng.standard_normal((B, Ny)), axis=-1)
    got = _fast(q, Q, W, True, variant2)
    for b in range(B):
        one = _fast(q[b:b + 1], Q[b:b + 1], W, True, variant2)[0]
        np.testing.assert_allclose(got[b], one, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_entry_point_matches_jax_on_pv(variant2):
    """local_wave_activity[2](method='fast') on synthetic PV with its
    sorted profile, the default weight and the 'dy' weight."""
    q, Q, dA, lat, _ = _era_like(nlat=40, nlon=64)
    dyF = np.asarray(xt.from_latlon(lat, np.linspace(0, 354.375, 64),
                                    dtype=torch.float64, device=CPU).dyF)
    jfn = jlwa.local_wave_activity2 if variant2 else jlwa.local_wave_activity
    tfn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity
    for weight in (None, dA / dA.max() * dyF):
        want = jfn(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(dA),
                   jnp.asarray(lat), increase=True, method="fast",
                   weight=None if weight is None else jnp.asarray(weight))
        got = tfn(*_t(q, Q, dA, lat), increase=True, method="fast",
                  weight=None if weight is None else torch.as_tensor(weight))
        _close(got.numpy(), want, F64_RTOL)


@pytest.mark.parametrize("variant2", [False, True])
def test_fast_float32_floor_against_the_float64_oracle(variant2):
    """The suffix, CDF and total terms cancel: centred on the profile mean,
    float32 'fast' stays within 1e-4 of the field maximum (the JAX suite's
    bound, tests/test_lwa_fast.py)."""
    q, Q, dA, lat, want = _era_like()
    if variant2:
        want = np.stack([compat.local_wave_activity2(q[b], Q[b], dA, lat,
                                                     increase=True)
                         for b in range(q.shape[0])])
    fn = xt.local_wave_activity2 if variant2 else xt.local_wave_activity
    got = fn(*_t(*(a.astype(np.float32) for a in (q, Q, dA, lat))),
             increase=True, method="fast").numpy()
    scale = np.nanmax(np.abs(want))
    assert np.abs(got - want).max() < FAST_F32_BOUND * scale


def test_fast_rejects_part_selection():
    for fn in (xt.local_wave_activity, xt.local_wave_activity2):
        with pytest.raises(ValueError, match="part='all'"):
            fn(torch.zeros(4, 4), torch.zeros(4), torch.ones(4, 4),
               torch.arange(4.0), increase=True, part="upper", method="fast")


def test_auto_dispatch_at_the_port_crossover(monkeypatch):
    """'auto' takes 'fast' from _FAST_NY_CROSSOVER rows and 'lin' below it
    (part='all'), 'dense' for part selections; moved to 16 rows here, each
    side gives its method's output bit for bit and launches no kernel on
    the CPU."""
    c = tlwa._FAST_NY_CROSSOVER
    assert tlwa._resolve_method("auto", "all", c) == "fast"
    assert tlwa._resolve_method("auto", "all", c - 1) == "lin"
    assert tlwa._resolve_method("auto", "upper", c) == "dense"
    monkeypatch.setattr(tlwa, "_FAST_NY_CROSSOVER", 16)
    records = [kl.KERNEL_LIN, kl.KERNEL_LIN2, kl.KERNEL_DENSE,
               kl.KERNEL_DENSE_TALL]
    before = [r.launches for r in records]
    rng = np.random.default_rng(12)
    for Ny, method in ((16, "fast"), (15, "lin")):
        q = rng.standard_normal((2, Ny, 10)).cumsum(1)
        Q = np.sort(rng.standard_normal((2, Ny)), axis=-1)
        dA = rng.uniform(0.5, 1.5, (Ny, 10))
        ydef = np.linspace(-70, 70, Ny)
        for fn in (xt.local_wave_activity, xt.local_wave_activity2):
            auto = fn(*_t(q, Q, dA, ydef), increase=True)
            want = fn(*_t(q, Q, dA, ydef), increase=True, method=method)
            assert torch.equal(auto, want)
    assert [r.launches for r in records] == before


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_lwa_pipeline_fast_matches_jax(dt):
    jdt, tdt = {"f64": (jnp.float64, torch.float64),
                "f32": (jnp.float32, torch.float32)}[dt]
    lat, lon, q, mask = _inputs(masked=True, seed=3)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jdt)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=tdt, device=CPU)
    kw = dict(N=33, metric="dy", lwa_method="fast")
    want = jpipe.lwa_pipeline(jnp.asarray(q, jdt), jg, **kw)
    got = xt.lwa_pipeline(torch.as_tensor(q).to(tdt), tg, **kw)
    _compare(got, want, dt)


def test_keff_lwa_pipeline_fast_with_lwa2_matches_jax():
    lat, lon, q, mask = _inputs(masked=True, seed=4)
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    pre_y = np.linspace(-70.0, 70.0, 15)
    kw = dict(N=33, lmin="dxF", metric="dy", lwa_method="fast",
              with_lwa2=True)
    want = jpipe.keff_lwa_pipeline(jnp.asarray(q), jg,
                                   pre_y=jnp.asarray(pre_y), **kw)
    got = xt.keff_lwa_pipeline(torch.as_tensor(q), tg,
                               pre_y=torch.as_tensor(pre_y), **kw)
    assert "lwa2" in got
    _compare(got, want, "f64")
