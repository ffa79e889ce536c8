"""K3 (linearized LWA) and K4 (pairwise LWA): the port's plain versions and
``local_wave_activity`` against the JAX package's Pallas kernels in
interpret mode, its XLA twins and the float64 oracle.

Tolerances: in float64 the forms differ only in summation order, so they
agree to 1e-11 of the field maximum.  In float32 the bounds are the JAX
suite's own (tests/test_lwa_fast.py): 'lin' < 1.5e-4 of the field maximum
(its R and E terms cancel) and 'dense' < 5e-6 (the reference's order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import compat
from xcontour_tpu.diagnostics import lwa as jlwa
from xcontour_tpu.kernels.lwa_pallas import lwa_pallas
from xcontour_tpu.utils.synth import synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import lwa as tlwa
from xcontour_tpu_torch.kernels import lwa as kl

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

F64_RTOL = 1e-11


def _case(seed, B=2, Ny=40, Nx=128, inf=True, nan_w=True):
    """Sorted profiles, NaN cells, +-inf cells, a NaN profile row, a NaN
    weight and an exact tracer-profile tie."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3
    Q = np.sort(rng.standard_normal((B, Ny)) * 2.0, axis=-1)
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    q[0, 3:5, 7:11] = np.nan
    Q[1, 6] = np.nan
    q[1, 9, 2] = Q[1, 20]
    if inf:
        q[0, 12, 40] = np.inf
        q[1, 30, 41] = -np.inf
    if nan_w:
        W[25, 60] = np.nan
    return q, Q, W


def _close(got, want, rtol, scale=None):
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if scale is None else scale
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("increase", [True, False])
def test_lin_plain_matches_pallas_interpret_and_xla_twin(increase):
    q, Q, W = _case(1)
    got = kl.lwa_lin(*_t(q, Q, W), increase=increase).numpy()
    assert np.isfinite(got).all()      # lin: non-finite cells are invalid
    twin = jlwa._lwa_lin_xla(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                             increase, False, 16)
    _close(got, twin, F64_RTOL)
    kern = lwa_pallas(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                      increase=increase, pairwise=False, interpret=True)
    _close(got, kern, F64_RTOL)
    assert (got[1, 6] == 0).all()      # NaN profile row


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
@pytest.mark.parametrize("increase", [True, False])
def test_dense_plain_matches_xla_twin(part, increase):
    q, Q, W = _case(2)
    ydef = np.linspace(-80.0, 80.0, q.shape[1])
    got = kl.lwa_dense(*_t(q, Q, W), increase=increase, part=part).numpy()
    twin = jlwa._lwa_dense_xla(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                               jnp.asarray(ydef), increase=increase, part=part,
                               variant2=False, chunk=16)
    _close(got, twin, F64_RTOL)        # NaN pattern included (inf * 0 cells)


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
@pytest.mark.parametrize("increase", [True, False])
def test_dense_plain_matches_pallas_interpret(part, increase):
    q, Q, W = _case(3, inf=False, nan_w=False)
    got = kl.lwa_dense(*_t(q, Q, W), increase=increase, part=part).numpy()
    kern = lwa_pallas(jnp.asarray(q), jnp.asarray(Q), jnp.asarray(W),
                      increase=increase, part=part, pairwise=True,
                      interpret=True)
    _close(got, kern, F64_RTOL)


def test_dense_follows_the_twin_where_the_tpu_kernel_differs():
    """Two known differences between the TPU pairwise kernel and its XLA
    twin; the port follows the twin in kernel and plain version alike.
    (1) A NaN weight: the twin zeroes it, the TPU kernel lets NaN through.
    (2) A +inf cell on rows the mask excludes: the twin's product form gives
    inf * 0 = NaN there, the TPU kernel's min/max identity gives 0."""
    q, Q, W = _case(4, inf=False)
    got = kl.lwa_dense(*_t(q, Q, W), increase=True).numpy()
    kern = np.asarray(lwa_pallas(jnp.asarray(q), jnp.asarray(Q),
                                 jnp.asarray(W), increase=True, interpret=True))
    assert np.isfinite(got).all()
    assert np.isnan(kern[:, :, 60]).any()     # column of the NaN weight

    q, Q, W = _case(4, nan_w=False)
    got = kl.lwa_dense(*_t(q, Q, W), increase=True).numpy()
    kern = np.asarray(lwa_pallas(jnp.asarray(q), jnp.asarray(Q),
                                 jnp.asarray(W), increase=True, interpret=True))
    only_port_nan = np.isnan(got) & ~np.isnan(kern)
    assert only_port_nan.any() and (np.nonzero(only_port_nan)[2] == 40).all()


def _era_like(nlat=64, nlon=128):
    v, _ = synth_pv(nlev=2, nlat=nlat, nlon=nlon, seed=11)
    lat = v["latitude"].astype(np.float64)
    lon = v["longitude"].astype(np.float64)
    q = v["pv"].astype(np.float64)
    dA = np.asarray(xt.from_latlon(lat, lon, dtype=torch.float64,
                                   device=CPU).dA)
    states = [compat.lwa_snapshot(q[b], lat, dA, np.ones_like(q[b]), N=33,
                                  increase=True, lt=True) for b in range(2)]
    Q = np.stack([s["Q"] for s in states])
    want = np.stack([s["lwa"] for s in states])
    return q, Q, dA, lat, want


def test_float32_bounds_against_the_float64_oracle():
    q, Q, dA, lat, want = _era_like()
    scale = np.nanmax(np.abs(want))
    q32, Q32, dA32, lat32 = _t(*(a.astype(np.float32) for a in (q, Q, dA, lat)))
    lin = tlwa.local_wave_activity(q32, Q32, dA32, lat32, increase=True,
                                   method="lin").numpy()
    dense = tlwa.local_wave_activity(q32, Q32, dA32, lat32, increase=True,
                                     method="dense").numpy()
    err_lin = np.abs(lin - want).max() / scale
    err_dense = np.abs(dense - want).max() / scale
    assert err_lin < 1.5e-4
    assert err_dense < 5e-6


@pytest.mark.parametrize("method,part", [("auto", "all"), ("dense", "all"),
                                         ("auto", "upper"), ("lin", "all")])
def test_local_wave_activity_matches_jax(method, part):
    q, Q, dA, lat, _ = _era_like(nlat=40, nlon=64)
    dyF = np.asarray(xt.from_latlon(lat, np.linspace(0, 354.375, 64),
                                    dtype=torch.float64, device=CPU).dyF)
    for weight in (None, dA / dA.max() * dyF):
        want = jlwa.local_wave_activity(
            jnp.asarray(q), jnp.asarray(Q), jnp.asarray(dA), jnp.asarray(lat),
            increase=True, part=part, method=method,
            weight=None if weight is None else jnp.asarray(weight))
        got = tlwa.local_wave_activity(
            *_t(q, Q, dA, lat), increase=True, part=part, method=method,
            weight=None if weight is None else torch.as_tensor(weight))
        _close(got.numpy(), want, F64_RTOL)


def test_method_resolution():
    ny = tlwa._FAST_NY_CROSSOVER - 1
    assert tlwa._resolve_method("auto", "all", ny) == "lin"
    assert tlwa._resolve_method("auto", "all", ny + 1) == "fast"
    assert tlwa._resolve_method("auto", "lower", ny + 1) == "dense"
    assert tlwa._resolve_method("dense", "upper", ny) == "dense"
    assert tlwa._resolve_method("fast", "all", 8) == "fast"
    for method in ("lin", "fast"):
        with pytest.raises(ValueError, match="part='all'"):
            tlwa._resolve_method(method, "upper", ny)
    with pytest.raises(ValueError):
        tlwa._resolve_method("sorted", "all", ny)
    assert kl.KERNEL_LIN.launches == 0 and kl.KERNEL_DENSE.launches == 0
