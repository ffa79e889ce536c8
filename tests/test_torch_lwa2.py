"""K5 (linearized LWA2), K4's variant 2 and K6 (the tall-grid pairwise LWA):
the port's plain versions and ``local_wave_activity2`` against the JAX
package's Pallas kernels in interpret mode, its XLA twins and the float64
oracle.

Tolerances: in float64 the forms differ only in summation order, so they
agree to 1e-11 of the field maximum.  The float32 bounds are stated where
they are used.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import compat
from xcontour_tpu.diagnostics import lwa as jlwa
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import lwa as tlwa
from xcontour_tpu_torch.kernels import lwa as kl

from test_torch_lwa import F64_RTOL, _case, _close, _era_like, _t

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

# the module itself: the package re-exports its lwa_pallas function under
# the same name
jlp = importlib.import_module("xcontour_tpu.kernels.lwa_pallas")

# the float32 'lin' LWA2 bound, relative to the field maximum: see
# test_lin2_float32_floor_against_the_float64_oracle
LIN2_F32_BOUND = 5e-5


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("increase", [True, False])
def test_lin2_plain_matches_pallas_interpret_and_xla_twin(increase):
    """NaN and +-inf cells, a NaN profile row and a NaN weight."""
    q, Q, W = _case(5)
    got = kl.lwa_lin2(*_t(q, Q, W), increase=increase).numpy()
    assert np.isfinite(got).all()
    twin = jlwa._lwa_lin_xla(*_j(q, Q, W), increase, True, 16)
    _close(got, twin, F64_RTOL)
    kern = jlp.lwa_pallas(*_j(q, Q, W), increase=increase, variant2=True,
                          pairwise=False, interpret=True)
    _close(got, kern, F64_RTOL)
    # a non-finite surface value gives 0
    assert got[0, 3, 7] == 0 and got[0, 12, 40] == 0 and got[1, 30, 41] == 0


def test_lin2_equals_dense_variant2_without_invalid_cells():
    """The linearization is exact: on finite inputs 'lin' LWA2 equals the
    pairwise LWA2 up to summation order, for both tracer directions."""
    q, Q, W = _case(6, inf=False, nan_w=False)
    q = np.nan_to_num(q, nan=0.5)
    Q[1, 6] = 0.0
    Q = np.sort(Q, -1)
    for increase in (True, False):
        lin = kl.lwa_lin2(*_t(q, Q, W), increase=increase).numpy()
        dense = kl.lwa_dense(*_t(q, Q, W), increase=increase,
                             variant2=True).numpy()
        _close(lin, dense, F64_RTOL)


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
@pytest.mark.parametrize("increase", [True, False])
def test_dense_variant2_plain_matches_xla_twin(part, increase):
    q, Q, W = _case(7)
    ydef = np.linspace(-80.0, 80.0, q.shape[1])
    got = kl.lwa_dense(*_t(q, Q, W), increase=increase, part=part,
                       variant2=True).numpy()
    twin = jlwa._lwa_dense_xla(*_j(q, Q, W, ydef), increase=increase,
                               part=part, variant2=True, chunk=16)
    _close(got, twin, F64_RTOL)        # NaN pattern included


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
@pytest.mark.parametrize("increase", [True, False])
def test_dense_variant2_plain_matches_pallas_interpret(part, increase):
    q, Q, W = _case(8, inf=False, nan_w=False)
    got = kl.lwa_dense(*_t(q, Q, W), increase=increase, part=part,
                       variant2=True).numpy()
    kern = jlp.lwa_pallas(*_j(q, Q, W), increase=increase, part=part,
                          variant2=True, pairwise=True, interpret=True)
    _close(got, kern, F64_RTOL)


def test_dense_variant2_follows_the_twin_where_the_tpu_kernel_differs():
    """The two differences between the TPU pairwise kernel and its XLA twin,
    for variant 2; the port follows the twin.
    (1) A NaN weight: the twin zeroes it; the TPU kernel gives NaN in its
    column (every surface meets every profile row).
    (2) A -inf surface value with increase=True: the twin's product form
    gives -inf * 0 = NaN at that cell; the TPU kernel's min/max identity
    gives a finite or infinite value there.  Elsewhere the three agree."""
    q, Q, W = _case(9, inf=False)
    ydef = np.linspace(-80.0, 80.0, q.shape[1])
    got = kl.lwa_dense(*_t(q, Q, W), increase=True, variant2=True).numpy()
    kern = np.asarray(jlp.lwa_pallas(*_j(q, Q, W), increase=True,
                                     variant2=True, interpret=True))
    twin = jlwa._lwa_dense_xla(*_j(q, Q, W, ydef), increase=True, part="all",
                               variant2=True, chunk=16)
    _close(got, twin, F64_RTOL)
    assert np.isfinite(got).all()
    assert np.isnan(kern[:, :, 60]).all()     # column of the NaN weight
    keep = np.ones(kern.shape[-1], bool)
    keep[60] = False
    _close(got[..., keep], kern[..., keep], F64_RTOL)

    q, Q, W = _case(9, nan_w=False)           # -inf at q[1, 30, 41]
    got = kl.lwa_dense(*_t(q, Q, W), increase=True, variant2=True).numpy()
    kern = np.asarray(jlp.lwa_pallas(*_j(q, Q, W), increase=True,
                                     variant2=True, interpret=True))
    twin = jlwa._lwa_dense_xla(*_j(q, Q, W, ydef), increase=True, part="all",
                               variant2=True, chunk=16)
    _close(got, twin, F64_RTOL)
    differ = np.isnan(got) != np.isnan(kern)
    assert np.isnan(got[1, 30, 41]) and not np.isnan(kern[1, 30, 41])
    assert differ.sum() == 1 and differ[1, 30, 41]


@pytest.mark.parametrize("part", ["all", "upper", "lower"])
@pytest.mark.parametrize("variant2", [False, True])
def test_dense_plain_matches_the_y_blocked_pallas_kernel(monkeypatch,
                                                         variant2, part):
    """K6: the TPU's tall-grid kernel, forced at a small Ny the way the JAX
    suite forces it (a one-byte VMEM budget and 16-row blocks: Ny=56 pads
    to 64 rows in 4 blocks, Nx=72 to one 128-lane panel).  The port serves
    it with the dense kernel at every Ny."""
    monkeypatch.setattr(jlp, "_VMEM_BUDGET", 1)
    monkeypatch.setattr(jlp, "_YB", 16)
    q, Q, W = _case(10, Ny=56, Nx=72, inf=False, nan_w=False)
    for increase in (True, False):
        got = kl.lwa_dense(*_t(q, Q, W), increase=increase, part=part,
                           variant2=variant2).numpy()
        kern = jlp._lwa_pallas_yblocked(*_j(q, Q, W), increase=increase,
                                        part=part, variant2=variant2,
                                        interpret=True)
        _close(got, kern, F64_RTOL)


def test_tall_grid_launches_count_as_k6():
    """The dense wrapper credits a launch at Ny > TALL_NY to K6's record;
    on the CPU neither record moves."""
    assert kl.TALL_NY == 3072
    assert kl.KERNEL_DENSE_TALL.replaces.endswith("lwa_pallas.py:262")
    assert kl.KERNEL_LIN2.replaces.endswith("lwa_pallas.py:157")
    q, Q, W = _case(11)
    before = (kl.KERNEL_DENSE.launches, kl.KERNEL_DENSE_TALL.launches,
              kl.KERNEL_LIN2.launches)
    kl.lwa_dense(*_t(q, Q, W), increase=True, variant2=True)
    kl.lwa_lin2(*_t(q, Q, W), increase=True)
    assert (kl.KERNEL_DENSE.launches, kl.KERNEL_DENSE_TALL.launches,
            kl.KERNEL_LIN2.launches) == before


def test_lin2_float32_floor_against_the_float64_oracle():
    """'lin' LWA2 in float32 against the reference loop form in float64;
    'dense' LWA2 in float32 at the reference-order bound of LWA.

    The JAX suite pins no LWA2 bound.  Measured 'lin' floors: 2.4e-6 of the
    field maximum on this input (2x64x128 synthetic PV, N=33), 1.8e-6 at
    2x40x64 and 2.7e-6 at 2x91x144; LWA's own 'lin' floor is 2.4-3.5e-6 on
    the same inputs against its 1.5e-4 bound.  The floor grows with Ny (the
    R and E sums run over every row), so the bound, 5e-5, keeps 20x the
    measured floor.  'dense' LWA2 measured 0.9-1.6e-7."""
    q, Q, dA, lat, _ = _era_like()
    want = np.stack([compat.local_wave_activity2(q[b], Q[b], dA, lat, True)
                     for b in range(q.shape[0])])
    scale = np.nanmax(np.abs(want))
    q32, Q32, dA32, lat32 = _t(*(a.astype(np.float32) for a in (q, Q, dA, lat)))
    lin = tlwa.local_wave_activity2(q32, Q32, dA32, lat32, increase=True,
                                    method="lin").numpy()
    dense = tlwa.local_wave_activity2(q32, Q32, dA32, lat32, increase=True,
                                      method="dense").numpy()
    assert np.abs(lin - want).max() / scale < LIN2_F32_BOUND
    assert np.abs(dense - want).max() / scale < 5e-6


@pytest.mark.parametrize("method,part,increase", [
    ("auto", "all", True), ("lin", "all", False), ("dense", "all", True),
    ("auto", "upper", True), ("dense", "lower", False)])
def test_local_wave_activity2_matches_jax(method, part, increase):
    q, Q, dA, lat, _ = _era_like(nlat=40, nlon=64)
    if not increase:
        q, Q = -q, -Q[:, ::-1].copy()
    dyF = np.asarray(xt.from_latlon(lat, np.linspace(0, 354.375, 64),
                                    dtype=torch.float64, device=CPU).dyF)
    for weight in (None, dA / dA.max() * dyF):
        kw = dict(increase=increase, part=part, method=method)
        want = jlwa.local_wave_activity2(
            *_j(q, Q, dA, lat), **kw,
            weight=None if weight is None else jnp.asarray(weight))
        got = tlwa.local_wave_activity2(
            *_t(q, Q, dA, lat), **kw,
            weight=None if weight is None else torch.as_tensor(weight))
        _close(got.numpy(), want, F64_RTOL)
