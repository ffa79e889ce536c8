"""K2 (direct weighted CDF): the port's plain version and ops layer against
the JAX package's Pallas kernel in interpret mode and its ``weighted_cdf`` /
``weighted_cdf_multi``.

Tolerances: float64 sums differ only in summation order (segment-sum vs
per-level masked reduction): rtol 1e-12 of each CDF's total.  Digitization
is compared exactly (values placed on edges, a constant field), because a
cell that changes bin moves a whole cell's weight.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu.kernels.hist_pallas import histogram_pallas_multi
from xcontour_tpu.ops import histogram as jh
from xcontour_tpu_torch.kernels import hist as k2
from xcontour_tpu_torch.ops import histogram as th

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = np.asarray(got)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _edges_case(rng, B=3, G=2000, N=33, C=2):
    v = rng.standard_normal((B, G))
    lo, hi = np.nanmin(v, 1), np.nanmax(v, 1)
    asc = lo[:, None] + (hi - lo)[:, None] * np.linspace(0, 1, N)[None]
    step = (asc[:, -1:] - asc[:, :1]) / (N - 1)
    edges = np.concatenate([asc[:, :1] - step, asc], 1)
    v[:, :N + 1] = edges                      # values exactly on every edge
    v[0, 50:60] = np.nan                      # NaN values
    v[1, 60:70] = edges[1, 0] - 1.0           # below the prepended edge
    w = rng.uniform(0.5, 1.5, (B, C, G))
    w[2, 0, 80:90] = np.nan                   # NaN weights
    return v, edges, w


def test_plain_matches_pallas_interpret():
    v, edges, w = _edges_case(np.random.default_rng(0))
    want = histogram_pallas_multi(jnp.asarray(v), jnp.asarray(edges),
                                  jnp.asarray(w), interpret=True)
    got = k2.weighted_cdf(*(torch.as_tensor(a) for a in (v, edges, w)))
    assert got.shape == want.shape
    _close(got.numpy(), want)


def test_constant_field_law():
    """All edges equal: 0 below the top level, the total at the top (the
    direct-compare law that a floor((v - e0) / step) digitize breaks)."""
    v = np.full((2, 500), 3.25)
    edges = np.full((2, 18), 3.25)
    w = np.random.default_rng(1).uniform(0.5, 1.5, (2, 1, 500))
    want = histogram_pallas_multi(jnp.asarray(v), jnp.asarray(edges),
                                  jnp.asarray(w), interpret=True)
    got = k2.weighted_cdf(*(torch.as_tensor(a) for a in (v, edges, w))).numpy()
    _close(got, want)
    assert (got[..., :-1] == 0).all()
    np.testing.assert_allclose(got[..., -1], w.sum(-1), rtol=1e-13)


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("decreasing", [False, True])
def test_weighted_cdf_matches_jax(lt, decreasing):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 40, 64))
    q[0, :3, :5] = np.nan
    q[2] = 0.75                                # a constant snapshot
    lo = np.nanmin(q, (-2, -1))
    hi = np.nanmax(q, (-2, -1))
    bins = lo[:, None] + (hi - lo)[:, None] * np.linspace(0, 1, 33)[None]
    bins[:, -1] = hi
    if decreasing:
        bins = bins[:, ::-1].copy()
    q[1, 10, :33] = bins[1]                    # values on the bins
    dA = rng.uniform(1.0, 2.0, (40, 64))
    g2 = rng.uniform(0.0, 1.0, q.shape)
    g2[1, 4, 4] = np.nan
    want = jh.weighted_cdf_multi(jnp.asarray(q), jnp.asarray(bins),
                                 [jnp.asarray(dA), jnp.asarray(g2 * dA)], lt)
    got = th.weighted_cdf_multi(torch.as_tensor(q), torch.as_tensor(bins),
                                [torch.as_tensor(dA), torch.as_tensor(g2 * dA)],
                                lt)
    for a, b in zip(got, want):
        _close(a.numpy(), b)
    one = th.weighted_cdf(torch.as_tensor(q), torch.as_tensor(bins),
                          torch.as_tensor(dA), lt)
    _close(one.numpy(), jh.weighted_cdf(jnp.asarray(q), jnp.asarray(bins),
                                        jnp.asarray(dA), lt))


@pytest.mark.parametrize("lt", [True, False])
def test_cdf_single_and_shared_bins_match_jax(lt):
    rng = np.random.default_rng(3)
    v = rng.standard_normal(3000)
    v[::97] = np.nan
    w = rng.uniform(0.0, 2.0, 3000)
    w[5] = np.nan
    bins = np.linspace(2.0, -2.0, 21)          # decreasing, inside the range
    # one unbatched snapshot against the JAX digitize + segment-sum form
    _close(th.weighted_cdf(torch.as_tensor(v.reshape(60, 50)),
                           torch.as_tensor(bins),
                           torch.as_tensor(w.reshape(60, 50)), lt).numpy(),
           jh._cdf_single(jnp.asarray(v), jnp.asarray(bins), jnp.asarray(w),
                          lt))
    # one bin vector shared by a batch
    q = v[:2880].reshape(2, 36, 40)
    _close(th.weighted_cdf(torch.as_tensor(q), torch.as_tensor(bins),
                           torch.as_tensor(np.ones((36, 40))), lt).numpy(),
           jh.weighted_cdf(jnp.asarray(q), jnp.asarray(bins),
                           jnp.ones((36, 40)), lt))


@pytest.mark.parametrize("lt", [True, False])
def test_integral_within_contours_hist_matches_jax(lt):
    from xcontour_tpu import core as jcore
    import xcontour_tpu_torch as xt
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 30, 50))
    q[1, 3, :7] = np.nan
    dA = rng.uniform(1.0, 2.0, (30, 50))
    g = rng.uniform(0.0, 3.0, q.shape)
    ctr = np.asarray(jcore.cal_contours(jnp.asarray(q), 25))
    for integrand in (None, g):
        want = jcore.cal_integral_within_contours_hist(
            jnp.asarray(q), jnp.asarray(ctr), jnp.asarray(dA),
            None if integrand is None else jnp.asarray(integrand), lt=lt)
        got = xt.cal_integral_within_contours_hist(
            torch.as_tensor(q), xt.cal_contours(torch.as_tensor(q), 25),
            torch.as_tensor(dA),
            None if integrand is None else torch.as_tensor(integrand), lt=lt)
        _close(got.numpy(), want)


def test_float32_plain_matches_pallas_interpret():
    v, edges, w = _edges_case(np.random.default_rng(4), C=1)
    v, edges, w = (a.astype(np.float32) for a in (v, edges, w))
    want = histogram_pallas_multi(jnp.asarray(v), jnp.asarray(edges),
                                  jnp.asarray(w), interpret=True)
    got = k2.weighted_cdf(*(torch.as_tensor(a) for a in (v, edges, w)))
    # float32 sums of ~2000 weights in different orders
    _close(got.numpy(), want, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor the wrapper never touches the kernel library: its
    launch count stays 0 (the CUDA path is exercised on the card by
    chip_smoke.py)."""
    before = k2.KERNEL.launches
    v, edges, w = _edges_case(np.random.default_rng(5), B=3, G=300, N=9, C=1)
    k2.weighted_cdf(*(torch.as_tensor(a) for a in (v, edges, w)))
    assert k2.KERNEL.launches == before == 0


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("descending", [False, True])
def test_area_table_takes_one_cdf_launch(lt, increase, descending,
                                         monkeypatch):
    """The A(Y_eq) table finishes both of its CDFs from one K2 call, and
    still matches the JAX package's table (which takes two)."""
    from xcontour_tpu import core as jcore
    import xcontour_tpu_torch as xt
    rng = np.random.default_rng(8)
    y = np.linspace(-80.0, 80.0, 33)
    if descending:
        y = y[::-1].copy()
    mask = (rng.uniform(size=(33, 48)) > 0.15).astype(np.float64)
    dA = np.cos(np.deg2rad(y))[:, None] * rng.uniform(0.9, 1.1, (33, 48))
    calls = []
    kernel = k2.weighted_cdf

    def counted(*args):
        calls.append(args[2].shape)
        return kernel(*args)
    monkeypatch.setattr(k2, "weighted_cdf", counted)
    got = xt.cal_area_eqCoord_table_hist(
        torch.as_tensor(mask), torch.as_tensor(y), torch.as_tensor(dA),
        increase=increase, lt=lt)
    assert calls == [(1, 1, 33 * 48)]
    want = jcore.cal_area_eqCoord_table_hist(
        jnp.asarray(mask), jnp.asarray(y), jnp.asarray(dA), increase=increase,
        lt=lt)
    _close(got.values.numpy(), want.values)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
