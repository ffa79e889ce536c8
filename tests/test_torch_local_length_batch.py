"""K8 and ``local_contour_lengths`` on a batch of fields, and
``local_length_pipeline``: the batch against a loop over its slices, bit
for bit in float64 (NaN patterns included); each slice against the JAX
package at ``tests/test_torch_local_length.py``'s tolerances; the pipeline
against the benchmark's plain float64 reference (``xcbench/reference/
local.py``, which shares no code with the port); gradients through the
batched autograd Function against the per-slice ones."""

import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu.diagnostics import local_length as jlocal
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import local_length as tlocal
from xcontour_tpu_torch.kernels import length as k8

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from xcbench import compare  # noqa: E402
from xcbench.reference import core as ref_core, local as ref_local  # noqa: E402

CPU = "cpu"


def _batch(seed, B=3, Ny=40, Nx=56):
    """B seeded random-walk fields with a NaN box in the first and a NaN
    point in the last, on a latitude band and a partial longitude circle."""
    rng = np.random.default_rng(seed)
    d = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1) \
        + 0.5 * rng.normal(size=(B, Ny, Nx))
    d[0, 6:9, 20:26] = np.nan
    d[-1, 3 * Ny // 4, 4] = np.nan
    return np.linspace(-70.0, 70.0, Ny), np.linspace(0.0, 357.0, Nx), d


def _same(got, want):
    """Bit for bit, NaN pattern included."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    m = ~torch.isnan(want)
    assert torch.equal(got[m], want[m])


@pytest.mark.parametrize("latlon", [True, False])
@pytest.mark.parametrize("window,stride", [(13, 6), (8, 3), (20, 25)])
def test_batched_plain_matches_slices(window, stride, latlon):
    lat, lon, d = _batch(1)
    yc = np.deg2rad(lat) if latlon else lat * 1e4
    xc = np.deg2rad(lon) if latlon else lon * 1e4
    t = torch.as_tensor(d)
    levels = tlocal.rolling_mean(t, window, stride)[0]
    levels[1, 0, 1] = float("nan")                      # a NaN level
    y, x = torch.as_tensor(yc), torch.as_tensor(xc)
    kw = dict(window=window, stride=stride, latlon=latlon)
    got = k8.local_lengths_plain(t, levels, y, x, **kw)
    want = torch.stack([k8.local_lengths_plain(t[b], levels[b], y, x, **kw)
                        for b in range(t.shape[0])])
    _same(got, want)
    assert got[1, 0, 1] == 0.0
    # the wrapper on CPU tensors takes the plain version, batch or not
    _same(k8.local_lengths(t, levels, y, x, **kw), got)


def test_empty_batch_and_window_set():
    t = torch.zeros((0, 12, 14), dtype=torch.float64)
    y, x = torch.linspace(0, 1, 12, dtype=torch.float64), \
        torch.linspace(0, 1, 14, dtype=torch.float64)
    lv = torch.zeros((0, 1, 1), dtype=torch.float64)
    assert k8.local_lengths_plain(t, lv, y, x, window=12, stride=5,
                                  latlon=False).shape == (0, 1, 1)
    t = torch.ones((2, 12, 14), dtype=torch.float64)
    L, _, _ = xt.local_contour_lengths(t, y, x, window=13, stride=5,
                                       latlon=False)
    assert L.shape == (2, 0, 1)


@pytest.mark.parametrize("lead", [(3,), (1, 3)])
def test_batched_local_contour_lengths_match_slices(lead):
    lat, lon, d = _batch(2)
    t = torch.as_tensor(d).reshape(lead + d.shape[1:])
    y, x = torch.as_tensor(lat), torch.as_tensor(lon)
    kw = dict(window=15, stride=7, latlon=True, min_count=220)
    got, cy, cx = xt.local_contour_lengths(t, y, x, **kw)
    flat = t.reshape((-1,) + d.shape[1:])
    per = [xt.local_contour_lengths(s, y, x, **kw) for s in flat]
    _same(got.reshape((-1,) + got.shape[-2:]),
          torch.stack([p[0] for p in per]))
    assert torch.isnan(got).any()          # min_count empties some windows
    _same(cy, per[0][1])
    _same(cx, per[0][2])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_batch_slices_match_jax(dt):
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else \
        (jnp.float32, torch.float32)
    lat, lon, d = _batch(4)
    kw = dict(window=15, stride=7, latlon=True, min_count=10)
    got, _, _ = xt.local_contour_lengths(
        *(torch.as_tensor(a).to(tdt) for a in (d, lat, lon)), **kw)
    rtol = 2e-6 if dt == "f32" else 1e-12
    for b in range(d.shape[0]):
        want, _, _ = jlocal.local_contour_lengths(
            jnp.asarray(d[b], jdt), jnp.asarray(lat, jdt),
            jnp.asarray(lon, jdt), **kw)
        g, w = got[b].numpy(), np.asarray(want)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        m = np.isfinite(w)
        np.testing.assert_allclose(g[m], w[m], rtol=rtol,
                                   atol=rtol * np.abs(w[m]).max())


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_pipeline_matches_plain_reference(seed):
    rng = np.random.default_rng(seed)
    lat = np.linspace(-90.0, 90.0, 61)
    lon = np.arange(120) * 3.0
    d = np.sin(np.deg2rad(lat))[None, :, None] * np.linspace(1, 3, 3)[:, None,
                                                                       None]
    d = d + 0.3 * np.cumsum(rng.normal(size=(3, 61, 120)), axis=-1) / 10
    d[0, 20:26, 30:50] = np.nan
    grid = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    got = xt.local_length_pipeline(torch.as_tensor(d), grid, window=21,
                                   stride=5)
    assert set(got) == {"llen", "means", "y_window", "x_window"}
    assert got["llen"].shape == got["means"].shape == (3, 9, 20)
    want = ref_local.run(torch.as_tensor(d),
                         ref_core.latlon_grid(lat, lon, torch.float64, CPU),
                         window=21, stride=5)
    gaps = compare.gaps(got, want, {"keys": ["means", "llen"]})
    assert max(gaps.values()) < 1e-11, gaps
    np.testing.assert_array_equal(got["y_window"].numpy(), lat[10:51:5])
    np.testing.assert_array_equal(got["x_window"].numpy(), lon[10:106:5])


def test_pipeline_on_one_field_and_its_spans():
    from xcontour_tpu_torch.utils import prof
    lat, lon, d = _batch(5, B=1)
    grid = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    t = torch.as_tensor(d[0])
    t0 = time.perf_counter_ns()
    with prof.logging():
        out = xt.local_length_pipeline(t, grid, window=15, stride=7)
    names = [s[0] for s in prof.spans() if s[2] >= t0]
    assert names.count("pipeline.local_length_pipeline") == 1
    assert {"stage.rolling", "stage.local_lengths"} <= set(names)
    L, _, _ = xt.local_contour_lengths(t, grid.ydef, grid.xdef, window=15,
                                       stride=7, latlon=grid.latlon)
    _same(out["llen"], L)


@pytest.mark.parametrize("latlon", [True, False])
def test_batched_gradients_match_slices(latlon):
    lat, lon, d = _batch(6, B=2, Ny=16, Nx=24)
    y, x = torch.as_tensor(lat), torch.as_tensor(lon)
    kw = dict(window=7, stride=4, latlon=latlon)

    def loss(t):
        return torch.nansum(xt.local_contour_lengths(t, y, x, **kw)[0] ** 2)
    t = torch.tensor(d, requires_grad=True)
    g, = torch.autograd.grad(loss(t), t)
    for b in range(d.shape[0]):
        s = torch.tensor(d[b], requires_grad=True)
        gb, = torch.autograd.grad(loss(s), s)
        assert torch.equal(torch.isnan(g[b]), torch.isnan(gb))
        m = torch.isfinite(gb)
        assert m.any() and (gb[m] != 0).any()
        torch.testing.assert_close(g[b][m], gb[m], rtol=1e-12,
                                   atol=1e-12 * gb[m].abs().max().item())


def test_batched_call_runs_the_wrapper_once(monkeypatch):
    calls = []
    orig = k8.local_lengths

    def counted(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)
    monkeypatch.setattr(k8, "local_lengths", counted)
    lat, lon, d = _batch(7, B=4, Ny=30, Nx=40)
    grid = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    xt.local_length_pipeline(torch.as_tensor(d), grid, window=9, stride=4)
    t = torch.tensor(d, requires_grad=True)
    L = xt.local_length_pipeline(t, grid, window=9, stride=4)["llen"]
    torch.autograd.grad(torch.nansum(L), t)
    assert calls == [(4, 30, 40), (4, 30, 40)]


def test_window_larger_than_the_field_gives_no_window():
    """As the JAX package's numpy-style empty range: no anchor, empty
    means and lengths (the benchmark's tiny copies run the cell's
    101-point windows on fields of 37 rows)."""
    lat, lon, d = _batch(8, B=2, Ny=20, Nx=30)
    t = torch.as_tensor(d)
    want, oy, ox = jlocal.rolling_mean(jnp.asarray(d), 41, 10)
    got, toy, tox = tlocal.rolling_mean(t, 41, 10)
    assert got.shape == tuple(want.shape) == (2, 0, 0)
    assert toy.numel() == np.asarray(oy).size == 0
    assert tox.numel() == np.asarray(ox).size == 0
    grid = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    out = xt.local_length_pipeline(t, grid, window=41, stride=10)
    assert out["llen"].shape == out["means"].shape == (2, 0, 0)
