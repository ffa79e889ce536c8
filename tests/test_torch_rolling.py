"""Kernel R, the window means (``csrc/rolling.cu``), and ``rolling_mean``.

R cannot run here, so :func:`emulate` evaluates its sums in plain torch,
tile by tile as ``kernels.rolling.plan`` lays them out and in the kernel's
order: a block's band of anchor rows, its anchors and the halo columns of
its footprint, each column's float64 sums of value and count slid down
the band (the window's rows at the band's first anchor row, then the
stride rows in and out), the chunks of ``stride`` columns and the window
sums from them.  The CPU tests hold the emulation against the plain
version (the integral images) and against float64 sums taken directly
over each window; the ``-m cuda`` tests hold the kernel against the
emulation bit for bit (float64 adds in the same order round the same) and
run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_rolling.py`` (the card's machine has no JAX, which
``tests/conftest.py`` imports; this file imports none).

Tolerances: float64 fields, the emulation against the plain version
within 1e-9 of the largest |mean| (the integral images' float64 cumsums
cancel to ~1e-13 of it); float32 fields, the emulation within one float32
ulp of the float64 direct means (its float64 sums are rounded once).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch.diagnostics import local_length as dlocal
from xcontour_tpu_torch.kernels import rolling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from xcbench.reference import local as ref_local  # noqa: E402

NAN = float("nan")
# (window, stride): the era5.local cell's, then the ones chip_smoke.py and
# the K8 tests run, a stride past the window, dense windows
WINDOWS = [(101, 10), (101, 7), (64, 10), (101, 40), (161, 80), (31, 45),
           (33, 8), (3, 1), (2, 1)]


def emulate(data: torch.Tensor, window: int, stride: int,
            min_count: int = 1) -> torch.Tensor:
    """R's means of data (..., Ny, Nx), evaluated tile by tile in the
    kernel's order of float64 operations (on data's device)."""
    lead, (Ny, Nx) = data.shape[:-2], data.shape[-2:]
    f = data.reshape((-1, Ny, Nx))
    B = f.shape[0]
    Wy = rolling.anchors(Ny, window, stride)
    Wx = rolling.anchors(Nx, window, stride)
    out = torch.full((B, Wy, Wx), NAN, dtype=data.dtype, device=data.device)
    if B == 0 or Wy == 0 or Wx == 0:
        return out.reshape(lead + (Wy, Wx))
    TX, TY, ntx, nty, threads, per_thread, nch_max = rolling.plan(
        B, Ny, Nx, window, stride)
    assert ntx * TX >= Wx and nty * TY >= Wy
    fin = torch.isfinite(f)
    val = torch.where(fin, f, torch.zeros_like(f)).double()
    cnt = fin.long()
    fill = rolling.field_fill(f) if min_count <= 0 else val.new_zeros(B)
    s, w = stride, window
    q, rem = divmod(w, s)
    z = val.new_zeros(())
    for ty in range(nty):
        r0 = ty * TY
        nr = min(TY, Wy - r0)
        for tx in range(ntx):
            c0 = tx * TX
            nc = min(TX, Wx - c0)
            fw = (nc - 1) * s + w                 # the footprint, halo and all
            assert 1 <= nc
            assert fw + rolling.LEAD <= threads * per_thread
            assert c0 * s + fw <= Nx and nc + q <= nch_max
            cols = slice(c0 * s, c0 * s + fw)
            for r in range(r0, r0 + nr):
                y = r * s
                assert y + w <= Ny
                if r == r0 or s >= w:
                    v = val.new_zeros((B, fw))
                    n = cnt.new_zeros((B, fw))
                    for i in range(w):
                        v = v + val[:, y + i, cols]
                        n = n + cnt[:, y + i, cols]
                else:
                    for i in range(s):
                        v = v + val[:, y - s + w + i, cols]
                        n = n + cnt[:, y - s + w + i, cols]
                        v = v - val[:, y - s + i, cols]
                        n = n - cnt[:, y - s + i, cols]
                # chunk j: footprint columns j s .. j s + s - 1 (the last
                # holds only its first rem); part: the first rem of them
                nch = nc + q
                x0 = torch.arange(nch, device=data.device) * s
                cv = val.new_zeros((B, nch))
                cn = cnt.new_zeros((B, nch))
                pv, pn = cv, cn
                for l in range(s):
                    ok = x0 + l < fw
                    at = torch.clamp(x0 + l, max=fw - 1)
                    cv = cv + torch.where(ok, v[:, at], z)
                    cn = cn + torch.where(ok, n[:, at], 0)
                    if l == rem - 1:
                        pv, pn = cv, cn
                tot = val.new_zeros((B, nc))
                num = cnt.new_zeros((B, nc))
                for j in range(q):
                    tot = tot + cv[:, j:j + nc]
                    num = num + cn[:, j:j + nc]
                if rem:
                    tot = tot + pv[:, q:q + nc]
                    num = num + pn[:, q:q + nc]
                mean = torch.where(num > 0, tot / num.clamp(min=1),
                                   fill[:, None])
                mean = torch.where(num >= min_count, mean, NAN)
                out[:, r, c0:c0 + nc] = mean.to(data.dtype)
    return out.reshape(lead + (Wy, Wx))


def _field(seed, B, Ny, Nx, dtype=torch.float64, offset=0.0):
    """Seeded random walks along y plus noise (a PV-like field's mix of
    smooth and rough), a NaN box below ground on the first field and a NaN
    point on the last."""
    rng = np.random.default_rng(seed)
    d = np.cumsum(rng.normal(size=(B, Ny, Nx)), axis=1) \
        + 0.5 * rng.normal(size=(B, Ny, Nx)) + offset
    d[0, : Ny // 5, Nx // 3: Nx // 2] = np.nan
    d[-1, Ny // 2, Nx // 4] = np.nan
    return torch.as_tensor(d, dtype=dtype)


def _direct(data, window, stride, min_count=1):
    """The window means from float64 sums over each window's points (the
    benchmark's plain reference)."""
    f = data.reshape((-1,) + data.shape[-2:]).double()
    got = ref_local.window_means(f, window, stride, min_count)
    return got.reshape(data.shape[:-2] + got.shape[-2:])


def _close(got, want, rtol):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    m = ~torch.isnan(want)
    if m.any():
        scale = float(want[m].abs().max())
        err = float((got[m].double() - want[m].double()).abs().max())
        assert err <= rtol * max(scale, 1.0), (err, scale)


def _within_an_ulp(got, exact):
    """got (float32) within one float32 ulp of the float64 means."""
    assert torch.equal(torch.isnan(got), torch.isnan(exact))
    m = ~torch.isnan(exact)
    e = exact[m].numpy()
    ulp = np.spacing(np.abs(e).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got[m].double().numpy() - e) <= ulp)


@pytest.mark.parametrize("window,stride", WINDOWS)
def test_decomposition_matches_the_integral_images(window, stride):
    """R's tiles, bands, column sums and chunks at 2 x 721 x 1440 (the
    ERA5 grid) in float64, against the plain version."""
    t = _field(1, 2, 721, 1440)
    _close(emulate(t, window, stride), rolling.window_means_plain(
        t, window, stride), 1e-9)


@pytest.mark.parametrize("window,stride", WINDOWS)
def test_float32_means_within_an_ulp_of_float64_sums(window, stride):
    """A float32 field at a Kelvin-scale offset (isentropic temperatures
    ~300 K): R's float64 sums round once, and come no farther from the
    float64 direct means than the plain version's float32 integral
    images."""
    t = _field(2, 1, 203, 367, torch.float32, offset=300.0)
    exact = _direct(t, window, stride)
    got = emulate(t, window, stride)
    _within_an_ulp(got, exact)
    plain = rolling.window_means_plain(t, window, stride)
    m = ~torch.isnan(exact)
    assert (got[m].double() - exact[m]).abs().max() \
        <= (plain[m].double() - exact[m]).abs().max()


@pytest.mark.parametrize("min_count", ["zero", "one", "full"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_min_count_and_nan_boxes(min_count, dtype):
    """min_count 0 (an empty window gives its field's finite mean, 0 for
    an all-NaN field), 1 and the window's size; a below-ground NaN box
    that empties whole windows, an all-NaN field."""
    w, s = 9, 4
    mc = {"zero": 0, "one": 1, "full": w * w}[min_count]
    t = _field(3, 3, 61, 83, dtype)
    t[0, :20, 10:40] = NAN                     # empties some windows whole
    t[1] = NAN                                 # an all-NaN field
    got = emulate(t, w, s, mc)
    _close(got, rolling.window_means_plain(t, w, s, mc),
           1e-9 if dtype == torch.float64 else 1e-5)
    if mc > 0:      # the reference gives an empty window 0, not the fill
        _close(got, _direct(t, w, s, mc).to(dtype),
               1e-12 if dtype == torch.float64 else 1e-6)
    else:
        assert torch.all(got[1] == 0)
        fill = torch.nanmean(t[0].double())
        empty = torch.isnan(_direct(t, w, s, 1)[0])
        assert empty.any()
        assert torch.allclose(got[0][empty].double(), fill.expand(
            int(empty.sum())), rtol=1e-6)
    if mc == w * w:
        assert torch.isnan(got[0]).sum() > torch.isnan(
            emulate(t, w, s, 1)[0]).sum()


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 30, 40), 41, 10),          # window past the field: no window
    ((2, 50, 30), 31, 5),           # past the field's width only
    ((2, 50, 60), 5, 9),            # stride past the window
    ((2, 50, 60), 7, 7),            # stride at the window
    ((0, 50, 60), 7, 3),            # no field
    ((2, 3, 50, 60), 13, 6),        # two leading dimensions
    ((50, 60), 13, 6),              # one field
])
def test_edges_of_the_window_set(shape, window, stride):
    t = torch.as_tensor(np.random.default_rng(4).normal(size=shape))
    got = emulate(t, window, stride)
    want = rolling.window_means_plain(t, window, stride)
    _close(got, want, 1e-9)
    means, oy, ox = xt.rolling_mean(t, window, stride)
    assert means.shape == got.shape
    assert len(oy) == got.shape[-2] and len(ox) == got.shape[-1]


def test_plan_fills_the_card_and_bounds_the_footprint():
    """At the era5.local step the tiles make >= TARGET_BLOCKS blocks of the
    smallest shape; at every case the footprint and its lead fit the
    block's columns, with the halo at most half of them unless the shape is
    the largest or one tile takes every anchor across."""
    TX, TY, ntx, nty, threads, cols, nch = rolling.plan(16, 721, 1440, 101,
                                                        10)
    assert (threads, cols) == rolling.SHAPES[0]
    assert (TX - 1) * 10 + 101 + rolling.LEAD <= threads * cols
    assert 16 * ntx * nty >= rolling.TARGET_BLOCKS
    assert ntx * TX >= 134 and nty * TY >= 63 and nch == TX + 10
    for B in (1, 16, 65537):
        for w, s in WINDOWS + [(rolling.MAX_WINDOW, 3), (1, 1), (2048, 1)]:
            Ny = Nx = max(w + 3 * s, 64)
            TX, TY, ntx, nty, threads, cols, nch = rolling.plan(B, Ny, Nx, w,
                                                                s)
            fw = (TX - 1) * s + w
            assert (threads, cols) in rolling.SHAPES
            assert fw + rolling.LEAD <= threads * cols
            assert (threads, cols) == rolling.SHAPES[-1] or \
                2 * fw >= threads * cols // 2 or \
                TX == rolling.anchors(Nx, w, s)
            assert nch == TX + w // s and TY >= 1 and TX >= 1


@pytest.mark.parametrize("latlon", [True, False])
def test_vjp_matches_autograd_of_the_plain_version(latlon):
    """rolling_mean under grad goes through its Function (R's forward, the
    plain version's VJP); its gradient, and one through K8's levels,
    against autograd of the plain version alone, bit for bit."""
    t = _field(5, 2, 40, 56)
    x = t.clone().requires_grad_()
    means, _, _ = xt.rolling_mean(x, 13, 6)
    g = torch.linspace(-1, 1, means.numel(), dtype=torch.float64).reshape(
        means.shape)
    got, = torch.autograd.grad(means, x, g)
    y = t.clone().requires_grad_()
    want, = torch.autograd.grad(rolling.window_means_plain(y, 13, 6), y, g)
    assert torch.equal(got, want)
    # second order: the VJP is recorded when a graph of it is asked for
    x2 = t.clone().requires_grad_()
    m2, _, _ = xt.rolling_mean(x2, 13, 6)
    g1, = torch.autograd.grad(torch.nansum(m2 ** 2), x2, create_graph=True)
    h, = torch.autograd.grad(g1.sum(), x2)
    y2 = t.clone().requires_grad_()
    p2 = rolling.window_means_plain(y2, 13, 6)
    w1, = torch.autograd.grad(torch.nansum(p2 ** 2), y2, create_graph=True)
    hw, = torch.autograd.grad(w1.sum(), y2)
    assert torch.allclose(h, hw, rtol=1e-12, atol=1e-15)
    # through the windowed lengths, whose levels are the means
    lat = torch.linspace(-70, 70, 40, dtype=torch.float64)
    lon = torch.linspace(0, 357, 56, dtype=torch.float64)
    z = t.clone().requires_grad_()
    L, _, _ = xt.local_contour_lengths(z, lat, lon, window=13, stride=6,
                                       latlon=latlon)
    gz, = torch.autograd.grad(torch.nansum(L), z)
    assert torch.isfinite(gz).all() and gz.abs().sum() > 0


def test_cpu_takes_the_plain_version_and_no_function(monkeypatch):
    """CPU tensors: the wrapper runs the plain version and launches
    nothing; without a gradient rolling_mean applies no Function."""
    applied = []
    monkeypatch.setattr(dlocal._WindowMeans, "apply",
                        lambda *a: applied.append(1))
    before = rolling.KERNEL.launches
    t = _field(6, 2, 40, 56)
    got, _, _ = xt.rolling_mean(t, 13, 6)
    assert applied == [] and rolling.KERNEL.launches == before
    assert torch.equal(got, rolling.window_means_plain(t, 13, 6))
    with torch.no_grad():
        xt.rolling_mean(t.clone().requires_grad_(), 13, 6)
    assert applied == []


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _kernel_once(t, window, stride, min_count=1):
    before = rolling.KERNEL.launches
    got = rolling.window_means(t, window, stride, min_count)
    torch.cuda.synchronize()
    assert rolling.KERNEL.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("window,stride", WINDOWS)
def test_kernel_matches_the_emulation_bit_for_bit(cuda, window, stride):
    """The ERA5 shape in float32 at a Kelvin-scale offset, one launch,
    against the emulation on the card and two runs against each other."""
    t = _field(7, 4, 721, 1440, torch.float32, offset=300.0).to(cuda)
    got = _kernel_once(t, window, stride)
    assert _same_bits(got, emulate(t, window, stride))
    assert _same_bits(got, _kernel_once(t, window, stride))


@pytest.mark.cuda
def test_kernel_at_the_era5_local_step(cuda):
    """16 x 721 x 1440 at 101 / 10, as local_length_pipeline runs it:
    within a float32 ulp of the float64 direct means."""
    t = _field(8, 16, 721, 1440, torch.float32).to(cuda)
    got = _kernel_once(t, 101, 10)
    assert _same_bits(got, emulate(t, 101, 10))
    _within_an_ulp(got.cpu(), _direct(t, 101, 10).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("min_count", [0, 1, 81])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_min_count_dtype_and_nan(cuda, min_count, dtype):
    t = _field(9, 3, 61, 83, dtype)
    t[0, :20, 10:40] = NAN
    t[1] = NAN
    t = t.to(cuda)
    got = _kernel_once(t, 9, 4, min_count)
    assert _same_bits(got, emulate(t, 9, 4, min_count))
    _close(got.cpu(), rolling.window_means_plain(t.cpu(), 9, 4, min_count),
           1e-9 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
def test_kernel_past_65535_fields_and_at_the_edges(cuda):
    """65,537 fields of 4 x 8 (a launch takes 65,535), a window past the
    field (no launch), a window of MAX_WINDOW points."""
    t = _field(10, 65537, 4, 8, torch.float32).to(cuda)
    got = _kernel_once(t, 3, 1)
    _close(got.cpu(), rolling.window_means_plain(t.cpu().double(), 3, 1)
           .float(), 1e-6)
    before = rolling.KERNEL.launches
    assert rolling.window_means(t, 9, 1).shape == (65537, 0, 0)
    assert rolling.KERNEL.launches == before
    w = rolling.MAX_WINDOW
    big = _field(11, 1, w + 5, w + 2, torch.float32).to(cuda)
    got = _kernel_once(big, w, 2)
    assert _same_bits(got, emulate(big, w, 2))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    t = _field(12, 2, 40, 36, torch.float32).to(cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        rolling.window_means(t.half(), 5, 2)
    with pytest.raises(ValueError, match="at most"):
        rolling.window_means(t, rolling.MAX_WINDOW + 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rolling.window_means(t.transpose(-1, -2), 5, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        rolling.window_means(t.clone().requires_grad_(), 5, 2)
    # through rolling_mean a gradient goes through the Function
    x = t.clone().requires_grad_()
    m, _, _ = xt.rolling_mean(x, 5, 2)
    g, = torch.autograd.grad(torch.nansum(m), x)
    y = t.cpu().double().requires_grad_()
    w, = torch.autograd.grad(torch.nansum(
        rolling.window_means_plain(y, 5, 2)), y)
    assert torch.allclose(g.cpu().double(), w, rtol=1e-5, atol=1e-7)
