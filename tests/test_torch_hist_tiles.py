"""The decompositions of K2 (``xcontour_tpu_torch/csrc/hist.cu``) and K1
(``csrc/stencil.cu``), emulated on the CPU.

The CUDA kernels run only on the card, but the way they cut the work can be
checked here.  K2: the grid that ``kernels.hist.plan`` sizes from the SM
count, warps owning contiguous runs of cells, each lane taking every 32nd
cell of its warp's run 4 at a time, keeping its current bin and one running
sum per channel and flushing them to histogram copy ``lane % ncopy`` when a
value leaves the bin, the new bin guessed from even spacing and checked
against the edges, each launch taking the bins ``kernels.hist.bin_range``
allows (values inside the range's edges only, where the edges and one
channel group's histogram outgrow shared memory), the copies folded in
order into the block's partial,
the partials summed by 8 warps and folded in warp order, and the block scan
of the bin totals (per-thread segments, shuffle scans).  K1: lanes marching
down strips of 16 rows over 4 or 1 columns, carrying the rows above, at
and below, with the x neighbours from the neighbouring lanes.

Tolerances: K2's emulation runs in float64 and differs from the plain
version only in summation order, so it must agree to 1e-12 of the plain
output's largest magnitude, NaN pattern identical.  K1's emulation runs in
float32 with the kernel's operations in the kernel's order (no FMA), so it
must equal the plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from xcontour_tpu_torch.kernels import hist as kh
from xcontour_tpu_torch.kernels import stencil as ks
from xcontour_tpu_torch.ops import histogram as th

F64_RTOL = 1e-12
THREADS = 256
UNROLL = 4
H100_SMS = 132


def _find_bin(e, x):
    """upper bound among e[1..N-1] minus one; the top edge to N-1"""
    N = len(e) - 1
    if x == e[N]:
        return N - 1
    lo, hi = 1, N
    while lo < hi:
        mid = (lo + hi) >> 1
        if e[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def _find_bin_guess(e, x, inv):
    """hist.cu's find_bin_guess in float32: the bin even spacing gives,
    checked with its neighbours against the edges, else the search."""
    f = np.float32
    N = len(e) - 1
    if x == e[N]:
        return N - 1
    gf = min(max(f(f(f(x) - f(e[0])) * f(inv)), f(0.0)), f(N - 1))
    k = 0 if np.isnan(gf) else int(gf)
    if e[k] <= x:
        if k == N - 1 or x < e[k + 1]:
            return k
        if k + 1 == N - 1 or x < e[k + 2]:
            return k + 1
    elif k > 0 and e[k - 1] <= x:
        return k - 1
    return _find_bin(e, x)


def _inv_spacing(e):
    N = len(e) - 1
    return np.float32(N) / np.float32(e[N] - e[0]) if e[N] > e[0] else 0.0


def _block_scan(x):
    """hist.cu's block_scan: segments of ceil(N / 256) bins a thread, an
    inclusive shuffle scan of the segment totals in each warp, then of the
    8 warp totals."""
    N = len(x)
    per = -(-N // THREADS)
    seg = [(min(N, t * per), min(N, t * per + per)) for t in range(THREADS)]
    tot = np.array([x[a:b].sum() if b > a else 0.0 for a, b in seg])
    incl = tot.reshape(THREADS // 32, 32).copy()
    d = 1
    while d < 32:
        incl[:, d:] = incl[:, d:] + incl[:, :-d].copy()
        d *= 2
    wsum = incl[:, -1].copy()
    d = 1
    while d < len(wsum):
        wsum[d:] = wsum[d:] + wsum[:-d].copy()
        d *= 2
    out = np.empty(N)
    for t, (a, b) in enumerate(seg):
        w, lane = divmod(t, 32)
        run = (incl[w, lane] - tot[t]) + (wsum[w - 1] if w > 0 else 0.0)
        for k in range(a, b):
            run += x[k]
            out[k] = run
    return out


def _k2_emulate(v, e, w, sms=H100_SMS):
    """K2 as the kernel cuts it, float64 numpy: returns the (B, C, N) CDF
    and the counts of valid cells and of flushes of a lane's sums."""
    B, C, G = w.shape
    N = e.shape[1] - 1
    nrange = kh.bin_range(N, C)
    nblk, wchunk, ncopy = kh.plan(B, G, nrange, C, sms)
    assert wchunk % kh.STEP == 0 and nblk * kh.WARPS * wchunk >= G
    partial = np.zeros((B, nblk, C, N))
    stats = dict(cells=0, flushes=0, ranges=-(-N // nrange))
    for b in range(B):
        for k0 in range(0, N, nrange):
            # the launch's edges e[k0 .. k0 + nb]; below the last range the
            # top edge is exclusive
            nb = min(nrange, N - k0)
            eb = e[b, k0:k0 + nb + 1]
            last = k0 + nb == N
            inv = _inv_spacing(eb)
            for c0 in range(0, C, kh.GROUP):
                cg = min(kh.GROUP, C - c0)
                for blk in range(nblk):
                    h = np.zeros((ncopy, cg, nb))
                    for warp in range(kh.WARPS):
                        start = (blk * kh.WARPS + warp) * wchunk
                        end = min(G, start + wchunk)
                        for lane in range(32):
                            hl = h[lane % ncopy]
                            k, lo, hi = -1, np.inf, -np.inf
                            s = np.zeros(cg)
                            for base in range(start, end, kh.STEP):
                                for u in range(UNROLL):
                                    g = base + u * 32 + lane
                                    if g >= end:
                                        continue
                                    x = v[b, g]
                                    if not (eb[0] <= x and (x < eb[nb] or
                                                            (last and x == eb[nb]))):
                                        continue
                                    stats["cells"] += 1
                                    if not (lo <= x < hi):
                                        if k >= 0:
                                            hl[:, k] += s
                                            stats["flushes"] += 1
                                        k = _find_bin_guess(eb, x, inv)
                                        lo = eb[k]
                                        hi = np.inf if k == nb - 1 else eb[k + 1]
                                        s = np.zeros(cg)
                                    wt = w[b, c0:c0 + cg, g]
                                    s = s + np.where(np.isnan(wt), 0.0, wt)
                            if k >= 0:
                                hl[:, k] += s
                                stats["flushes"] += 1
                    acc = h[0].copy()
                    for j in range(1, ncopy):
                        acc = acc + h[j]
                    partial[b, blk, c0:c0 + cg, k0:k0 + nb] = acc
    out = np.empty((B, C, N))
    for b in range(B):
        for c in range(C):
            sw = [partial[b, i::kh.WARPS, c].sum(0) if i < nblk
                  else np.zeros(N) for i in range(kh.WARPS)]
            tot = sw[0].copy()
            for j in range(1, kh.WARPS):
                tot = tot + sw[j]
            out[b, c] = _block_scan(tot)
    return out, stats


def _plain(v, e, w):
    return kh.weighted_cdf_plain(*(torch.as_tensor(a) for a in (v, e, w))).numpy()


def _agree(got, want, rtol=F64_RTOL):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    assert np.array_equal(m, np.isfinite(got))
    scale = max(np.abs(want[m]).max(), 1e-300)
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


def _edges_of(v, N):
    """The ops layer's edges for N levels spanning each row's range."""
    lo, hi = np.nanmin(v, 1), np.nanmax(v, 1)
    bins = lo[:, None] + (hi - lo)[:, None] * np.linspace(0.0, 1.0, N)[None]
    bins[:, -1] = hi
    _, edges = th._edges(torch.as_tensor(bins))
    return edges.numpy()


def _banded(rng, B, Ny, Nx):
    """PV-like: rising with the row, a zonal wave and weak noise."""
    y = np.linspace(-1.0, 1.0, Ny)[:, None]
    x = np.linspace(0.0, 2 * np.pi, Nx, endpoint=False)[None]
    f = np.stack([3.0 * y + 0.2 * np.sin((b + 2) * x) * np.cos(np.pi * y)
                  for b in range(B)])
    return (f + 1e-3 * rng.standard_normal(f.shape)).reshape(B, -1)


def _weights(rng, B, C, G):
    return rng.uniform(0.5, 1.5, (B, C, G))


def _case(kind, seed=0, C=2):
    """(values (B, G), edges (B, N+1), weights (B, C, G))."""
    rng = np.random.default_rng(seed)
    if kind == "banded":
        B, Ny, Nx, N = 2, 16, 1440, 25
        v = _banded(rng, B, Ny, Nx)
        return v, _edges_of(v, N), _weights(rng, B, C, v.shape[1])
    if kind == "noise":
        B, G, N = 2, 3000, 33
        v = rng.uniform(-1.0, 1.0, (B, G))
        e = _edges_of(v, N)
        # spread over [e0, e_top]: no runs to aggregate
        v = e[:, :1] + (e[:, -1:] - e[:, :1]) * rng.uniform(0.0, 1.0, (B, G))
        return v, e, _weights(rng, B, C, G)
    if kind == "constant":
        v = np.full((2, 700), 3.25)
        return v, np.full((2, 18), 3.25), _weights(rng, 2, C, 700)
    if kind == "on_edges":
        v = rng.standard_normal((2, 1500))
        e = _edges_of(v, 21)
        for b in range(2):
            v[b, :22] = e[b]                       # every edge, the top too
            v[b, 100:300] = e[b, rng.integers(1, 21, 200)]
            v[b, 400:410] = e[b, -1]
        return v, e, _weights(rng, 2, C, 1500)
    if kind == "nan":
        v = _banded(rng, 2, 20, 64)
        e = _edges_of(v, 17)
        v[0, 50:90] = np.nan                       # NaN values
        v[1, 700:705] = np.nan
        w = _weights(rng, 2, C, v.shape[1])
        w[0, 0, 10:30] = np.nan                    # NaN weights
        w[1, C - 1, 900:1000] = np.nan
        return v, e, w
    if kind == "below":
        v = _banded(rng, 2, 20, 64)
        e = _edges_of(v, 17)
        v[0, 200:260] = e[0, 0] - 1.0              # below the prepended edge
        v[1, ::7] = e[1, 0] - 1e-3
        v[1, 3::11] = e[1, -1] + 1e-3              # above the top edge
        return v, e, _weights(rng, 2, C, v.shape[1])
    if kind == "ragged":
        v = _banded(rng, 2, 37, 29)                # G = 1073
        assert v.shape[1] % kh.STEP
        return v, _edges_of(v, 19), _weights(rng, 2, C, v.shape[1])
    raise ValueError(kind)


KINDS = ["banded", "noise", "constant", "on_edges", "nan", "below", "ragged"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("many_blocks", [False, True])
def test_k2_emulation_matches_plain(kind, many_blocks, monkeypatch):
    """Each input family, with the grid the wrapper plans and with blocks
    of at least 128 cells (many blocks, warps past the end of G)."""
    if many_blocks:
        monkeypatch.setattr(kh, "MIN_CELLS", 128)
    v, e, w = _case(kind)
    got, stats = _k2_emulate(v, e, w)
    want = _plain(v, e, w)
    _agree(got, want)
    if kind == "constant":
        assert (got[..., :-1] == 0).all()
        np.testing.assert_allclose(got[..., -1], w.sum(-1), rtol=1e-13)
    if kind == "banded" and not many_blocks:
        # a lane's sums leave its registers only where its bin changes
        assert stats["flushes"] * 4 < stats["cells"]


@pytest.mark.parametrize("C", list(range(1, 10)))
def test_k2_emulation_channels(C):
    """1 to 8 channels in one first-pass launch, 9 in two."""
    for kind in ("banded", "nan"):
        v, e, w = _case(kind, seed=C, C=C)
        got, _ = _k2_emulate(v, e, w)
        _agree(got, _plain(v, e, w))


@pytest.mark.parametrize("descending", [False, True])
def test_k2_emulation_table_build(descending):
    """The A(Y_eq) table build's K2 input: each row's coordinate under a
    NaN mask, N = Ny bins, one channel of cell areas; the coordinate in
    either order.  A lane's values mostly share a row of ERA5's width, so
    its sums leave the registers far less often than once a cell."""
    Ny, Nx = 37, 1440
    rng = np.random.default_rng(11)
    y = np.linspace(-90.0, 90.0, Ny)
    if descending:
        y = y[::-1].copy()
    mask = rng.uniform(size=(Ny, Nx)) > 0.1
    dA = np.cos(np.deg2rad(y))[:, None] * rng.uniform(0.9, 1.1, (Ny, Nx))
    ctr = np.where(mask, y[:, None], np.nan).reshape(1, -1)
    _, edges = th._edges(torch.as_tensor(y)[None])
    v, e, w = ctr, edges.numpy(), dA.reshape(1, 1, -1)
    got, stats = _k2_emulate(v, e, w)
    _agree(got, _plain(v, e, w))
    assert stats["flushes"] * 4 < stats["cells"]


@pytest.mark.parametrize("spacing", ["even", "uneven", "constant"])
def test_k2_guessed_bin_is_the_searched_bin(spacing):
    """The guess from even spacing never changes the bin: float32 edges
    evenly spaced (the contour levels), unevenly (an x-z section's depth
    levels) or all equal, values on, between and around every edge."""
    rng = np.random.default_rng(5)
    N = 241
    if spacing == "even":
        e = np.float32(-3.0) + np.float32(0.025) * np.arange(N + 1,
                                                             dtype=np.float32)
    elif spacing == "uneven":
        e = np.sort(rng.uniform(-5.0, 0.0, N + 1) ** 3).astype(np.float32)
    else:
        e = np.full(N + 1, 1.5, np.float32)
    xs = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                         np.nextafter(e, np.float32(-np.inf)),
                         rng.uniform(e[0], e[-1], 4000).astype(np.float32)])
    xs = xs[(xs >= e[0]) & (xs <= e[-1])]
    inv = _inv_spacing(e)
    for x in xs:
        assert _find_bin_guess(e, x, inv) == _find_bin(e, x)


@pytest.mark.parametrize("B,sms", [(1, 132), (15, 132), (64, 132), (1, 8)])
def test_k2_plan_fills_the_card(B, sms):
    """The ERA5 table build (one element of 721x1440) gets about 4 blocks an
    SM, a 15-level step as many in all; warp runs cover G with fewer than
    one step of slack each."""
    G, N, C = 721 * 1440, 241, 2
    nblk, wchunk, ncopy = kh.plan(B, G, N, C, sms)
    assert 0.5 * kh.BLOCKS_PER_SM * sms <= B * nblk or nblk * kh.MIN_CELLS >= G
    assert B * nblk <= 2 * kh.BLOCKS_PER_SM * sms or nblk == 1
    assert (nblk - 1) * kh.WARPS * wchunk < G <= nblk * kh.WARPS * wchunk
    assert ncopy == 16


def test_k2_plan_copies_shrink_to_fit():
    """Up to 32 copies while they fit in 32 KB, down to one copy of any
    histogram the shared memory holds."""
    G = 10 ** 6
    assert kh.plan(1, G, 241, 2, 132)[2] == 16    # the ERA5 step
    assert kh.plan(1, G, 401, 5, 132)[2] == 4     # clength: 5 x 401 bins
    assert kh.plan(1, G, 721, 1, 132)[2] == 8     # the table build
    assert kh.plan(1, G, 33, 1, 132)[2] == 32
    assert kh.plan(1, G, 4000, 8, 132)[2] == 1


def _ranges_of(n, cg):
    """A shared-memory limit that leaves one launch n bins of cg channels."""
    return 4 * (1 + (cg + 1) * n)


@pytest.mark.parametrize("kind", KINDS)
def test_k2_bin_ranges_match_plain(kind, monkeypatch):
    """Each input family with the histogram cut into ranges of 6 bins:
    values on a range's first edge land in it, values on its last edge in
    the next one, the top edge in the last; weights below a range reach
    its bins through the scan."""
    monkeypatch.setattr(kh, "SMEM_LIMIT", _ranges_of(6, 2))
    v, e, w = _case(kind)
    assert kh.bin_range(e.shape[1] - 1, 2) == 6
    got, stats = _k2_emulate(v, e, w)
    assert stats["ranges"] > 1
    _agree(got, _plain(v, e, w))


@pytest.mark.parametrize("C", [1, 3, 9])
def test_k2_bin_ranges_with_channel_groups(C, monkeypatch):
    """Ranges of 5 bins times one or two channel groups."""
    monkeypatch.setattr(kh, "SMEM_LIMIT", _ranges_of(5, min(C, kh.GROUP)))
    v, e, w = _case("nan", seed=C, C=C)
    got, stats = _k2_emulate(v, e, w)
    assert stats["ranges"] == -(-17 // 5)
    _agree(got, _plain(v, e, w))


def test_k2_bin_ranges_at_the_shared_memory_limit():
    """N = 20,000 bins of 2 channels: (N + 1 + 2N) floats pass 227 KB, so
    the launches take two ranges of at most 19,370 bins."""
    rng = np.random.default_rng(13)
    N, G = 20000, 3000
    e = np.sort(rng.standard_normal((1, N + 1)), -1)
    v = rng.standard_normal((1, G)) * 1.1
    v[0, :30] = e[0, rng.integers(0, N + 1, 30)]     # on edges
    v[0, 30:40] = e[0, 19370]                        # the second range's first
    v[0, 40] = np.nan
    w = rng.uniform(0.5, 1.5, (1, 2, G))
    got, stats = _k2_emulate(v, e, w)
    assert stats["ranges"] == 2
    _agree(got, _plain(v, e, w))


@pytest.mark.parametrize("N,C,want", [(4000, 16, 4000), (4000, 8, 4000),
                                      (20000, 2, 19370), (19370, 2, 19370),
                                      (19371, 2, 19370), (29055, 1, 29055),
                                      (29056, 1, 29055), (6000, 9, 6000),
                                      (6500, 9, 6456), (241, 2, 241)])
def test_k2_bin_range_counts_one_channel_group(N, C, want):
    """One launch holds N + 1 edges and one group of at most 8 channels:
    16 channels at 4,000 bins need no ranges (two launches of 8); a range
    is the most bins that fit, and one more would not."""
    R = kh.bin_range(N, C)
    assert R == want
    cg = min(C, kh.GROUP)
    floats = kh.SMEM_LIMIT // 4
    assert R + 1 + cg * R <= floats
    if R < N:
        assert R + 2 + cg * (R + 1) > floats
    # the copies follow the range: one copy of the largest histograms
    assert kh.plan(1, 10 ** 6, R, C, 132)[2] >= 1


STRIP = 16


def _k1_emulate(q, rdx, rdy, *, periodic_x, bc_y, aligned=True):
    """K1 as the kernel cuts it, float32 numpy: V = 4 columns a lane where 4
    divides Nx and the pointers are 16-byte ``aligned``, else 1; tiles of 32 lanes, strips of 16 rows,
    each lane carrying the rows above, at and below; the x neighbours of a
    lane's first and last columns from the neighbouring lanes (lanes past
    Nx shadow the last group) or, at the tile's edges and the last group,
    loaded."""
    f = np.float32
    B, Ny, Nx = q.shape
    V = 4 if Nx % 4 == 0 and aligned else 1
    out = np.full(q.shape, np.nan, np.float32)
    half, zero = f(0.5), f(0.0)
    lanes = np.arange(32)
    for t0 in range(0, Nx, 32 * V):
        x0 = t0 + lanes * V
        xc = np.minimum(x0, Nx - V)
        if periodic_x:
            xl = np.where(xc == 0, Nx - 1, xc - 1)
            xr = np.where(xc + V == Nx, 0, xc + V)
        else:
            xl, xr = np.maximum(xc - 1, 0), np.minimum(xc + V, Nx - 1)
        load_l = lanes == 0
        load_r = (lanes == 31) | (x0 + V >= Nx)
        keep = x0 < Nx
        cols = xc[:, None] + np.arange(V)[None]            # (lane, v)
        for y0 in range(0, Ny, STRIP):
            y1 = min(Ny, y0 + STRIP)
            up = q[:, y0 - 1][:, cols] if y0 > 0 else np.zeros((B, 32, V), f)
            c = q[:, y0][:, cols]
            for y in range(y0, y1):
                dn = q[:, y + 1][:, cols] if y + 1 < Ny else np.zeros((B, 32, V), f)
                last, first = c[:, :, V - 1], c[:, :, 0]
                sl = np.concatenate([last[:, :1], last[:, :-1]], 1)   # shfl_up
                sr = np.concatenate([first[:, 1:], first[:, -1:]], 1)  # shfl_down
                edge_l = np.where(load_l, q[:, y, xl], sl)
                edge_r = np.where(load_r, q[:, y, xr], sr)
                left = np.concatenate([edge_l[..., None], c[:, :, :-1]], 2)
                right = np.concatenate([c[:, :, 1:], edge_r[..., None]], 2)
                with np.errstate(invalid="ignore"):
                    if periodic_x:
                        qx = (right - left) * half
                    else:
                        qx = np.where(cols == 0, right - c,
                                      np.where(cols == Nx - 1, c - left,
                                               (right - left) * half))
                    if (y == 0 or y == Ny - 1) and bc_y == "reflect":
                        r1 = q[:, 1][:, cols]
                        qy = (r1 - r1) * zero
                    elif y == 0:
                        qy = dn - c if bc_y == "extend" else dn * half
                    elif y == Ny - 1:
                        qy = c - up if bc_y == "extend" else -up * half
                    else:
                        qy = (dn - up) * half
                    gx = qx * rdx[y][cols]
                    gy = qy * rdy[y]
                    val = gx * gx + gy * gy
                out[:, y, cols[keep].ravel()] = val[:, keep].reshape(B, -1)
                up, c = c, dn
    return out


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("bc", ["extend", "fill", "reflect"])
@pytest.mark.parametrize("Ny,Nx", [(77, 140), (33, 70), (2, 5), (40, 260)])
def test_k1_strip_march_matches_plain_bit_for_bit(periodic, bc, Ny, Nx):
    """All six modes; 4 and 1 columns a lane (Nx = 70 and 5 take one); Ny not a multiple of the
    strip (77, 33, 40) or a single two-row strip, Nx not a multiple of a
    tile (140 = 128 + 12, 260 = 256 + 4); NaN cells, a NaN in row 1 (the
    'reflect' walls read it)."""
    rng = np.random.default_rng(Ny * Nx)
    q = rng.standard_normal((2, Ny, Nx)).cumsum(-1).cumsum(-2).astype(np.float32)
    q[1, Ny // 2, Nx // 3] = np.nan
    q[0, 1, Nx // 2] = np.nan
    rdx = (1.0 / rng.uniform(0.5, 2.0, (Ny, Nx))).astype(np.float32)
    rdy = (1.0 / rng.uniform(0.5, 2.0, Ny)).astype(np.float32)
    got = _k1_emulate(q, rdx, rdy, periodic_x=periodic, bc_y=bc)
    want = ks.squared_gradient_plain(*(torch.as_tensor(a) for a in (q, rdx, rdy)),
                                     periodic_x=periodic, bc_y=bc).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("bc", ["extend", "fill", "reflect"])
def test_k1_unaligned_one_column_a_lane_matches_plain(periodic, bc):
    """A pointer off 16 bytes sends a row length that 4 divides to one
    column a lane: 140 columns are 4 full tiles of 32 lanes and 12 lanes of
    a fifth, the lanes past Nx shadowing the last column."""
    Ny, Nx = 37, 140
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, Ny, Nx)).cumsum(-1).astype(np.float32)
    q[0, 1, 7] = np.nan
    rdx = (1.0 / rng.uniform(0.5, 2.0, (Ny, Nx))).astype(np.float32)
    rdy = (1.0 / rng.uniform(0.5, 2.0, Ny)).astype(np.float32)
    got = _k1_emulate(q, rdx, rdy, periodic_x=periodic, bc_y=bc, aligned=False)
    want = ks.squared_gradient_plain(*(torch.as_tensor(a) for a in (q, rdx, rdy)),
                                     periodic_x=periodic, bc_y=bc).numpy()
    np.testing.assert_array_equal(got, want)
