"""P1-P4, the kernel-ceiling probes (``xcontour_tpu_torch/kernels/probes.py``),
against the JAX bench's Pallas probes and a float64 oracle, and the port's
``kernel_rooflines`` on the CPU.

The JAX probes (``bench._lwa_structure_probe``, ``_hist_structure_probe``,
``_length_structure_probe`` and ``kernel_rooflines``' scaled copy) run in
interpret mode: ``pl.pallas_call`` is patched with ``interpret=True`` for
the test alone, and nothing in ``bench.py`` changes.  The TPU's P2 and P3
write one output block that every grid step revisits, so only the last
tile (P2, 32768 cells) or row block (P3, 16 cell rows) survives; the port
sums every tile.  Where the two agree (one tile, one row block) the plain
versions are held to the JAX probes; where they do not, the tests pin what
the JAX probe keeps.

Tolerances: the JAX probes' float32 outputs against the port's plain
versions run in float64 on the same float32 inputs, 1e-5 of the largest
magnitude (the probes' float32 sums of up to 10^5 terms); P4 bit for bit; float64
plain versions against a float64 numpy oracle of each formula, 1e-12 (the
order of the sums only); K2's lane decomposition (emulated in float64)
against the plain version, 1e-12.  Tests that need the card skip without
one (``-m cuda``; on the card's machine, which has no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_probes.py``).
"""

import functools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xcontour_tpu_torch.kernels import hist as kh
from xcontour_tpu_torch.kernels import probes as kp
from xcontour_tpu_torch.utils import roofline
from xcontour_tpu_torch.utils.synth import synth_pv

REPO = Path(__file__).resolve().parents[1]
F32_RTOL = 1e-5
F64_RTOL = 1e-12


@pytest.fixture
def bench(monkeypatch):
    """The JAX bench module, its Pallas calls in interpret mode."""
    sys.path.insert(0, str(REPO))
    import bench as mod
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _lwa_case(seed, B, Ny, Nx):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3).astype(np.float32)
    Q = np.sort(rng.standard_normal((B, Ny)) * 2.0, -1).astype(np.float32)
    W = rng.uniform(0.5, 1.5, (Ny, Nx)).astype(np.float32)
    return q, Q, W


def _hist_case(seed, B, G, N, nan=True):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, G)).astype(np.float32)
    e = np.sort(rng.standard_normal((B, N + 1)) * 1.2, -1).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (B, 2, G)).astype(np.float32)
    if nan:
        v[0, rng.choice(G, 500, replace=False)] = np.nan
    return v, e, w


def _length_case(seed, B, Ny, Nx, N):
    rng = np.random.default_rng(seed)
    d = (np.cumsum(rng.normal(size=(B, Ny, Nx)), 1)
         + 0.3 * rng.normal(size=(B, Ny, Nx))).astype(np.float32)
    lo, hi = np.nanmin(d, (1, 2)), np.nanmax(d, (1, 2))
    t = np.linspace(0.0, 1.0, N + 2)[1:-1]
    lev = (lo[:, None] + (hi - lo)[:, None] * t).astype(np.float32)
    yc = np.deg2rad(np.linspace(-60.0, 60.0, Ny)).astype(np.float32)
    xc = np.deg2rad(np.linspace(0.0, 348.0, Nx)).astype(np.float32)
    return d, lev, yc, xc


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _t64(*arrays):
    """float64 tensors of the (float32) test inputs: against a JAX probe
    the port runs in float64, so the probe's float32 sums are the only
    rounding (torch's float32 reductions change their order with the
    threads they get, by ~1e-5 on these sums)."""
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


# -- against the JAX probes ------------------------------------------------

def test_p1_matches_jax_probe(bench):
    """The JAX probe folds its rows in blocks of _TJ = 32, so its output
    summed over rows is the port's R summed over surfaces."""
    import jax.numpy as jnp
    q, Q, W = _lwa_case(1, 2, 64, 128)
    run, ops = bench._lwa_structure_probe(jnp.asarray(q), Q, W)
    want = np.asarray(run(jnp.asarray(q))).sum(1)
    got = kp.lwa_structure(*_t64(q, Q, W)).sum(1).numpy()
    assert ops == 2 * 64 * 64 * 128 * 3
    assert _rel(got, want) <= F32_RTOL


def test_p2_matches_jax_probe_at_one_tile(bench):
    """One tile of 32768 cells, N = 32 (a multiple of the probe's 16-level
    blocks), NaN values (which count 0) included."""
    import jax.numpy as jnp
    v, e, w = _hist_case(2, 2, 32768, 32)
    run, _ = bench._hist_structure_probe(jnp.asarray(v), e, w)
    want = np.asarray(run(jnp.asarray(v))).sum((1, 2))
    got = kp.hist_structure(*_t64(v, e, w)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= F32_RTOL


def test_p2_jax_probe_keeps_its_last_tile(bench):
    """At two tiles the JAX probe's output is the port's sum over the
    last 32768 cells alone."""
    import jax.numpy as jnp
    v, e, w = _hist_case(3, 2, 65536, 32)
    run, _ = bench._hist_structure_probe(jnp.asarray(v), e, w)
    jax_out = np.asarray(run(jnp.asarray(v))).sum((1, 2))
    last = kp.hist_structure(*_t64(v[:, 32768:], e, w[..., 32768:])).numpy()
    whole = kp.hist_structure(*_t64(v, e, w)).numpy()
    assert _rel(last, jax_out) <= F32_RTOL
    assert (np.abs(whole - jax_out) > 0.3 * np.abs(whole)).all()


def test_p3_matches_jax_probe_at_one_row_block(bench):
    """17 rows: 16 cell rows, one row block of the JAX probe."""
    import jax.numpy as jnp
    d, lev, yc, xc = _length_case(4, 2, 17, 48, 9)
    run, v00, _ = bench._length_structure_probe(
        jnp.asarray(d), jnp.asarray(lev), jnp.asarray(yc), jnp.asarray(xc))
    want = np.asarray(run(v00)).sum((1, 2))
    got = kp.length_structure(*_t64(d, lev, yc, xc)).numpy()
    assert _rel(got, want) <= F32_RTOL


def test_p3_jax_probe_keeps_its_last_row_block(bench):
    """40 rows: the port equals the nansum of K7's TPU kernel, and the JAX
    probe keeps its last row block (cell rows 32-38) alone."""
    import jax.numpy as jnp
    from xcontour_tpu.kernels.length_pallas import contour_lengths_pallas
    d, lev, yc, xc = _length_case(5, 2, 40, 48, 9)
    jd, jl, jy, jx = (jnp.asarray(a) for a in (d, lev, yc, xc))
    run, v00, _ = bench._length_structure_probe(jd, jl, jy, jx)
    jax_out = np.asarray(run(v00)).sum((1, 2))
    k7 = np.nansum(np.asarray(contour_lengths_pallas(
        jd, jl, jy, jx, latlon=True, interpret=True)), -1)
    got = kp.length_structure(*_t64(d, lev, yc, xc)).numpy()
    last = kp.length_structure(*_t64(d[:, 32:], lev, yc[32:], xc)).numpy()
    assert _rel(got, k7) <= F32_RTOL
    assert _rel(last, jax_out) <= F32_RTOL
    assert (jax_out < 0.5 * got).all()


def test_p4_bit_for_bit_with_jax():
    """q * 1.0000001 in float32, one rounding, as the JAX probe's copy;
    signed zeros, infinities and the largest floats too.  Subnormals: XLA
    on the CPU flushes them to zero, so they are held to numpy's IEEE
    product instead (the kernel, built without fast math, keeps them)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((3, 17, 40)) * 1e3).astype(np.float32)
    q[0, 0, :4] = [0.0, -0.0, np.inf, -np.inf]
    q[0, 1, :2] = [np.finfo(np.float32).max, -np.finfo(np.float32).max]
    got = kp.scaled_copy(torch.as_tensor(q)).numpy()
    want = np.asarray(jnp.asarray(q) * 1.0000001)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    sub = np.array([1e-40, -1e-42, 1.2e-38], np.float32)
    got = kp.scaled_copy(torch.as_tensor(sub)[None, None]).numpy()[0, 0]
    want = sub * np.float32(1.0000001)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:2] != 0).all()


# -- the plain versions in float64 against the formulas -------------------

def _oracle(name, rng):
    """(plain call, float64 numpy oracle) of each probe's formula."""
    if name == "lwa":
        q, Q, W = (a.astype(np.float64) for a in _lwa_case(7, 2, 40, 33))
        q[1, 3, 4] = np.nan
        want = (np.minimum(q[:, None] - Q[:, :, None, None], 0.0)
                * W).sum(2)
        return lambda: kp.lwa_structure(*_t(q, Q, W)), want
    if name == "hist":
        v, e, w = (a.astype(np.float64) for a in _hist_case(8, 3, 999, 13))
        v[1, :20] = e[1, 0] - 1.0            # below the first edge: N
        v[1, 20:40] = e[1, -1]               # at the top edge: 0
        v[1, 40:60] = np.inf
        v[2, :30] = e[2, 5]                  # on an edge
        w[2, 1, 7] = np.nan                  # a NaN weight propagates
        cnt = (v[:, :, None] < e[:, None, 1:]).sum(-1)
        want = ((w[:, 0] + w[:, 1]) * cnt).sum(-1)
        return lambda: kp.hist_structure(*_t(v, e, w)), want
    if name == "length":
        d, lev, yc, xc = (a.astype(np.float64)
                          for a in _length_case(9, 2, 23, 31, 7))
        lev[1, 2] = np.nan                   # a NaN level adds 0
        from xcontour_tpu import compat
        want = np.array([sum(
            compat._cells_total_length(d[b], lev[b, n], yc, xc, True)
            for n in range(lev.shape[1]) if np.isfinite(lev[b, n]))
            for b in range(2)])
        return lambda: kp.length_structure(*_t(d, lev, yc, xc)), want
    q = rng.standard_normal((2, 9, 14))
    return lambda: kp.scaled_copy(torch.as_tensor(q)), q * 1.0000001


@pytest.mark.parametrize("name", ["lwa", "hist", "length", "copy"])
def test_plain_versions_match_float64_oracle(name):
    fn, want = _oracle(name, np.random.default_rng(10))
    got = fn().numpy()
    assert got.dtype == np.float64
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    assert np.abs(got[m] - want[m]).max() <= F64_RTOL * np.abs(want[m]).max()


def test_p2_edge_counts_follow_k2s_bins():
    """A value in [e_0, e_N) lies above N - bin of the N upper edges (the
    bin K2's digitize gives), below e_0 under all N, at or above e_N and
    NaN under none."""
    v, e, _ = _hist_case(11, 2, 4000, 17)
    v[0, :50] = e[0, 0] - 0.5
    v[0, 50:100] = e[0, -1]
    v[1, :50] = e[1, 3]
    vt, et = _t(v, e)
    cnt = kp.edges_above(vt, et).numpy()
    idx, valid = kh.digitize(vt, et)
    inside = valid.numpy() & (v < e[:, -1:])
    assert np.array_equal(cnt[inside], (17 - idx.numpy())[inside])
    assert (cnt[v < e[:, :1]] == 17).all()
    assert (cnt[~(v < e[:, -1:])] == 0).all()


# -- P2's lane decomposition, as hist_structure_kernel cuts it ---------------

def _find_bin_guess(e, x, inv):
    """hist.cu's find_bin_guess for e[0] <= x < e[N], float32 guess."""
    f = np.float32
    N = len(e) - 1
    k = int(min(max(f(f(f(x) - f(e[0])) * f(inv)), f(0.0)), f(N - 1)))
    if e[k] <= x:
        if k == N - 1 or x < e[k + 1]:
            return k
        if k + 1 == N - 1 or x < e[k + 2]:
            return k + 1
    elif k > 0 and e[k - 1] <= x:
        return k - 1
    return int(np.searchsorted(e[1:N], x, side="right"))


def _p2_emulate(v, e, w, sms=132):
    """P2 as the kernel cuts it, float64: K2's grid, a lane's every 32nd
    cell of its warp's run 4 at a time, its current bin reused while values
    stay in it, one sum a lane, then the block's and the batch's folds.
    Returns (S, searches)."""
    B, G = v.shape
    N = e.shape[1] - 1
    nblk, wchunk, _ = kh.plan(B, G, N, 2, sms)
    S, searches = np.zeros(B), 0
    for b in range(B):
        eb = e[b]
        inv = np.float32(N) / np.float32(eb[N] - eb[0]) if eb[N] > eb[0] else 0
        parts = []
        for blk in range(nblk):
            lanes = []
            for warp in range(kh.WARPS):
                start = (blk * kh.WARPS + warp) * wchunk
                end = min(G, start + wchunk)
                for lane in range(32):
                    k, lo, hi, s = 0, np.inf, -np.inf, 0.0
                    for g in range(start + lane, end, 32):
                        x = v[b, g]
                        if x < eb[0]:
                            cnt = N
                        elif not x < eb[N]:
                            cnt = 0
                        else:
                            if not (lo <= x < hi):
                                k = _find_bin_guess(eb, x, inv)
                                lo, hi = eb[k], eb[k + 1]
                                searches += 1
                            cnt = N - k
                        s += (w[b, 0, g] + w[b, 1, g]) * cnt
                    lanes.append(s)
            parts.append(np.sum(lanes))
        S[b] = np.sum(parts)
    return S, searches


@pytest.mark.parametrize("kind", ["noise", "banded"])
def test_p2_emulation_matches_plain(kind):
    rng = np.random.default_rng(12)
    B, G, N = 2, 6000, 21
    if kind == "noise":
        v = rng.standard_normal((B, G))
    else:   # zonal bands: runs of one bin along a lane
        v = np.repeat(np.linspace(-2.0, 2.0, G // 200), 200)[None].repeat(B, 0)
        v = v + 1e-3 * rng.standard_normal((B, G))
    v[0, :7] = np.nan
    e = np.sort(rng.uniform(-2.5, 2.5, (B, N + 1)), -1)
    w = rng.uniform(0.5, 1.0, (B, 2, G))
    got, searches = _p2_emulate(v, e, w)
    want = kp.hist_structure_plain(*_t(v, e, w)).numpy()
    assert np.abs(got - want).max() <= F64_RTOL * np.abs(want).max()
    valid = int((v >= e[:, :1]).sum())
    if kind == "banded":   # a lane's bin is reused along a band
        assert searches < valid / 2


# -- records, wrappers on the CPU, the roofline path -----------------------

def test_records_name_pallas_call_sites():
    lines = (REPO / "bench.py").read_text().splitlines()
    names = set()
    for r in kp.PROBES:
        path, line = r.replaces.split(":")
        assert path == "bench.py"
        assert "pl.pallas_call(" in lines[int(line) - 1]
        assert (REPO / r.source).is_file()
        names.add(r.name)
    assert len(names) == 4


def test_cpu_wrappers_run_the_plain_versions_uncounted():
    q, Q, W = _t64(*_lwa_case(13, 2, 20, 36))
    before = [r.launches for r in kp.PROBES]
    for got, want in (
            (kp.lwa_structure(q, Q, W), kp.lwa_structure_plain(q, Q, W)),
            (kp.scaled_copy(q), kp.scaled_copy_plain(q))):
        torch.testing.assert_close(got, want, rtol=F64_RTOL, atol=0.0)
    assert [r.launches for r in kp.PROBES] == before


def test_kernel_rooflines_on_the_cpu():
    """The path at a tiny size on the CPU: four entries with every field
    finite, K1 and P4 on the batch alone (no L2 to pass)."""
    v, _ = synth_pv(nlev=2, nlat=33, nlon=64, seed=1)
    res = roofline.kernel_rooflines(v["latitude"], v["longitude"],
                                    v["pv"][0], batch=2, N=9, device="cpu")
    assert res["device"] == "cpu" and res["shape"] == [2, 33, 64]
    assert res["copy_stack"] == 2
    probes = {r.name for r in kp.PROBES}
    seen = set()
    for key in ("stencil", "hist_cdf2", "lwa", "length"):
        row = res[key]
        seen.add(row["probe"])
        for k, x in row.items():
            if k not in ("kernel", "probe", "bound_by", "probe_bound_by"):
                assert math.isfinite(x) and x > 0, (key, k, x)
    assert seen == probes
    assert res["stencil"]["probe_bytes"] == 8 * res["copy_stack"] * 33 * 64
    # P2 and P3 write one float a batch element where K2 writes (B, 2, N)
    # and K7 (B, N); their ceilings count the kernels' own work
    for key, out in (("hist_cdf2", 2 * 2 * 9), ("length", 2 * 9)):
        row = res[key]
        assert row["bytes"] - row["probe_bytes"] == 4 * (out - 2)
        assert row["instructions"] == row["probe_instructions"]
        assert row["pct_of_structure_ceiling"] == pytest.approx(
            100 * row["probe_ms"] / row["ms"])


def test_roofline_inputs_are_the_timed_ones():
    """roofline_inputs gives the same tensors each call (numpy seed 0), at
    the shapes kernel_rooflines times: the batch, its stack, N + 1 edges
    and N levels over the batch's range, two weight channels."""
    v, _ = synth_pv(nlev=2, nlat=33, nlon=64, seed=1)
    args = (v["latitude"], v["longitude"], v["pv"][0], 3, 9)
    a = roofline.roofline_inputs(*args, device="cpu")
    b = roofline.roofline_inputs(*args, device="cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].dtype == torch.float32 and a[k].is_contiguous(), k
    assert a["q"].shape == (3, 33, 64) and torch.equal(a["qs"], a["q"])
    assert a["vals"].shape == (3, 33 * 64) and a["wts"].shape == (3, 2, 33 * 64)
    assert a["edges"].shape == (3, 10) and a["levels"].shape == (3, 9)
    assert a["Q"].shape == (3, 33) and a["W"].shape == (33, 64)
    assert float(a["edges"][0, 0]) == float(a["q"].min())
    assert float(a["levels"][0, -1]) == float(a["q"].max())


def test_smoke_and_probes_import_no_jax():
    """chip_smoke.py, the probes and the roofline path import nothing of
    JAX, of the JAX package or of its bench (a fresh interpreter)."""
    import subprocess
    code = ("import sys, chip_smoke, xcontour_tpu_torch.kernels.probes, "
            "xcontour_tpu_torch.utils.roofline; "
            "bad = [m for m in ('jax', 'xcontour_tpu', 'bench') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_bound_models():
    assert roofline.bound_ms((3.35e9, 0)) == (1.0, "bytes")
    assert roofline.bound_ms((0, 33.5e9)) == (1.0, "operations")
    # the bounds at the ERA5 step (P1, K2) and of P4 on a 256 MB stack
    assert roofline.bound_ms(roofline.lwa_work(15, 721, 1440))[0] == \
        pytest.approx(1.0055, abs=1e-4)
    assert roofline.bound_ms(roofline.copy_work(62, 721, 1440))[0] == \
        pytest.approx(0.1537, abs=1e-4)
    assert roofline.bound_ms(roofline.cdf_work(15, 721 * 1440, 241, 2))[0] \
        == pytest.approx(0.0558, abs=1e-4)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lwa", "hist", "length", "copy"])
def test_kernels_match_plain_versions_on_the_card(cuda, name):
    """Each probe against its plain version on the same CUDA tensors: P1
    within K3's 1.5e-4, P2 and P3 within 1e-5 of the float64 plain
    version and two runs bit for bit, P4 bit for bit."""
    if name == "lwa":
        args = [a.to(cuda) for a in _t(*_lwa_case(14, 3, 200, 300))]
        fn, plain, rtol = kp.lwa_structure, kp.lwa_structure_plain, 1.5e-4
    elif name == "hist":
        args = [a.to(cuda) for a in _t(*_hist_case(15, 3, 70000, 121))]
        fn, plain, rtol = kp.hist_structure, kp.hist_structure_plain, 1e-5
    elif name == "length":
        args = [a.to(cuda) for a in _t(*_length_case(16, 3, 150, 300, 41))]
        fn, plain, rtol = kp.length_structure, kp.length_structure_plain, 1e-5
    else:
        args = [a.to(cuda) for a in _t(*_lwa_case(17, 3, 70, 301)[:1])]
        fn, plain, rtol = kp.scaled_copy, kp.scaled_copy_plain, 0.0
    record = next(r for r in kp.PROBES if r.name.startswith(name))
    before = record.launches
    got = fn(*args)
    assert record.launches == before + 1
    if name == "copy":
        assert _same_bits(got, plain(*args))
        return
    if name != "lwa":
        assert _same_bits(fn(*args), got)
        args = [a.double() for a in args]
    want = plain(*args)
    assert (got.double() - want.double()).abs().max() <= \
        rtol * want.double().abs().max()
