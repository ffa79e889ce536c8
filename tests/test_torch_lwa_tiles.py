"""The decompositions of K3 and K4 (``xcontour_tpu_torch/csrc/lwa.cu``),
emulated on the CPU.

The CUDA kernels run only on the card, but the way they cut the work can be
checked here.  K4: blocks of 32 columns and 8 warps of 16 surfaces,
64-row panels cut per warp into rows on the side ``y < j`` of all its
surfaces, rows that straddle them (the side chosen per surface) and rows on
the side ``y >= j``, all in the mask-free form; parts skipping the side
they zero; and a block flag for infinite staged values, weights or
register operands that sends a panel to the exact product form.  K3: the E t-term scanned in chunks of
rows, each chunk's carry-in added afterwards.

Tolerances: K4's emulation runs in float64 and differs from the plain
version only in summation order, so it must agree to 1e-12 of the plain
output's largest magnitude, NaN pattern identical.  K3's chunked scan runs
in float32 and is held at the 'lin' bound, 1.5e-4 of the field maximum
(tests/test_lwa_fast.py:254), against the serial scan and the float64
oracle.
"""

import numpy as np
import pytest
import torch

from xcontour_tpu_torch.kernels import lwa as kl

from test_torch_lwa import _case, _era_like

F64_RTOL = 1e-12
LIN_BOUND = 1.5e-4
# columns, warps a block, surfaces a warp (kJ), rows a panel
TX, JG, JPT, YP = 32, 8, 16, 64

INSTANCES = [(v2, part, inc) for v2 in (False, True)
             for part in ("all", "upper", "lower") for inc in (True, False)]


def _k4_span(a, mode, qb, Qb, Wz, xs, ya, yb, j0, variant2, mask_inc,
             keep_ge, keep_lt):
    """Rows [ya, yb) of one warp's kernel step, added to its sums ``a``
    (JPT, columns) in y order."""
    Ny = qb.shape[0]
    jj = j0 + np.arange(JPT)[:, None]
    sj = np.zeros(a.shape)
    n = min(JPT, Ny - j0)
    sj[:n] = qb[j0:j0 + n, xs] if variant2 else Qb[j0:j0 + n, None]
    for y in range(ya, yb):
        v = Qb[y] if variant2 else qb[y, xs]
        w = Wz[y, xs]
        with np.errstate(invalid="ignore"):
            qe = sj - v if variant2 else v - sj
            ge = ((np.fmin(qe, 0.0) if mask_inc else np.fmax(qe, 0.0))
                  if keep_ge else np.zeros_like(qe))
            lt = ((-np.fmax(qe, 0.0) if mask_inc else -np.fmin(qe, 0.0))
                  if keep_lt else np.zeros_like(qe))
            if mode == "ge":
                t = ge
            elif mode == "lt":
                t = lt
            elif mode == "mixed":
                t = np.where(y >= jj, ge, lt)
            else:
                qz = np.where(np.isnan(qe), 0.0, qe)
                m = y >= jj
                pos, neg = (qe < 0, qe > 0) if mask_inc else (qe > 0, qe < 0)
                mask = np.where(m, np.where(pos, 1.0, 0.0),
                                np.where(neg, -1.0, 0.0))
                t = qz * np.where(np.where(m, keep_ge, keep_lt), mask, 0.0)
            a += t * w


def _k4_emulate(q, Q, W, *, increase, part, variant2, flag=True):
    """K4 as the kernel cuts it, float64 numpy; returns the output and the
    count of (block, panel, warp) row spans by mode."""
    Wz = np.where(np.isnan(W), 0.0, W)
    B, Ny, Nx = q.shape
    mask_inc = increase != variant2
    keep_ge = part == "all" or (part == "upper") == increase
    keep_lt = part == "all" or (part == "upper") != increase
    tj = JG * JPT
    out = np.zeros_like(q)
    steps = dict(ge=0, lt=0, mixed=0, exact=0, skipped=0)
    for b in range(B):
        for x0 in range(0, Nx, TX):
            xs = slice(x0, min(Nx, x0 + TX))
            for jb in range(0, Ny, tj):
                js_blk = slice(jb, min(Ny, jb + tj))
                # register operands: q(y_j, x) (v2) or Q_j (v1)
                reg = q[b, js_blk, xs] if variant2 else Q[b, js_blk]
                block_inf = flag and bool(np.isinf(reg).any())
                acc = np.zeros((tj, xs.stop - x0))
                for y0 in range(0, Ny, YP):
                    rows = min(YP, Ny - y0)
                    ys = slice(y0, y0 + rows)
                    staged = Q[b, ys] if variant2 else q[b, ys, xs]
                    exact = block_inf or (flag and bool(
                        np.isinf(staged).any() or np.isinf(Wz[ys, xs]).any()))
                    for g in range(JG):
                        j0 = jb + g * JPT
                        if j0 >= Ny:
                            continue
                        # rows [0, r_lt) lie above every surface of the
                        # warp, [r_ge, rows) below, [r_lt, r_ge) straddle
                        r_lt = min(max(j0 - y0, 0), rows)
                        r_ge = min(max(j0 + JPT - 1 - y0, r_lt), rows)
                        spans = ([("exact", 0, rows)] if exact else
                                 [("lt", 0, r_lt), ("mixed", r_lt, r_ge),
                                  ("ge", r_ge, rows)])
                        for mode, r0, r1 in spans:
                            if r0 == r1:
                                continue
                            if (mode == "ge" and not keep_ge) or \
                                    (mode == "lt" and not keep_lt):
                                steps["skipped"] += 1
                                continue
                            steps[mode] += 1
                            _k4_span(acc[g * JPT:(g + 1) * JPT], mode,
                                     q[b], Q[b], Wz, xs, y0 + r0, y0 + r1,
                                     j0, variant2, mask_inc, keep_ge,
                                     keep_lt)
                n = js_blk.stop - jb
                out[b, js_blk, xs] = -acc[:n]
    return out, steps


def _plain(q, Q, W, **kw):
    return kl.lwa_dense_plain(*(torch.as_tensor(a) for a in (q, Q, W)),
                              **kw).numpy()


def _agree(got, want, rtol):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    assert np.array_equal(m, np.isfinite(got))
    scale = np.abs(want[m]).max()
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


QUEUE3 = [(seed, inf, nan_w) for seed in (4, 9)
          for inf, nan_w in ((True, True), (True, False), (False, True))]


@pytest.mark.parametrize("variant2,part,increase", INSTANCES)
def test_k4_tiles_match_plain_on_queue3_inputs(variant2, part, increase):
    """All 12 instances on the inputs that pin the twin's behaviour (a NaN
    weight, +-inf cells, a NaN profile row, an exact tie)."""
    kw = dict(increase=increase, part=part, variant2=variant2)
    for seed, inf, nan_w in QUEUE3:
        q, Q, W = _case(seed, inf=inf, nan_w=nan_w)
        want = _plain(q, Q, W, **kw)
        got, steps = _k4_emulate(q, Q, W, **kw)
        _agree(got, want, F64_RTOL)
        # flagged panels run exact, the others the mask-free form
        assert (steps["exact"] > 0) == inf
        assert steps["mixed"] > 0 and steps["ge"] + steps["lt"] > 0


@pytest.mark.parametrize("B,Ny,Nx,seed", [(2, 97, 40, 21), (1, 150, 33, 22),
                                          (3, 71, 64, 23)])
def test_k4_tiles_match_plain_on_ragged_shapes(B, Ny, Nx, seed):
    """Ny not a multiple of 32 or 64, Nx not of 32; every instance takes
    all three panel classes, and part selections skip panels."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3
    Q = np.sort(rng.standard_normal((B, Ny)) * 2.0, axis=-1)
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    q[0, Ny // 3, Nx // 2] = np.nan
    W[Ny // 2, Nx // 3] = np.nan
    for variant2, part, increase in INSTANCES:
        kw = dict(increase=increase, part=part, variant2=variant2)
        want = _plain(q, Q, W, **kw)
        got, steps = _k4_emulate(q, Q, W, **kw)
        _agree(got, want, F64_RTOL)
        assert steps["mixed"] > 0 and steps["ge"] + steps["lt"] > 0
        assert steps["exact"] == 0
        assert (steps["skipped"] > 0) == (part != "all")


@pytest.mark.parametrize("where", ["staged", "surface", "weight"])
def test_k4_inf_flag_keeps_the_twins_nan(where):
    """Without the infinity flag the mask-free form turns the twin's
    inf * 0 = NaN into 0; with it the NaN pattern is the plain version's.
    A staged +inf cell (variant 1, ``_case(4)``); a +inf surface value
    (variant 2); an infinite weight on the side a part zeroes (variant 1,
    upper)."""
    kw = dict(increase=True, part="all", variant2=False)
    if where == "staged":
        q, Q, W = _case(4, nan_w=False)
    else:
        q, Q, W = _case(9, inf=False, nan_w=False)
        if where == "surface":
            q[1, 20, 41] = np.inf
            kw["variant2"] = True
        else:
            W[30, 41] = np.inf
            kw["part"] = "upper"
    want = _plain(q, Q, W, **kw)
    assert np.isnan(want).any()
    unflagged, _ = _k4_emulate(q, Q, W, flag=False, **kw)
    assert not np.array_equal(np.isnan(unflagged), np.isnan(want))
    flagged, _ = _k4_emulate(q, Q, W, **kw)
    _agree(flagged, want, F64_RTOL)


def _k3_emulate(q, Q, W, *, increase, chunk):
    """K3 as the kernels cut it: the prep's chunk-local E and chunk totals,
    the carry-in added per chunk, then the surface sums; in q's dtype."""
    f = q.dtype.type
    B, Ny, Nx = q.shape
    validQ = np.isfinite(Q)
    c0 = np.array([Q[b][validQ[b]].mean() if validQ[b].any() else 0.0
                   for b in range(B)], dtype=q.dtype)[:, None]
    valid = np.isfinite(q) & np.isfinite(W)
    with np.errstate(invalid="ignore"):
        qt = np.where(valid, q - c0[..., None], f(0))
        Wv = np.where(valid, W, f(0))
        Qc = Q - c0
    Qt = np.where(validQ, Qc, f(0))
    E = np.empty_like(q)
    tots = []
    for s in range(0, Ny, chunk):
        if s > 0:
            qp, wp, Qp = qt[:, s - 1], Wv[:, s - 1], Qt[:, s - 1, None]
        else:
            qp = wp = np.zeros((B, Nx), q.dtype)
            Qp = np.zeros((B, 1), q.dtype)
        eloc = np.zeros((B, Nx), q.dtype)
        L = np.zeros((B, Nx), q.dtype)
        for y in range(s, min(Ny, s + chunk)):
            Qy = Qt[:, y, None]
            eloc = eloc + ((Qy - qp) * wp + (Qy - Qp) * L)
            E[:, y] = eloc
            L = L + wp
            qp, wp, Qp = qt[:, y], Wv[:, y], Qy
        tots.append((eloc, L))
    e_in = np.zeros((B, Nx), q.dtype)
    P_in = np.zeros((B, Nx), q.dtype)
    Q_s = np.zeros((B, 1), q.dtype)
    for i, s in enumerate(range(0, Ny, chunk)):
        e = min(Ny, s + chunk)
        E[:, s:e] = (e_in[:, None] + E[:, s:e]
                     + P_in[:, None] * (Qt[:, s:e, None] - Q_s[..., None]))
        Q_e = Qt[:, e - 1, None]
        e_in = e_in + tots[i][0] + P_in * (Q_e - Q_s)
        P_in = P_in + tots[i][1]
        Q_s = Q_e
    sent = f(np.inf if increase else -np.inf)
    with np.errstate(invalid="ignore"):
        qk = np.where(valid, q - c0[..., None], sent)
        qe = qk[:, None] - Qc[:, :, None, None]       # (B, j, y, x)
        ext = np.minimum(qe, f(0)) if increase else np.maximum(qe, f(0))
        R = (ext * Wv[:, None]).sum(2, dtype=q.dtype)
        return np.where(np.isnan(Qc)[..., None], f(0), -(R + E))


@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("seed", [4, 9])
def test_k3_emulation_matches_plain_on_queue3_inputs(seed, increase):
    """float64: sentinels with zero weight for non-finite cells and
    weights, the NaN profile row -> 0, chunks of 32 rows."""
    q, Q, W = _case(seed)
    if not increase:
        q, Q = -q, -Q[:, ::-1].copy()
    got = _k3_emulate(q, Q, W, increase=increase, chunk=kl.E_CHUNK)
    want = kl.lwa_lin_plain(*(torch.as_tensor(a) for a in (q, Q, W)),
                            increase=increase).numpy()
    _agree(got, want, F64_RTOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("chunk", [1, 5, 32, 63])
def test_k3_chunked_scan_float32(chunk):
    """The chunked E scan in float32 against the serial scan (one chunk of
    every row) and against the float64 oracle, at the 'lin' bound."""
    q, Q, dA, _, want = _era_like()
    W = dA / dA.max() * dA
    q32, Q32, W32 = (a.astype(np.float32) for a in (q, Q, W))
    scale = np.nanmax(np.abs(want))
    got = _k3_emulate(q32, Q32, W32, increase=True, chunk=chunk)
    serial = _k3_emulate(q32, Q32, W32, increase=True, chunk=q.shape[1])
    assert got.dtype == np.float32
    assert np.abs(got - serial).max() / scale < LIN_BOUND
    assert np.abs(got.astype(np.float64) - want).max() / scale < LIN_BOUND
