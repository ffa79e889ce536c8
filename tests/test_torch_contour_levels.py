"""E, the contour levels' scan (``kernels.extrema``), and its callers:
``core.cal_contours``, ``core.masked_extrema`` and the pipelines.

On the CPU: the wrapper's plain version bit for bit with the chain it
replaced (``where(isnan, +-inf, q)``, ``amin``, ``amax`` and the levels'
algebra, written out here as it ran) for increasing and decreasing
levels, in float32 and float64, on planes that are all NaN, hold +-inf or
are a single cell, and at N = 1 and 2; the extrema mode likewise; any
batch shape; the chunk count and the kernel's cut of a plane (head,
16-byte vectors by chunk, tail) emulated in numpy; one E call a step in
each of the five pipelines that compute levels and none in
``local_length_pipeline``; gradients through ``cal_contours`` and
``masked_extrema`` bit for bit with autograd through the chain and
against ``jax.grad`` of the JAX package, with an extremum tied between
cells.

On the card (``-m cuda``; skipped without one): the kernel bit for bit
with its plain version in both modes at the benchmark cells' shapes, an
odd Nx, a view whose start is not 16-byte aligned, a single cell, one
snapshot and more snapshots than a launch's grid y; two runs bit for bit;
each pipeline's replayed steps bit for bit with its eager body, one E
call a step.  Run there with ``python -m pytest --noconftest -m cuda
tests/test_torch_contour_levels.py``.
"""

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import core, pipeline
from xcontour_tpu_torch.kernels import extrema, hist

CPU = "cpu"
PIPELINES = ("keff", "lwa", "keff_lwa", "clength", "fractal")


def _same(got, want, where=""):
    """Bit for bit, NaN patterns included."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}/{i}")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, where
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=where)


def chain_extrema(q):
    """The chain as ``core.masked_extrema`` ran it before E."""
    isn = torch.isnan(q)
    inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
    return (torch.where(isn, inf, q).amin(dim=(-2, -1)),
            torch.where(isn, -inf, q).amax(dim=(-2, -1)))


def chain_levels(q, N, increase=True):
    """The chain as ``core.cal_contours`` ran it before E."""
    lo, hi = chain_extrema(q)
    inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
    nan = torch.tensor(float("nan"), dtype=q.dtype, device=q.device)
    lo = torch.where(lo == inf, nan, lo)
    hi = torch.where(hi == -inf, nan, hi)
    start, end = (lo, hi) if increase else (hi, lo)
    steps = (end - start) / torch.full_like(end, N - 1.0)
    levels = (steps[..., None] * torch.arange(N, dtype=q.dtype,
                                              device=q.device)
              + start[..., None])
    levels[..., -1] = end
    return levels


def _planes(seed, dtype, B=7, Ny=13, Nx=21, device=CPU):
    """Noise with the edge cases on planes of their own: a NaN box, an
    all-NaN plane, +inf and -inf cells, a plane of one value, a plane
    whose only finite cell is its last."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx))
    q[0, 2:6, 3:9] = np.nan
    q[1] = np.nan
    q[2, 4, 5] = np.inf
    q[3, 0, 0] = -np.inf
    q[3, 7, 2] = np.nan
    q[4] = 0.75
    q[5] = np.nan
    q[5, -1, -1] = -2.5
    return torch.as_tensor(q, dtype=dtype, device=device)


# ---------------------------------------------------------------- the CPU
@pytest.mark.parametrize("N", [1, 2, 31])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_is_the_chain_bit_for_bit(dtype, increase, N):
    q = _planes(1, dtype)
    want = chain_levels(q, N, increase)
    got = extrema.contour_levels_plain(q, N, increase=increase)
    _same(got, want)
    _same(extrema.contour_levels(q, N, increase=increase), want)
    _same(core.levels_from_extrema(*core.masked_extrema(q), N,
                                   increase=increase), want)
    _same(core.cal_contours(q, N, increase=increase), want)
    assert torch.isnan(got[1]).all()
    assert (got[4] == 0.75).all() and (got[5] == -2.5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extrema_mode_is_the_chain_bit_for_bit(dtype):
    q = _planes(2, dtype)
    want = chain_extrema(q)
    _same(extrema.masked_extrema_plain(q), want)
    _same(extrema.masked_extrema(q), want)
    _same(core.masked_extrema(q), want)
    lo, hi = want
    assert lo[1] == float("inf") and hi[1] == float("-inf")
    assert hi[2] == float("inf") and lo[3] == float("-inf")
    assert lo[5] == hi[5] == -2.5


@pytest.mark.parametrize("shape", [(21,), (3, 21), (2, 3, 21), ()])
def test_any_batch_shape(shape):
    """(Ny, Nx), (B, Ny, Nx) and (A, B, Ny, Nx) snapshots, and a view
    that is not contiguous."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.standard_normal(shape + (9, 11)))
    want = chain_levels(q, 17)
    _same(core.cal_contours(q, 17), want)
    _same(core.masked_extrema(q), chain_extrema(q))
    t = q.transpose(-1, -2)
    _same(core.cal_contours(t, 17, increase=False),
          chain_levels(t, 17, False))


@pytest.mark.parametrize("B,M,chunks", [
    (16, 721 * 1440, 33),        # era5.*: 16 levels of ERA5
    (15, 721 * 1440, 36),        # the CLI's --batch 15
    (32, 256 * 512, 16),         # t170.fractal: min(17, 16 by MIN_CELLS)
    (64, 100 * 4480, 9),         # lape.lwa
    (1, 1, 1), (70000, 6, 1), (1, 721 * 1440, 127)])
def test_plan(B, M, chunks):
    got = hist.blocks_a_plane(B, M, 132, extrema.MIN_CELLS)
    assert got == chunks
    assert got == 1 or -(-M // got) >= extrema.MIN_CELLS // 2


def emulate(x, chunks, head, width):
    """The kernel's cut of each plane of x (B, M): ``head`` cells before
    the first 16-byte boundary, whole vectors of ``width`` cells split
    over ``chunks`` by ceil division, the tail; each chunk's (min, max)
    with NaN dropped (fmin, fmax from +-inf), head and tail with the last
    chunk, then the chunks folded.  Returns (lo, hi, cells read)."""
    B, M = x.shape
    head = min(head, M)
    nvec = (M - head) // width
    per = -(-nvec // chunks)
    seen = np.zeros((B, M), np.int64)
    part = np.empty((B, chunks, 2))
    for c in range(chunks):
        v0 = min(nvec, c * per)
        v1 = min(nvec, v0 + per)
        idx = [np.arange(head + v0 * width, head + v1 * width)]
        if c == chunks - 1:
            idx += [np.arange(head), np.arange(head + nvec * width, M)]
        idx = np.concatenate(idx).astype(np.int64)
        seen[:, idx] += 1
        vals = x[:, idx]
        part[:, c, 0] = np.fmin.reduce(np.concatenate(
            [np.full((B, 1), np.inf), vals], axis=1), axis=1)
        part[:, c, 1] = np.fmax.reduce(np.concatenate(
            [np.full((B, 1), -np.inf), vals], axis=1), axis=1)
    return part[..., 0].min(axis=1), part[..., 1].max(axis=1), seen


@pytest.mark.parametrize("M,chunks,head,width", [
    (1, 1, 0, 4), (1, 1, 3, 4), (7, 2, 1, 4), (37 * 71, 5, 3, 4),
    (1000, 7, 0, 2), (1001, 3, 1, 2), (16, 64, 2, 4), (4096, 4, 0, 4)])
def test_the_cut_reads_every_cell_once(M, chunks, head, width):
    rng = np.random.default_rng(M)
    x = rng.standard_normal((3, M))
    x[0, rng.random(M) < 0.3] = np.nan
    x[1] = np.nan
    x[2, -1] = np.inf
    lo, hi, seen = emulate(x, chunks, head, width)
    assert (seen == 1).all()
    want_lo, want_hi = (t.numpy() for t in chain_extrema(
        torch.as_tensor(x)[:, None]))
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)


def _pipeline_field(seed=5, B=3, Ny=24, Nx=48):
    from xcontour_tpu_torch.utils.synth import synth_pv
    v, _ = synth_pv(nlev=B, nlat=Ny, nlon=Nx, seed=seed)
    q = torch.as_tensor(v["pv"], dtype=torch.float64)
    q[0, 2:5, 10:20] = float("nan")
    grid = xt.from_latlon(v["latitude"].astype(np.float64),
                          v["longitude"].astype(np.float64),
                          dtype=torch.float64, device=CPU)
    return q, grid


def _entry(name, grid, N=15):
    table = core.cal_area_eqCoord_table_hist(
        grid.fluid_mask(grid.dA.dtype), grid.ydef, grid.dA, increase=True,
        lt=True)
    return {
        "keff": (pipeline.keff_pipeline, dict(N=N, table=table)),
        "lwa": (pipeline.lwa_pipeline, dict(N=N, table=table)),
        "keff_lwa": (pipeline.keff_lwa_pipeline, dict(N=N, table=table)),
        "clength": (pipeline.clength_pipeline, dict(N=N, table=table)),
        "fractal": (pipeline.fractal_pipeline,
                    dict(N=N, strides=[1, 2], table=table)),
        "local": (pipeline.local_length_pipeline, dict(window=9, stride=4)),
    }[name]


@pytest.mark.parametrize("name", PIPELINES + ("local",))
def test_one_plain_call_a_pipeline_step(monkeypatch, name):
    """Each pipeline that computes levels calls E's wrapper once a step
    (its plain version on the CPU), with or without a gradient, and the
    backward calls neither; ``local_length_pipeline`` computes no levels
    (its levels are window means) and calls neither."""
    calls = {}

    def count(fn_name):
        orig = getattr(extrema, fn_name)

        def wrapped(*a, **k):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(extrema, fn_name, wrapped)
    for fn_name in ("contour_levels", "contour_levels_plain",
                    "masked_extrema"):
        count(fn_name)
    q, grid = _pipeline_field()
    fn, kw = _entry(name, grid)
    want = {} if name == "local" else dict(contour_levels=1,
                                           contour_levels_plain=1)
    for grad in (False, True):
        calls.clear()
        t = q.clone().requires_grad_(grad)
        out = fn(t, grid, **kw)
        if grad:
            leaves = [v for v in out.values() if torch.is_tensor(v)]
            leaves += [v for d in out.values() if isinstance(d, dict)
                       for v in d.values()]
            loss = sum(torch.nansum(v) for v in leaves if v.requires_grad)
            g, = torch.autograd.grad(loss, t)
            assert torch.isfinite(g).any()
        assert calls == want, (grad, calls)


def test_gradients_are_the_chains_bit_for_bit():
    """d(levels . w)/d tracer through E's Function against autograd
    through the chain: the backward recomputes the chain's operations, so
    the same bits; with the minimum and the maximum each tied between
    cells (amin and amax split the cotangent equally among them)."""
    q = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (3, 9, 13)))
    q[0, 1, 2] = q[0, 5, 7] = q[0].min() - 1.0         # a tied minimum
    q[1, 0, 0] = q[1, 8, 12] = q[1, 4, 4] = q[1].max() + 1.0
    q[2, 3:5, 3:6] = float("nan")
    w = torch.as_tensor(np.random.default_rng(7).standard_normal((3, 11)))
    for increase in (True, False):
        t1 = q.clone().requires_grad_()
        g1, = torch.autograd.grad(
            (core.cal_contours(t1, 11, increase=increase) * w).sum(), t1)
        t2 = q.clone().requires_grad_()
        g2, = torch.autograd.grad(
            (chain_levels(t2, 11, increase) * w).sum(), t2)
        _same(g1, g2, f"increase={increase}")
        # the tie split: each tied cell carries an equal share
        assert g1[0, 1, 2] == g1[0, 5, 7] != 0
        assert g1[1, 0, 0] == g1[1, 8, 12] == g1[1, 4, 4] != 0
    # the extrema mode (the sharded levels' path), each output alone too
    for pick in ((0,), (1,), (0, 1)):
        t1 = q.clone().requires_grad_()
        out = core.masked_extrema(t1)
        g1, = torch.autograd.grad(sum(out[i].sum() for i in pick), t1)
        t2 = q.clone().requires_grad_()
        out = chain_extrema(t2)
        g2, = torch.autograd.grad(sum(out[i].sum() for i in pick), t2)
        _same(g1, g2, f"extrema {pick}")


def test_a_gradient_of_the_gradient():
    """The Hessian-vector product through the levels: the backward is
    recorded when a graph of the gradient is asked for."""
    q = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 6, 7)))
    v = torch.as_tensor(np.random.default_rng(9).standard_normal((2, 6, 7)))

    def hvp(levels):
        t = q.clone().requires_grad_()
        g, = torch.autograd.grad((levels(t) ** 2).sum(), t,
                                 create_graph=True)
        h, = torch.autograd.grad((g * v).sum(), t)
        return h
    _same(hvp(lambda t: core.cal_contours(t, 5)),
          hvp(lambda t: chain_levels(t, 5)))


@pytest.mark.parametrize("increase", [True, False])
def test_gradients_match_jax(increase):
    """``jax.grad`` of the JAX package's cal_contours on the same float64
    inputs, ties included: rtol 1e-12 (the same operations)."""
    import jax
    import jax.numpy as jnp
    from xcontour_tpu import core as jcore

    rng = np.random.default_rng(10)
    q = rng.standard_normal((3, 8, 10))
    q[0, 2, 2] = q[0, 6, 9] = q.min() - 1.0
    q[1, 0, 0] = q[1, 7, 1] = q[1].max() + 1.0
    q[2, 1:4, 2:5] = np.nan
    w = rng.standard_normal((3, 13))

    def jloss(d):
        return (jcore.cal_contours(d, 13, increase=increase) * w).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    t = torch.tensor(q, requires_grad=True)
    g, = torch.autograd.grad(
        (core.cal_contours(t, 13, increase=increase) * torch.tensor(w))
        .sum(), t)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # the levels themselves: JAX forms them in another order, an ulp apart
    lv = np.asarray(jcore.cal_contours(jnp.asarray(q), 13,
                                       increase=increase))
    np.testing.assert_allclose(
        core.cal_contours(torch.tensor(q), 13, increase=increase).numpy(),
        lv, rtol=0, atol=1e-14 * np.nanmax(np.abs(lv)))


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_field(dev, B, Ny, Nx, seed, dtype=torch.float32, rock=False):
    """Noise over a meridional slope with NaN boxes: a below-ground box on
    the first snapshot, an all-NaN second snapshot where there is one, and
    with ``rock`` a ridge of NaN on every snapshot (as lape.lwa's)."""
    g = torch.Generator().manual_seed(seed)
    y = torch.linspace(-1.0, 1.0, Ny, dtype=torch.float64)
    q = y[None, :, None] + 0.3 * torch.randn((B, Ny, Nx), generator=g,
                                             dtype=torch.float64)
    q[0, : max(1, Ny // 8), : max(1, Nx // 4)] = float("nan")
    if B > 1:
        q[1] = float("nan")
    if rock:
        x = torch.arange(Nx)
        top = (Ny * 0.15 * torch.exp(-((x - Nx / 2) / (Nx / 16)) ** 2)).long()
        rows = torch.arange(Ny)[:, None]
        q = torch.where((Ny - 1 - rows) < top[None, :], float("nan"), q)
    return q.to(dtype).to(dev)


def _both_modes(q, N, increase, where):
    n0 = extrema.KERNEL.launches
    got = extrema.contour_levels(q, N, increase=increase)
    ext = extrema.masked_extrema(q)
    torch.cuda.synchronize()
    assert extrema.KERNEL.launches == n0 + 2, where
    _same(got, extrema.contour_levels_plain(q, N, increase=increase), where)
    _same(ext, extrema.masked_extrema_plain(q), f"{where} extrema")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("era5", 16, 721, 1440, 241, True, False),
    ("t170.fractal", 32, 256, 512, 121, True, False),
    ("lape.lwa", 64, 100, 4480, 121, False, True),
    ("odd Nx", 3, 37, 71, 31, True, False),
    ("one cell", 1, 1, 1, 2, True, False),
    ("one snapshot", 1, 721, 1440, 401, False, False),
    ("past grid y", 65537 + 3, 2, 3, 5, True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_the_plain_version_bit_for_bit(cuda, case, dtype):
    label, B, Ny, Nx, N, increase, rock = case
    q = _card_field(cuda, B, Ny, Nx, seed=B + Nx, dtype=dtype, rock=rock)
    _both_modes(q, N, increase, f"{label} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_an_unaligned_view(cuda, offset):
    """Planes whose starts lie off every 16-byte boundary: the head and
    tail cells beside the vectors."""
    B, Ny, Nx = 5, 33, 64
    flat = _card_field(cuda, 1, 1, B * Ny * Nx + offset, seed=offset)
    q = flat.reshape(-1)[offset:].view(B, Ny, Nx)
    assert q.data_ptr() % 16 != 0
    _both_modes(q, 21, True, f"offset {offset}")


@pytest.mark.cuda
def test_two_runs_bit_for_bit(cuda):
    q = _card_field(cuda, 16, 721, 1440, seed=3)
    a = extrema.contour_levels(q, 241)
    b = extrema.contour_levels(q, 241)
    _same(a, b)
    _same(extrema.masked_extrema(q), extrema.masked_extrema(q))


@pytest.mark.cuda
def test_the_wrapper_refuses(cuda):
    q = _card_field(cuda, 2, 8, 8, seed=1)
    with pytest.raises(TypeError):
        extrema.contour_levels(q.half(), 5)
    with pytest.raises(ValueError):
        extrema.contour_levels(q.transpose(1, 2), 5)
    with pytest.raises(RuntimeError):
        extrema.contour_levels(q.clone().requires_grad_(), 5)
    with pytest.raises(ValueError):
        extrema.contour_levels(q, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_precision_is_refused_on_the_card(cuda, dtype):
    """``cal_contours`` and ``masked_extrema`` on the card take float32
    and float64 alone (E's dtypes): half precision raises, with or
    without a gradient, where the plain chain once ran it."""
    q = _card_field(cuda, 2, 8, 8, seed=2).to(dtype)
    for t in (q, q.clone().requires_grad_()):
        with pytest.raises(TypeError, match="float32 or float64"):
            core.cal_contours(t, 5)
        with pytest.raises(TypeError, match="float32 or float64"):
            core.masked_extrema(t)


def _exact_field(dev, seed, B=3, ny=64, nx=128):
    """A field on a unit Cartesian grid whose every K2 sum is exact (as
    ``test_torch_pipeline_graph``'s), so eager and replayed steps agree
    bit for bit whatever the order of K2's atomics."""
    x = torch.arange(nx)
    tri = torch.minimum(x, nx - x)
    q = 2.0 * (tri[None, None, :] + 3 * torch.arange(B)[:, None, None]
               + seed)
    q = q.expand(B, ny, nx).to(torch.float32).clone()
    q[0, 2:5, 10:20] = float("nan")
    grid = xt.from_cartesian(np.arange(ny, dtype=np.float64),
                             np.arange(nx, dtype=np.float64), device=dev)
    return q.to(dev), grid


@pytest.mark.cuda
@pytest.mark.parametrize("name", PIPELINES)
def test_replayed_steps_are_the_eager_step_bit_for_bit(cuda, monkeypatch,
                                                       name):
    """Warm-up, capture and replay, and four replays on inputs in turn: each call bit
    for bit with the eager body, its levels with the plain version's, one
    E call a step."""
    monkeypatch.setattr(pipeline, "GRAPHS", pipeline.Graphs())
    ring = [_exact_field(cuda, seed=s)[0] for s in (1, 2, 3)]
    _, grid = _exact_field(cuda, seed=1)
    fn, kw = _entry(name, grid, N=31)
    for i in range(6):
        q = ring[i % 3]
        n0 = extrema.KERNEL.launches
        got = fn(q, grid, **kw)
        torch.cuda.synchronize()
        assert extrema.KERNEL.launches == n0 + 1, i
        _same(got, fn.__wrapped__(q, grid, **kw), f"call {i}")
        levels = (got["origin"] if name == "keff" else got)["contour"]
        _same(levels, extrema.contour_levels_plain(q, 31), f"call {i} levels")
    g = pipeline.GRAPHS
    assert (g.captures, g.replays, g.eager) == (1, 5, 1)
