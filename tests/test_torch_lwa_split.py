"""LWA split into its two halves (``part='split'``): K4's split mode and its
plain twin, ``local_wave_activity[2]``, ``lwa_pipeline``, the sharded step,
the CLI's ``lwa --part split`` and the gradients, on the CPU; on the card
(``-m cuda``) K4 in split mode against its single-part launches and the
pipeline's launches and graph replay.

Each half of a split equals its single part's output bit for bit (the
same terms summed in the same order); the halves add up to part='all' to
rounding.  The benchmark's plain float64 reference of the halves,
``xcbench/reference/lwa_split.py``, shares no code with the port.  The
file imports no JAX, so its ``-m cuda`` tests run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_lwa_split.py``,
and its rank function loads by path in gloo rank processes.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import cli, pipeline
from xcontour_tpu_torch.diagnostics import lwa as tlwa
from xcontour_tpu_torch.kernels import lwa as kl

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from xcbench.reference import core as ref_core, lwa_split  # noqa: E402

CPU = "cpu"
F64 = torch.float64
HALVES = ("lwa_upper", "lwa_lower", "lwa2_upper", "lwa2_lower")
B, NY, NX, N = 3, 37, 72, 31
LAT = np.linspace(-90.0, 90.0, NY)
LON = np.arange(NX) * (360.0 / NX)


def _case(seed, B=2, Ny=40, Nx=96):
    """q increasing in y with noise, sorted profiles, NaN cells, a NaN
    profile row, a NaN weight and a tracer-profile tie (Ny > 25, Nx >
    60)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Ny, Nx)).cumsum(1) * 0.3
    Q = np.sort(rng.standard_normal((B, Ny)) * 2.0, axis=-1)
    W = rng.uniform(0.5, 1.5, (Ny, Nx))
    q[0, 3:5, 7:11] = np.nan
    Q[1, 6] = np.nan
    q[1, 9, 2] = Q[1, 20]
    W[25, 60] = np.nan
    return [torch.as_tensor(a) for a in (q, Q, W)]


def _field(seed, dtype=F64, sign=1.0):
    """A seeded random tracer increasing northward (times ``sign``) on
    LAT x LON with a NaN box."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.linspace(-2, 2, NY, dtype=dtype)[None, :, None]
         + torch.randn(B, NY, NX, generator=g, dtype=dtype))
    q[0, 5:8, 10:20] = float("nan")
    return (sign * q).contiguous()


def _grid(device=CPU, dtype=torch.float32):
    return xt.from_latlon(LAT, LON, dtype=dtype, device=device)


# ------------------------------------------------------------ the twins
@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_plain_split_is_the_single_parts_bit_for_bit(increase, variant2):
    q, Q, W = _case(3)
    for dtype in (torch.float32, F64):
        args = [t.to(dtype) for t in (q, Q, W)]
        kw = dict(increase=increase, variant2=variant2)
        got = kl.lwa_dense_plain(*args, part="split", **kw)
        assert got.shape == (2,) + tuple(q.shape)
        for i, part in enumerate(("upper", "lower")):
            want = kl.lwa_dense_plain(*args, part=part, **kw)
            assert torch.equal(got[i], want), (dtype, part)
        whole = kl.lwa_dense_plain(*args, part="all", **kw)
        torch.testing.assert_close(got[0] + got[1], whole,
                                   rtol=0, atol=1e-6 * whole.abs().max())


@pytest.mark.parametrize("increase", [True, False])
def test_local_wave_activity_split(increase):
    q = _field(5, sign=1.0 if increase else -1.0)
    grid = _grid()
    Q = q.nanmean(-1).sort(-1, descending=not increase).values
    for fn in (tlwa.local_wave_activity, tlwa.local_wave_activity2):
        up, lo = fn(q, Q, grid.dA, grid.ydef, increase=increase,
                    part="split")
        for got, part in ((up, "upper"), (lo, "lower")):
            want = fn(q, Q, grid.dA, grid.ydef, increase=increase,
                      part=part)
            assert torch.equal(got, want), (fn.__name__, part)
        for method in ("lin", "fast"):
            with pytest.raises(ValueError, match="only supports part='all'"):
                fn(q, Q, grid.dA, grid.ydef, increase=increase,
                   part="split", method=method)
    with pytest.raises(ValueError, match="part must be in"):
        kl.lwa_dense_plain(q, Q, grid.dA, increase=increase, part="both")


# --------------------------------------------------------- the pipeline
@pytest.mark.parametrize("increase", [True, False])
def test_pipeline_split_against_single_parts_and_all(increase):
    q = _field(7, dtype=torch.float32, sign=1.0 if increase else -1.0)
    grid = _grid()
    kw = dict(N=N, increase=increase, lt=increase)
    got = xt.lwa_pipeline(q, grid, part="split", **kw)
    assert set(got) == {"contour", "intArea", "latEq", "Q", *HALVES}
    for part in ("upper", "lower"):
        want = xt.lwa_pipeline(q, grid, part=part, **kw)
        for key in ("contour", "intArea", "latEq", "Q"):
            assert torch.equal(got[key], want[key]), key
        assert torch.equal(got[f"lwa_{part}"], want["lwa"])
        assert torch.equal(got[f"lwa2_{part}"], want["lwa2"])
    whole = xt.lwa_pipeline(q, grid, part="all", lwa_method="dense", **kw)
    for v in ("lwa", "lwa2"):
        s = got[f"{v}_upper"] + got[f"{v}_lower"]
        torch.testing.assert_close(s, whole[v], rtol=0,
                                   atol=2e-6 * whole[v].abs().max())


def test_pipeline_split_against_the_benchmark_reference():
    """float64 port against the float64 reference on a seeded random field:
    the sorted state by other sums (K2's digitize and cumsum against a sort
    and cumsum), the halves by the same pairs."""
    q = _field(11)
    grid = _grid(dtype=F64)
    table = xt.core.cal_area_eqCoord_table_hist(
        grid.fluid_mask(F64), grid.ydef, grid.dA, increase=True, lt=True)
    got = xt.lwa_pipeline(q, grid, N=N, part="split", table=table)
    want = lwa_split.run(q, ref_core.latlon_grid(LAT, LON, F64, CPU), N=N)
    for key in ("contour", "intArea", "latEq", "Q", *HALVES):
        g, w = got[key], want[key]
        assert torch.equal(torch.isnan(g), torch.isnan(w)), key
        m = torch.isfinite(w)
        torch.testing.assert_close(g[m], w[m], rtol=0,
                                   atol=1e-10 * w[m].abs().max(), msg=key)


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_halves_against_the_benchmark_reference(increase, variant2):
    """Both directions, the same profile given to both sides."""
    q = _field(13, sign=1.0 if increase else -1.0)
    grid = _grid()
    Q = q.nanmean(-1).sort(-1, descending=not increase).values
    fn = tlwa.local_wave_activity2 if variant2 else tlwa.local_wave_activity
    got = fn(q, Q, grid.dA, grid.ydef, increase=increase, part="split")
    W = grid.dA / grid.dA.max() * grid.dA
    want = lwa_split.halves(q, Q, W, increase=increase, variant2=variant2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * w.abs().max())


def test_one_pass_a_variant(monkeypatch):
    """One call runs the plain twin once for LWA and once for LWA2, each
    for both halves (on the card: one K4 launch each)."""
    calls = []
    plain = kl.lwa_dense_plain

    def counting(*a, **k):
        calls.append((k["part"], k["variant2"]))
        return plain(*a, **k)
    monkeypatch.setattr(kl, "lwa_dense_plain", counting)
    xt.lwa_pipeline(_field(17, torch.float32), _grid(), N=N, part="split")
    assert calls == [("split", False), ("split", True)]


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_gradients_of_each_half_are_its_parts(increase, variant2):
    q, Q, W = _case(19, B=2, Ny=32, Nx=64)
    W = torch.nan_to_num(W, nan=1.0)
    ydef = torch.linspace(-1, 1, 32, dtype=F64)
    dA = torch.ones(32, 64, dtype=F64)
    fn = tlwa.local_wave_activity2 if variant2 else tlwa.local_wave_activity
    g = torch.Generator().manual_seed(1)
    gu, gl = (torch.randn(q.shape, generator=g, dtype=F64) for _ in "ul")

    def grads(split):
        xs = [t.clone().requires_grad_() for t in (q, Q, W)]
        kw = dict(increase=increase, weight=xs[2], method="dense")
        if split:
            up, lo = fn(xs[0], xs[1], dA, ydef, part="split", **kw)
        else:
            up = fn(xs[0], xs[1], dA, ydef, part="upper", **kw)
            lo = fn(xs[0], xs[1], dA, ydef, part="lower", **kw)
        loss = torch.nansum(up * gu) + torch.nansum(lo * gl)
        return torch.autograd.grad(loss, xs)
    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        m = torch.isfinite(b)
        torch.testing.assert_close(a[m], b[m], rtol=1e-12,
                                   atol=1e-12 * b[m].abs().max())


# ------------------------------------------------------- the sharded step
def rank_split(workdir):
    """On a 1 x 2 mesh of gloo ranks: the sharded split step, and the
    sharded LWA given the whole plane's Q, split and part by part; this
    rank's x block of each."""
    import torch.distributed as dist
    from xcontour_tpu_torch import parallel as P
    from xcontour_tpu_torch.parallel import lwa as plwa
    mesh = P.make_mesh(x_size=2)
    q = _field(23)
    grid = _grid(dtype=F64)
    nxl = NX // 2
    i = mesh.get_local_rank("x")
    blk = q[..., i * nxl:(i + 1) * nxl].contiguous()
    out = P.sharded_lwa_pipeline(blk, grid, mesh, N=N, part="split")
    Q = xt.lwa_pipeline(q, grid, N=N)["Q"]
    lwa = {part: plwa.sharded_local_wave_activity(
        blk, Q, grid.dA, grid.ydef, mesh, increase=True, part=part)
        for part in ("split", "upper", "lower")}
    np.savez(os.path.join(workdir, f"out{dist.get_rank()}.npz"),
             up=lwa["split"][0].numpy(), lo=lwa["split"][1].numpy(),
             upper=lwa["upper"].numpy(), lower=lwa["lower"].numpy(),
             **{k: v.numpy() for k, v in out.items()})


def test_sharded_split_on_two_gloo_ranks(tmp_path):
    """Each rank's halves are its single parts bit for bit; joined over
    'x' they are the plane's to float64 rounding (the CPU's plain sums
    over y vectorize by the slab's width, so their order follows it; K4
    sums each column alone)."""
    from xcontour_tpu_torch.parallel.launch import run_ranks
    from xcontour_tpu_torch.parallel.pipeline import X_SHARDED
    run_ranks(f"{__file__}:rank_split", 2, str(tmp_path), timeout=240)
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for r in ranks:
        np.testing.assert_array_equal(r["up"], r["upper"])
        np.testing.assert_array_equal(r["lo"], r["lower"])
    q = _field(23)
    grid = _grid(dtype=F64)
    plane = xt.lwa_pipeline(q, grid, N=N, part="split")
    halves = tlwa.local_wave_activity(q, plane["Q"], grid.dA, grid.ydef,
                                      increase=True, part="split")
    for key, want in zip(("up", "lo"), halves):
        got = np.concatenate([r[key] for r in ranks], -1)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=1e-13 * np.abs(got).max())
    assert set(HALVES) <= X_SHARDED
    for key, want in plane.items():
        if key in X_SHARDED:
            got = np.concatenate([r[key] for r in ranks], -1)
        else:   # replicated over 'x': the same on both ranks
            got = ranks[0][key]
            np.testing.assert_array_equal(ranks[1][key], got)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=1e-12 * np.nanmax(np.abs(got)))


# --------------------------------------------------------------- the CLI
def _nc3(tmp_path):
    from xcontour_tpu_torch.utils.ncio import save_dataset_nc3
    q = _field(29, torch.float32).numpy()
    path = str(tmp_path / "pv.nc")
    save_dataset_nc3(path, {"q": q}, {"q": ("time", "latitude", "longitude"),
                                      "latitude": ("latitude",),
                                      "longitude": ("longitude",)},
                     coords={"latitude": LAT, "longitude": LON})
    return path, q


def test_cli_lwa_part_split(tmp_path):
    from xcontour_tpu_torch.utils.ncio import load_dataset
    path, q = _nc3(tmp_path)
    out = str(tmp_path / "split.nc")
    assert cli.main(["lwa", path, "--var", "q", "-N", "21", "--batch", "2",
                     "--part", "split", "--format", "nc3", "--out", out,
                     "--device", CPU]) == 0
    ds = load_dataset(out)
    assert set(HALVES) <= set(ds.variables) and "lwa" not in ds.variables
    for key in HALVES:
        assert ds.dims_of(key) == ("time", "latitude", "longitude")
        name = ds.attrs[key]["long_name"]
        name = name.decode() if isinstance(name, bytes) else name
        assert name.endswith("(W+)" if key.endswith("upper") else "(W-)")
    ref = xt.lwa_pipeline(torch.as_tensor(q), _grid(), N=21, part="split")
    for key in HALVES:
        np.testing.assert_array_equal(ds[key], ref[key].numpy())


# -------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_k4_split_is_its_single_part_launches(cuda, increase, variant2):
    """Bit for bit, on the ERA5 step's shape with NaN and infinite cells
    (flagged panels run the exact form) and at Ny over TALL_NY (K6)."""
    for shape in ((4, 721, 1440), (2, kl.TALL_NY + 32, 128)):
        g = torch.Generator(device=cuda).manual_seed(31)
        Bq, Ny, Nx = shape
        q = (torch.linspace(-2, 2, Ny, device=cuda)[None, :, None]
             + torch.randn(shape, generator=g, device=cuda))
        q[0, 30:40, 100:120] = float("nan")
        q[1, 50, 7] = float("inf")
        Q = q.nanmean(-1).sort(-1).values.contiguous()
        W = torch.rand(Ny, Nx, generator=g, device=cuda) + 0.5
        kw = dict(increase=increase, variant2=variant2)
        before = kl.KERNEL_DENSE.launches + kl.KERNEL_DENSE_TALL.launches
        got = kl.lwa_dense(q, Q, W, part="split", **kw)
        torch.cuda.synchronize()
        assert kl.KERNEL_DENSE.launches + kl.KERNEL_DENSE_TALL.launches \
            == before + 1
        for i, part in enumerate(("upper", "lower")):
            want = kl.lwa_dense(q, Q, W, part=part, **kw)
            # the infinite cell's pairs give NaN (inf * 0) in both
            assert torch.equal(torch.isnan(got[i]), torch.isnan(want))
            assert torch.equal(torch.nan_to_num(got[i]),
                               torch.nan_to_num(want)), (shape, part)
        # the infinite cell's pairs are infinite or NaN in every part
        whole = kl.lwa_dense(q, Q, W, **kw)
        total = got[0] + got[1]
        m = torch.isfinite(whole)
        assert torch.equal(torch.isfinite(total), m)
        torch.testing.assert_close(total[m], whole[m], rtol=0,
                                   atol=1e-5 * whole[m].abs().max())


@pytest.mark.cuda
def test_pipeline_split_on_the_card(cuda):
    """Two K4 launches a call and no K3 or K5, a graph from the second
    call on, and each call's halves against the CPU's (K2's float
    atomics add in no fixed order, so two calls need not agree bit for
    bit)."""
    grid = _grid(cuda)
    q = _field(37, torch.float32).to(cuda)
    table = xt.core.cal_area_eqCoord_table_hist(
        grid.fluid_mask(), grid.ydef, grid.dA, increase=True, lt=True)
    records = (kl.KERNEL_DENSE, kl.KERNEL_LIN, kl.KERNEL_LIN2)
    graphs = pipeline.GRAPHS
    c0 = graphs.captures
    outs = []
    for _ in range(3):
        before = [r.launches for r in records]
        outs.append(xt.lwa_pipeline(q, grid, N=N, part="split",
                                    table=table))
        torch.cuda.synchronize()
        assert [r.launches - b for r, b in zip(records, before)] == [2, 0, 0]
    assert graphs.captures == c0 + 1
    cpu = xt.lwa_pipeline(q.cpu(), _grid(), N=N, part="split")
    for out in outs:
        for key in HALVES:
            w = cpu[key]
            torch.testing.assert_close(out[key].cpu(), w, rtol=0,
                                       atol=1e-4 * w.abs().max(), msg=key)
