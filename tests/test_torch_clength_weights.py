"""G, the contour-length chain's five CDF weights (``kernels.gradw``), and
its path: ``ops.stencil.clength_weights``, ``ops.histogram.
weighted_cdf_stacked`` and the layouts' ``clength_cdf``.

On the CPU: the plain version bit for bit with the chain it replaced (the
gradient, |grad q|^2, |grad q|, the five products, the broadcast and
stack), in float32 and float64, on every x and y boundary, NaN cells and
cells where |grad q| is 0; the stacked CDF bit for bit with
``weighted_cdf_multi``; ``clength_pipeline`` bit for bit with that chain
and against the JAX package; its gradients; the mesh layout on two gloo
ranks against the sharded chain; one launch of G a call.

On the card (``-m cuda``; skipped without one): G bit for bit with its
plain version at small and ERA5 shapes, at one column a lane, and a
replayed step bit for bit with its eager body.  Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_clength_weights.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import core, parallel as P, pipeline
from xcontour_tpu_torch.diagnostics.length import contour_lengths
from xcontour_tpu_torch.kernels import gradw, hist
from xcontour_tpu_torch.ops import histogram, stencil
from xcontour_tpu_torch.parallel.histogram import sharded_weighted_cdf_multi
from xcontour_tpu_torch.parallel.launch import run_ranks

CPU = "cpu"
BC_Y = ("extend", "reflect", "fill")
KEYS = ("contour", "intArea", "Yeq", "lengths", "Lmin", "Leq2", "nkeff",
        "cmGrd", "cmInvGrd")


def _same(got, want, where=""):
    """Bit for bit, NaN patterns included, dicts and lists item by item."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}/{i}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, where
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=where)


def _field(seed, B=3, Ny=20, Nx=32, dtype=torch.float64, flat=True):
    """Snapshots over latitude with noise, a below-ground NaN box on the
    first, and (``flat``) a patch of constant value on the second, where
    |grad q| is 0."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(-75.0, 75.0, Ny)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.2 * rng.standard_normal((B, Ny, Nx)))
    q[0, 2:6, 5:12] = np.nan
    if flat:
        q[1, 8:13, 10:18] = 0.25
    return lat, torch.as_tensor(q, dtype=dtype)


def _grids(lat, Nx, dtype):
    """A periodic lat-lon grid and a non-periodic Cartesian grid for each
    y wall."""
    lon = np.linspace(0.0, 360.0 - 360.0 / Nx, Nx)
    ll = xt.from_latlon(lat, lon, dtype=dtype, device=CPU)
    cart = xt.from_cartesian(np.arange(len(lat)) * 40.0 + 3.0,
                             np.arange(Nx) * 55.0, periodic_x=False,
                             dtype=dtype, device=CPU)
    out = {f"latlon_{bc}": dataclasses.replace(ll, bc_y=bc) for bc in BC_Y}
    out.update({f"cart_{bc}": dataclasses.replace(cart, bc_y=bc)
                for bc in BC_Y})
    return out


def chain_weights(q, grid, dA):
    """The chain ``clength_pipeline`` ran before G: the gradient, grdS,
    grdm, the weights as cal_contour_mean_hist forms them."""
    qy, qx = xt.gradient(q, grid)
    grdS = qx * qx + qy * qy
    grdm = torch.sqrt(grdS)
    return [dA, grdS * dA, (grdm * grdm) * dA, grdm * dA,
            ((1.0 / grdm) * grdm) * dA]


def chain_stack(q, grid, dA):
    """The weights broadcast and stacked as ``_ascending_cdf`` hands them
    to K2, (B, 5, Ny, Nx)."""
    return torch.stack([torch.broadcast_to(w, q.shape)
                        for w in chain_weights(q, grid, dA)], dim=1)


def chain_clength(tracer, grid, N, *, increase=True, lt=True, table=None):
    """``clength_pipeline`` as it ran before G, on the whole plane."""
    dtype = tracer.dtype
    ydef = grid.ydef.to(dtype)
    dA = grid.dA.to(dtype)
    mask = grid.fluid_mask(dtype)
    weights = chain_weights(tracer, grid, dA)
    if table is None:
        table = core.cal_area_eqCoord_table_hist(mask, ydef, dA,
                                                 increase=increase, lt=lt)
    ctr = core.cal_contours(tracer, N, increase=increase)
    intArea, intgrdS, int_gg, int_g, int_ig = histogram.weighted_cdf_multi(
        tracer, ctr, weights, lt)
    Yeq = table.lookup_coordinates(intArea)
    lengths = contour_lengths(tracer, ctr, grid.ydef, grid.xdef,
                              latlon=grid.latlon)
    Lmin = pipeline._lmin("frac", Yeq, grid, mask, ydef)
    lower = core.cal_gradient_wrt_area(int_g, intArea)
    cmGrd = core.grad_safe_div(core.cal_gradient_wrt_area(int_gg, intArea),
                               lower)
    cmInvGrd = core.grad_safe_div(
        core.cal_gradient_wrt_area(int_ig, intArea), lower)
    k = pipeline._keff(ctr, intArea, intgrdS, Lmin, 1e5)
    return dict(contour=ctr, intArea=intArea, Yeq=Yeq, lengths=lengths,
                Lmin=Lmin, Leq2=k["Leq2"], nkeff=k["nkeff"], cmGrd=cmGrd,
                cmInvGrd=cmInvGrd)


def _plain(q, grid, dA):
    dy, dx = stencil._spacing(grid, q.dtype)
    return gradw.clength_weights_plain(q, dx.contiguous(), dy, dA,
                                       periodic_x=grid.periodic_x,
                                       bc_y=grid.bc_y)


# ---------------------------------------------------------------- the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["latlon_extend", "latlon_reflect",
                                   "latlon_fill", "cart_extend",
                                   "cart_reflect", "cart_fill"])
def test_plain_version_is_the_chain_bit_for_bit(dtype, which):
    lat, q = _field(1, dtype=dtype)
    grid = _grids(lat, q.shape[-1], dtype)[which]
    dA = grid.dA.to(dtype)
    got = _plain(q, grid, dA)
    _same(got, chain_stack(q, grid, dA), which)
    assert got.shape == (3, gradw.CHANNELS) + q.shape[1:]
    assert got.is_contiguous()
    # the NaN box and the flat patch: channel 4 is NaN where grdm is 0
    ch4 = got[:, 4]
    assert torch.isnan(ch4[0, 2:6, 5:12]).all()
    assert torch.isnan(ch4[1, 9:12, 11:17]).all()
    assert (got[1, 1, 9:12, 11:17] == 0).all()
    assert torch.isfinite(ch4[2]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_op_stacks_any_batch_shape(dtype):
    """``ops.stencil.clength_weights`` on (Ny, Nx), (B, Ny, Nx) and
    (2, B, Ny, Nx) snapshots: (..., 5, Ny, Nx), the plain version's
    values."""
    lat, q = _field(2, B=4, dtype=dtype)
    grid = _grids(lat, q.shape[-1], dtype)["latlon_extend"]
    dA = grid.dA.to(dtype)
    want = _plain(q, grid, dA)
    _same(stencil.clength_weights(q, grid, dA), want)
    _same(stencil.clength_weights(q[2], grid, dA), want[2])
    _same(stencil.clength_weights(q.reshape(2, 2, *q.shape[1:]), grid, dA),
          want.reshape(2, 2, *want.shape[1:]))


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("increase", [True, False])
def test_stacked_cdf_is_weighted_cdf_multi_bit_for_bit(lt, increase):
    """On the same five channels, one launch on the stack as it is against
    ``weighted_cdf_multi``'s broadcast and stack; the bins increasing or
    decreasing, shared or one row a snapshot."""
    lat, q = _field(3)
    grid = _grids(lat, q.shape[-1], torch.float64)["latlon_extend"]
    dA = grid.dA
    ws = chain_weights(q, grid, dA)
    ctr = core.cal_contours(q, 13, increase=increase)
    stacked = _plain(q, grid, dA)
    for bins in (ctr, ctr[0]):
        want = histogram.weighted_cdf_multi(q, bins, ws, lt)
        _same(histogram.weighted_cdf_stacked(q, bins, stacked, lt), want)
        # the channels as a tuple take the same launch
        _same(histogram.weighted_cdf_stacked(
            q, bins, tuple(stacked.unbind(1)), lt), want)


@pytest.mark.parametrize("lt", [True, False])
@pytest.mark.parametrize("increase", [True, False])
@pytest.mark.parametrize("which", ["latlon_extend", "cart_reflect",
                                   "cart_fill"])
def test_clength_pipeline_is_the_chain_bit_for_bit(which, increase, lt):
    lat, q = _field(4)
    grid = _grids(lat, q.shape[-1], torch.float64)[which]
    if not increase:
        q = -q
    got = xt.clength_pipeline(q, grid, N=15, increase=increase, lt=lt)
    assert set(got) == set(KEYS)
    _same(got, chain_clength(q, grid, 15, increase=increase, lt=lt))
    # with a table passed in, and in float32
    qf = q.float()
    gf = _grids(lat, q.shape[-1], torch.float32)[which]
    table = core.cal_area_eqCoord_table_hist(
        gf.fluid_mask(torch.float32), gf.ydef, gf.dA, increase=increase,
        lt=lt)
    _same(xt.clength_pipeline(qf, gf, N=15, increase=increase, lt=lt,
                              table=table),
          chain_clength(qf, gf, 15, increase=increase, lt=lt, table=table))


@pytest.mark.parametrize("masked", [False, True])
def test_clength_pipeline_matches_jax(masked):
    """The JAX package's clength_pipeline on the same float64 inputs, held
    as ``test_torch_geometry_pipeline`` holds it: 1e-10 of each key's
    largest magnitude, the same NaN pattern."""
    import jax.numpy as jnp
    from xcontour_tpu import grid as jgrid
    from xcontour_tpu import pipeline as jpipe

    lat, q = _field(5, flat=False)
    Nx = q.shape[-1]
    lon = np.linspace(0.0, 360.0 - 360.0 / Nx, Nx)
    mask = None
    if masked:
        mask = np.ones(q.shape[1:])
        mask[:3, :] = 0.0
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    got = xt.clength_pipeline(
        q, tg, None if mask is None else torch.as_tensor(mask), N=17)
    want = jpipe.clength_pipeline(
        jnp.asarray(q.numpy()), jg, None if mask is None else
        jnp.asarray(mask), N=17)
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        m = np.isfinite(w)
        scale = np.abs(w[m]).max()
        np.testing.assert_allclose(g[m], w[m], rtol=0, atol=1e-10 * scale,
                                   err_msg=k)


def test_gradients_are_the_chains():
    """d(cmGrd, cmInvGrd, Leq2)/d tracer through G's Function and K2's,
    against autograd through the chain: the same non-finite cells (a loss
    of Leq2 alone leaves the mean channels without cotangents, as the
    chain does) and the same values to 1e-14 of the largest |gradient|.
    The backward recomputes the chain's own operations, but the tracer's
    cotangent gathers the weights' branch beside the levels' and the
    lengths' in another order (a few cells differ by an ulp)."""
    lat, q = _field(6)
    grid = _grids(lat, q.shape[-1], torch.float64)["latlon_extend"]
    table = core.cal_area_eqCoord_table_hist(
        grid.fluid_mask(torch.float64), grid.ydef, grid.dA, increase=True,
        lt=True)

    def loss(fn, keys):
        t = q.clone().requires_grad_(True)
        out = fn(t)
        total = sum(torch.nansum(torch.where(torch.isfinite(out[k]), out[k],
                                             torch.zeros_like(out[k])))
                    for k in keys)
        g, = torch.autograd.grad(total, t)
        return g

    for keys in (("cmGrd", "cmInvGrd", "Leq2"), ("Leq2",), ("cmInvGrd",)):
        got = loss(lambda t: xt.clength_pipeline(t, grid, N=11, table=table),
                   keys)
        want = loss(lambda t: chain_clength(t, grid, 11, table=table), keys)
        m = torch.isfinite(want)
        assert m.any()
        assert torch.equal(torch.isnan(got), torch.isnan(want)), keys
        assert torch.equal(torch.isfinite(got), m), keys
        torch.testing.assert_close(got[m], want[m], rtol=0,
                                   atol=1e-14 * want[m].abs().max().item(),
                                   msg=str(keys))


def test_one_plain_call_and_one_launch_a_pipeline_call(monkeypatch):
    """clength_pipeline calls G's wrapper once (its plain version on the
    CPU) and K2's once, with or without a gradient; the backward calls
    neither wrapper."""
    calls = {}

    def count(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    count(gradw, "clength_weights")
    count(gradw, "clength_weights_plain")
    count(hist, "weighted_cdf")
    lat, q = _field(7)
    grid = _grids(lat, q.shape[-1], torch.float64)["latlon_extend"]
    for grad in (False, True):
        calls.clear()
        t = q.clone().requires_grad_(grad)
        out = xt.clength_pipeline(t, grid, N=9)
        if grad:
            g, = torch.autograd.grad(torch.nansum(out["cmGrd"]), t)
            assert torch.isfinite(g).any()
        # the table build is the other K2 call
        assert calls == dict(clength_weights=1, clength_weights_plain=1,
                             weighted_cdf=2), (grad, calls)


def rank_clength_cdf(workdir):
    """On a 1x2 mesh: the mesh layout's ``clength_cdf`` on this rank's x
    block against the sharded chain it keeps (the halo gradient, the five
    products, one K2 launch and one sum over 'x'), and the sharded step
    against the unsharded one; rank 0 saves both."""
    import torch.distributed as dist
    from xcontour_tpu_torch.parallel.pipeline import _MeshLayout

    mesh = P.make_mesh(x_size=2)
    lat, q = _field(8, B=2, Ny=16, Nx=24)
    q[0, 4:9, 9:15] = np.nan                     # across the shard edge
    grid = _grids(lat, q.shape[-1], torch.float64)["latlon_extend"]
    qb = P.shard_batch_spec(mesh, 3).block(q)
    layout = _MeshLayout(mesh)
    dA_x = layout.block(grid.dA, qb.shape[-1])
    ctr = core.cal_contours(q, 11)
    got = layout.clength_cdf(qb, grid, ctr, dA_x, True)
    qy, qx = P.sharded_gradient(qb, grid, mesh)
    grdS = qx * qx + qy * qy
    grdm = torch.sqrt(grdS)
    want = sharded_weighted_cdf_multi(
        qb, ctr, [dA_x, grdS * dA_x, (grdm * grdm) * dA_x, grdm * dA_x,
                  ((1.0 / grdm) * grdm) * dA_x], True, mesh)
    step = P.sharded_clength_pipeline(qb, grid, mesh, N=11)
    whole = xt.clength_pipeline(q, grid, N=11)
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, "out.npz"),
                 **{f"got{i}": t.numpy() for i, t in enumerate(got)},
                 **{f"want{i}": t.numpy() for i, t in enumerate(want)},
                 **{f"step_{k}": v.numpy() for k, v in step.items()},
                 **{f"whole_{k}": v.numpy() for k, v in whole.items()})


def test_mesh_layout_keeps_the_sharded_chain(tmp_path):
    run_ranks(f"{os.path.abspath(__file__)}:rank_clength_cdf", world=2,
              workdir=str(tmp_path), timeout=240.0)
    out = np.load(tmp_path / "out.npz")
    for i in range(gradw.CHANNELS):
        np.testing.assert_array_equal(out[f"got{i}"], out[f"want{i}"])
    for k in KEYS:
        g, w = out[f"step_{k}"], out[f"whole_{k}"]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        m = np.isfinite(w)
        np.testing.assert_allclose(g[m], w[m], rtol=1e-9,
                                   atol=1e-12 * np.abs(w[m]).max(),
                                   err_msg=k)


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(dev, B, Ny, Nx, seed):
    lat, q = _field(seed, B=B, Ny=Ny, Nx=Nx, dtype=torch.float32)
    return lat, q.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 72), (3, 721, 1440),
                                   (2, 45, 1439)])
def test_kernel_is_the_plain_version_bit_for_bit(cuda, shape):
    """Every wall on a lat-lon and a Cartesian grid; Nx = 1439 takes one
    column a lane."""
    B, Ny, Nx = shape
    lat, q = _card_case(cuda, B, Ny, Nx, seed=11)
    for name, g in _grids(lat, Nx, torch.float32).items():
        grid = dataclasses.replace(g, **{
            f.name: getattr(g, f.name).to(cuda)
            for f in dataclasses.fields(g)
            if isinstance(getattr(g, f.name), torch.Tensor)})
        dy, dx = stencil._spacing(grid, q.dtype)
        args = (q, dx.contiguous(), dy.contiguous(), grid.dA.contiguous())
        kw = dict(periodic_x=grid.periodic_x, bc_y=grid.bc_y)
        n0 = gradw.KERNEL.launches
        got = gradw.clength_weights(*args, **kw)
        assert gradw.KERNEL.launches == n0 + 1
        _same(got, gradw.clength_weights_plain(*args, **kw), f"{shape} {name}")


@pytest.mark.cuda
def test_a_replayed_step_is_the_eager_step_bit_for_bit(cuda, monkeypatch):
    """clength_pipeline replayed as a CUDA graph on a field whose every K2
    sum is exact, bit for bit with its eager body, one G launch a call."""
    monkeypatch.setattr(pipeline, "GRAPHS", pipeline.Graphs())
    B, ny, nx = 3, 64, 128
    grid = xt.from_cartesian(np.arange(ny, dtype=np.float64),
                             np.arange(nx, dtype=np.float64), device=cuda)
    table = core.cal_area_eqCoord_table_hist(grid.fluid_mask(), grid.ydef,
                                             grid.dA, increase=True, lt=True)

    def exact(seed):
        x = torch.arange(nx)
        tri = torch.minimum(x, nx - x)
        q = 2.0 * (tri[None, None, :] + 3 * torch.arange(B)[:, None, None]
                   + seed)
        q = q.expand(B, ny, nx).to(torch.float32).clone()
        q[0, 2:5, 10:20] = float("nan")
        return q.to(cuda)

    q0, q1 = exact(1), exact(2)
    fn = pipeline.clength_pipeline
    for i, q in enumerate((q0, q1, q0)):
        n0 = gradw.KERNEL.launches
        got = fn(q, grid, N=31, table=table)
        torch.cuda.synchronize()
        assert gradw.KERNEL.launches == n0 + 1, i
        _same(got, fn.__wrapped__(q, grid, N=31, table=table), f"call {i}")
    g = pipeline.GRAPHS
    assert (g.captures, g.replays, g.eager) == (1, 2, 1)
