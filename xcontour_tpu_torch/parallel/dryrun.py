"""A dry run of the sharded path over an n-rank gloo mesh on the CPU.

    python -m xcontour_tpu_torch.parallel.dryrun 8

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``: every
pipeline family sharded over a ('batch', 'x') mesh at tiny shapes, each
rank holding its block, against the unsharded step on the whole arrays
(which every rank also runs): the combined Keff + LWA step, Keff by the
histogram and the broadcast integrals, LWA and LWA2, contour lengths,
fractal dimension (gathered whole on each x rank, as GSPMD replicates it),
the explicit collectives, the sharded CDF and exact sort, a 1 x n mesh
(all ranks on x) with windowed lengths, and the hybrid mesh on one node
and over two fake nodes.  On CPU tensors every kernel wrapper runs its
plain version.  :func:`dryrun_multichip` launches the ranks as
subprocesses and raises if any fails.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

# float32 bounds relative to each output's largest magnitude, the port
# suite's (tests/test_torch_pipeline.py): the summation order of the
# sorted state, differences of CDFs along the contour index, and the 'lin'
# LWA floor (its R and E terms cancel; slabs of another width reduce in
# another order)
TOL = dict(Leq2=1e-4, nkeff=1e-4, dgrdSdA=1e-4, dqdA=1e-4, cmGrd=1e-4,
           cmInvGrd=1e-4, D=5e-4, D_bc=5e-4, lwa=1.5e-4, lwa2=1.5e-4)
TOL_DEFAULT = 2e-5


def _close(got, want, what, key=None):
    got, want = got.double().numpy(), want.double().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    scale = float(np.nanmax(np.abs(want))) if np.isfinite(want).any() else 0.
    np.testing.assert_allclose(got, want, rtol=0, equal_nan=True,
                               atol=TOL.get(key, TOL_DEFAULT) * scale,
                               err_msg=what)


def rank_main(workdir: str) -> None:
    """Every check of the dry run on this rank (rank 0 prints)."""
    import torch
    import torch.distributed as dist

    import xcontour_tpu_torch as xt
    from . import _comm
    from . import pipeline as sp
    from .histogram import sharded_weighted_cdf
    from .local_length import sharded_local_lengths
    from .mesh import (axis_size, make_hybrid_mesh, make_mesh,
                       shard_batch_spec)
    from .sort import sharded_exact_conditional_integral

    n = dist.get_world_size()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    mesh = make_mesh()
    bsz, xsz = axis_size(mesh, "batch"), axis_size(mesh, "x")
    Ny, Nx = 16, 8 * xsz
    lat = np.linspace(-80, 80, Ny)
    lon = np.linspace(0, 360 - 360 / Nx, Nx)
    grid = xt.from_latlon(lat, lon, device="cpu")
    rng = np.random.default_rng(0)
    B = 2 * bsz
    tracer = torch.as_tensor(
        np.sin(np.deg2rad(lat))[None, :, None]
        + 0.1 * rng.standard_normal((B, Ny, Nx)), dtype=torch.float32)
    spec = shard_batch_spec(mesh, 3)
    tb = spec.block(tracer)

    def joined(local, x_sharded):
        return spec.gather(local, x_sharded)

    def same(got, want, x_keys, what):
        for k, v in want.items():
            if hasattr(v, "shape") and k != "table":
                _close(joined(got[k], k in x_keys), v, f"{what}: {k}", k)

    same(sp.sharded_keff_lwa_pipeline(tb, grid, mesh, N=9),
         xt.keff_lwa_pipeline(tracer, grid, N=9), sp.X_SHARDED, "keff_lwa")
    say(f"  [mesh {bsz}x{xsz}] keff_lwa_pipeline (sharded step)")
    for hist in (True, False):
        got = xt.pipeline.flatten_output(
            sp.sharded_keff_pipeline(tb, grid, mesh, N=9, hist=hist))
        want = xt.pipeline.flatten_output(
            xt.keff_pipeline(tracer, grid, N=9, hist=hist))
        same(got, want, (), f"keff hist={hist}")
    say(f"  [mesh {bsz}x{xsz}] keff_pipeline (histogram and broadcast)")
    same(sp.sharded_lwa_pipeline(tb, grid, mesh, N=9),
         xt.lwa_pipeline(tracer, grid, N=9), sp.X_SHARDED, "lwa")
    say(f"  [mesh {bsz}x{xsz}] lwa_pipeline (LWA and LWA2)")
    got = sp.sharded_clength_pipeline(tb, grid, mesh, N=9)
    same(got, xt.clength_pipeline(tracer, grid, N=9), (), "clength")
    assert torch.isfinite(joined(got["lengths"], False)[:, 2:-2]).any()
    say(f"  [mesh {bsz}x{xsz}] clength_pipeline (halo lengths)")
    whole = _comm.all_gather(tb, mesh.get_group("x"), dim=-1)
    same(xt.fractal_pipeline(whole, grid, N=9, strides=(1, 2)),
         xt.fractal_pipeline(tracer, grid, N=9, strides=(1, 2)), (),
         "fractal")
    say(f"  [mesh {bsz}x{xsz}] fractal_pipeline (x slabs gathered)")

    # the explicit collectives: a ring shift each way and a gather
    g, ix = mesh.get_group("x"), mesh.get_local_rank("x")
    me = torch.full((3,), float(ix))
    assert _comm.shift(me, g, 1)[0] == (ix - 1) % xsz
    assert _comm.shift(me, g, -1)[0] == (ix + 1) % xsz
    assert _comm.all_gather(me[:1], g).tolist() == list(map(float,
                                                            range(xsz)))
    assert _comm.sum_(me, g)[0] == sum(range(xsz))
    assert _comm.max_(me, g)[0] == xsz - 1 and _comm.min_(me, g)[0] == 0
    say(f"  [mesh {bsz}x{xsz}] collectives: shift, gather, sum, min, max")

    ctr = xt.cal_contours(tracer, 9)
    dA_l = shard_batch_spec(mesh, 2).block(grid.dA)
    _close(joined(sharded_weighted_cdf(tb, ctr[0], dA_l, True, mesh), False),
           xt.core.cal_integral_within_contours_hist(tracer, ctr[0], grid.dA,
                                                     lt=True), "cdf")
    say(f"  [mesh {bsz}x{xsz}] sharded_weighted_cdf (local CDF + sum)")
    cb = ctr[spec.index(tracer.shape)[0]]
    _close(joined(sharded_exact_conditional_integral(tb, cb, dA_l, True,
                                                     mesh), False),
        xt.cal_integral_within_contours_exact(tracer, ctr, grid.dA, lt=True),
        "exact")
    say(f"  [mesh {bsz}x{xsz}] sharded_exact_conditional_integral")

    # all ranks on x: the combined step and the windowed lengths
    mesh_x = make_mesh(x_size=n)
    Nxh = 8 * n
    lonh = np.linspace(0, 360 - 360 / Nxh, Nxh)
    gridh = xt.from_latlon(lat, lonh, device="cpu")
    th = torch.as_tensor(np.sin(np.deg2rad(lat))[None, :, None]
                         + 0.1 * rng.standard_normal((2, Ny, Nxh)),
                         dtype=torch.float32)
    sx = shard_batch_spec(mesh_x, 3)
    got = sp.sharded_keff_lwa_pipeline(sx.block(th), gridh, mesh_x, N=9)
    _close(sx.gather(got["lwa"]), xt.keff_lwa_pipeline(th, gridh, N=9)["lwa"],
           "1xn lwa", "lwa")
    say(f"  [mesh 1x{n}] keff_lwa_pipeline (pure spatial sharding)")
    yc, xc = torch.as_tensor(lat), torch.as_tensor(lonh)
    L, _, _ = sharded_local_lengths(shard_batch_spec(mesh_x, 2).block(th[0]),
                                    yc, xc, mesh_x, window=9, stride=4)
    _close(L, xt.local_contour_lengths(th[0], yc, xc, window=9,
                                       stride=4)[0], "local")
    say(f"  [mesh 1x{n}] sharded_local_lengths (gather, windows split)")

    # the hybrid mesh: one node is make_mesh; two fake nodes keep each x
    # row inside a node
    mesh_h = make_hybrid_mesh()
    assert tuple(mesh_h.shape) == tuple(mesh.shape)
    half = n // 2
    mesh_2 = make_hybrid_mesh(x_size=max(half // 2, 1),
                              slice_of=lambda r: r // half)
    for row in mesh_2.mesh.tolist():
        assert len({r // half for r in row}) == 1, "x row crosses nodes"
    s2 = shard_batch_spec(mesh_2, 3)
    got = sp.sharded_keff_lwa_pipeline(s2.block(tracer), grid, mesh_2, N=9)
    _close(s2.gather(got["nkeff"], False),
           xt.keff_lwa_pipeline(tracer, grid, N=9)["nkeff"], "hybrid nkeff",
           "nkeff")
    say(f"  [mesh hybrid-2node {tuple(mesh_2.shape)}] keff_lwa_pipeline")
    say(f"dryrun_multichip OK on {n} ranks (mesh {bsz}x{xsz} + 1x{n} + "
        "hybrid, batch {B}): keff_lwa, keff hist/broadcast, lwa(1+2), "
        "clength, fractal, collectives, sharded CDF, sharded exact sort, "
        "windowed lengths".replace("{B}", str(B)), flush=True)
    with open(os.path.join(workdir, f"ok{dist.get_rank()}"), "w") as f:
        f.write("ok")


def dryrun_multichip(n_ranks: int, timeout: float = 300.0) -> str:
    """Run :func:`rank_main` on ``n_ranks`` gloo CPU ranks (subprocesses);
    returns rank 0's log."""
    from .launch import run_ranks
    with tempfile.TemporaryDirectory() as d:
        logs = run_ranks("xcontour_tpu_torch.parallel.dryrun:rank_main",
                         n_ranks, d, timeout=timeout,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        missing = [r for r in range(n_ranks)
                   if not os.path.exists(os.path.join(d, f"ok{r}"))]
        if missing:
            raise RuntimeError(f"dry run: ranks {missing} did not finish")
    return logs[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8),
          end="")
