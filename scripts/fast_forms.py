#!/usr/bin/env python3
"""Time the two forms of the 'fast' LWA's weighted CDF on one CUDA card,
against the linearized kernels K3 (LWA) and K5 (LWA2).

    python3 scripts/fast_forms.py [--reps 5]

The c-term of the sort-merge LWA is a per-column weighted CDF of one set
of values at another set of queries.  Two forms compute it:

* search (the port's ``diagnostics/lwa._cdf_at``): sort each row's
  values, prefix-sum their weights, and search the queries strictly to
  the left; LWA2's values are the profile, shared by every column, so
  one sort of each profile serves the field;
* merge (``cdf_merge`` below): one stable segmented sort of the values
  and the queries together (queries first, so a tied value stays above
  its query), the prefix sums of the merged weights (0 at the queries),
  and a scatter back through the permutation.

For B = 4 snapshots of Ny x 512 (Ny in 1024 ... 8192, the JAX ladder's
shape, and 5120) and the ERA5 step (15 x 721 x 1440), the script times
``local_wave_activity[2]`` with method 'lin' (K3, K5) and 'fast', and the
merge form in its place (everything else of 'fast' shared), with CUDA
events, median of ``--reps`` calls after a warm-up, and each one's peak
memory above its inputs; it prints one line per shape with each method's
error against 'dense' (K4, K6: the reference's summation order) relative
to the field maximum, and fails past 1e-3 (a wrong form, not float32
noise: the 'fast' floor grows with Ny and passes 1e-4 near 4096 rows).
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import xcontour_tpu_torch as xt                               # noqa: E402
from xcontour_tpu_torch.diagnostics import lwa as tlwa         # noqa: E402

LADDER = (1024, 2048, 3072, 4096, 5120, 6144, 8192)


def cdf_merge(values, w0, w1, queries):
    """``diagnostics.lwa._cdf_at`` by the merge form: (S0, S1) (B, R, m),
    the sums of w0, w1 over the values strictly below each query, from one
    stable sort of the queries and values together (values (B, R, n) or
    (B, 1, n), broadcast to every row)."""
    B, R, m = queries.shape
    key = torch.cat([queries, values.expand(B, R, -1)], -1)
    _, perm = torch.sort(key, dim=-1, stable=True)
    z = torch.zeros_like(queries)
    out = []
    for w in (w0, w1):
        P = torch.gather(torch.cat([z, w], -1), -1, perm).cumsum(-1)
        out.append(torch.empty_like(P).scatter_(-1, perm, P)[..., :m])
    return out


def with_cdf(cdf, fn):
    """``fn`` run with ``diagnostics.lwa._cdf_at`` set to ``cdf``."""
    def run(*args):
        saved, tlwa._cdf_at = tlwa._cdf_at, cdf
        try:
            return fn(*args)
        finally:
            tlwa._cdf_at = saved
    return run


def median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def shape_inputs(B, Ny, Nx, seed, dev):
    """Synthetic PV on a Ny x Nx latitude-longitude grid, its sorted
    profile from lwa_pipeline, and the default LWA weight."""
    from xcontour_tpu_torch.utils.synth import synth_pv
    v, _ = synth_pv(nlev=B, nlat=Ny, nlon=Nx, seed=seed)
    grid = xt.from_latlon(v["latitude"], v["longitude"], device=dev)
    q = torch.as_tensor(v["pv"]).to(dev)
    Q = xt.lwa_pipeline(q, grid, N=241)["Q"].contiguous()
    W = (grid.dA / tlwa.nanmax(grid.dA) * grid.dA).contiguous()
    return q, Q, W


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fast_forms: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from xcontour_tpu_torch.kernels import lwa as kl
    shapes = [(4, ny, 512) for ny in LADDER] + [(15, 721, 1440)]
    for i, (B, Ny, Nx) in enumerate(shapes):
        q, Q, W = shape_inputs(B, Ny, Nx, 300 + i, dev)
        row = {}
        for v2 in (False, True):
            tag = "lwa2" if v2 else "lwa"
            lin = (kl.lwa_lin2 if v2 else kl.lwa_lin)
            search = tlwa._lwa2_fast if v2 else tlwa._lwa_fast
            merge = with_cdf(cdf_merge, search)
            ref = kl.lwa_dense(q, Q, W, increase=True, variant2=v2)
            scale = ref.abs().max().item()
            for name, fn in (("lin", lambda: lin(q, Q, W, increase=True)),
                             ("search", lambda: search(q, Q, W, True)),
                             ("merge", lambda: merge(q, Q, W, True))):
                err = (fn() - ref).abs().max().item() / scale
                if not err < 1e-3:
                    raise AssertionError(f"{tag} {name} at {Ny}: {err}")
                row[f"{tag}_{name}_err"] = err
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                row[f"{tag}_{name}_ms"] = median_ms(fn, args.reps)
                row[f"{tag}_{name}_gib"] = (torch.cuda.max_memory_allocated()
                                            - base) / 2 ** 30
        print(f"forms {B}x{Ny}x{Nx}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in row.items()), flush=True)
        del q, Q, W
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
