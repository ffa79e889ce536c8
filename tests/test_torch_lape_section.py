"""The LAPE section of the benchmark's ``mitgcm_xz_lape`` deployment on
the CPU: the port's ``lwa_pipeline`` on a ``from_xz`` grid with partial
cells (increase=False, lt=False) against the benchmark's plain float64
reference ``xcbench/reference/lape.py``, which shares no code with the
port; that reference against the JAX package's ``lwa_pipeline`` on the
same inputs, so that it keeps xcontour's conventions; faults of the
reference that the comparison must see; LAPE = -lwa positive-definite to
the float32 'lin' floor; and the share of overturned snapshots that the
field maker ``xcbench/fields/internalwave.py`` states."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xcontour_tpu as xj
import xcontour_tpu_torch as xt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from xcbench import compare, harness  # noqa: E402
from xcbench.reference import lape  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
F64 = torch.float64
CONFIG = json.loads((REPO / "xcbench" / "configs" / "mitgcm_xz_lape.json")
                    .read_text())
MAKER = harness.load_module(REPO / "xcbench" / "fields" / "internalwave.py")
KEYS = ["contour", "intArea", "latEq", "Q", "lwa", "lwa2"]
SPEC = {"keys": KEYS, "amplified": ["latEq"], "extreme_area": 1e-4}
N = 21
# float64 port against the float64 reference: the same terms summed in
# other orders (K2's digitize and cumsum against a sort and cumsum; K3's
# and K5's linearized sums against the pairwise 3-valued masks), each a
# sum of at most a few thousand cells, so rounding at ~1e-15 of the
# largest magnitude; Z_eq and Q pass that through the table's slope, and
# the lin paths' R and E terms cancel to ~1e-13.  1e-10 leaves three
# orders of magnitude above the largest seen (2.4e-14) and lies far under
# every fault below (the smallest moves a key by more than 1e-4).
TOL64 = 1e-10


def _section(nz=24, nx=96, B=3, seed=2 ** 31 + 5, t=0, **field):
    """A small section over the configuration's ridge: nz levels and nx
    columns spanning its depth and length, partial cells and rock."""
    g = json.loads(json.dumps(CONFIG["grid"]))
    dz = 200.0 / nz
    dx = 8960.0 / nx
    g["z"].update(first=-dz / 2, step=-dz, num=nz)
    g["x"].update(first=dx / 2, step=dx, num=nx)
    Z, X, h = MAKER.section(g)
    spec = {**CONFIG["field"], **field}
    q = MAKER.make(spec, Z, X, h, B, seed, t, CPU)
    return Z, X, h, q


def _port(q, Z, X, h, dtype=F64, **kw):
    grid = xt.from_xz(Z, X, h, mask=(h > 0).astype(np.float64),
                      dtype=dtype, device=CPU)
    table = xt.cal_area_eqCoord_table_hist(
        grid.fluid_mask(dtype), grid.ydef, grid.dA, increase=False,
        lt=False)
    return xt.lwa_pipeline(q.to(dtype), grid, N=N, increase=False,
                           lt=False, table=table, **kw)


def _reference(q, Z, X, h, **kw):
    return lape.run(q.double(), lape.xz_grid(Z, X, h, F64, CPU), N=N,
                    **{"increase": False, "lt": False, **kw})


def test_section_has_partial_cells_rock_and_overturns():
    Z, X, h, q = _section()
    assert Z[0] < 0 and Z[0] > Z[-1]                     # descending
    assert ((h > 0) & (h < 1)).any() and (h == 0).any()
    assert torch.isnan(q).equal(torch.as_tensor(h == 0).expand_as(q))


@pytest.mark.parametrize("method", ["auto", "dense"])
def test_port_against_reference(method):
    Z, X, h, q = _section()
    got = _port(q, Z, X, h, lwa_method=method)
    want = _reference(q, Z, X, h)
    gaps = compare.gaps(got, want, SPEC)
    assert max(gaps.values()) < TOL64, gaps


def test_reference_against_the_jax_package():
    Z, X, h, q = _section(seed=7)
    grid = xj.grid.from_xz(Z, X, h, mask=(h > 0).astype(np.float64),
                           dtype=jnp.float64)
    got = xj.pipeline.lwa_pipeline(jnp.asarray(q.double().numpy()), grid,
                                   N=N, increase=False, lt=False)
    got = {k: torch.as_tensor(np.array(got[k])) for k in KEYS}
    gaps = compare.gaps(got, _reference(q, Z, X, h), SPEC)
    assert max(gaps.values()) < TOL64, gaps


def _no_hfac(q, Z, X, h):
    return _reference(q, Z, X, (h > 0).astype(np.float64))


def _lt_flipped(q, Z, X, h):
    return _reference(q, Z, X, h, lt=True)


def _lwa2_unflipped(q, Z, X, h):
    out = _reference(q, Z, X, h)
    g = lape.xz_grid(Z, X, h, F64, CPU)
    out["lwa2"] = lape.wave_activity(q.double(), out["Q"], g, True, True)
    return out


def _bfloat16_input(q, Z, X, h):
    return _reference(q.bfloat16(), Z, X, h)


@pytest.mark.parametrize("fault", [_no_hfac, _lt_flipped, _lwa2_unflipped,
                                   _bfloat16_input])
def test_faults_of_the_reference_are_seen(fault):
    Z, X, h, q = _section()
    gaps = compare.gaps(_port(q, Z, X, h), fault(q, Z, X, h), SPEC)
    assert max(gaps.values()) > 1e3 * TOL64, gaps


def test_lape_is_positive_definite_in_float32():
    # K3's plain version in float32: the 'lin' floor, ~5e-5 of the largest
    Z, X, h, q = _section(nz=50, nx=224, B=4, seed=11)
    out = _port(q, Z, X, h, dtype=torch.float32)
    lapes = -out["lwa"]
    for b in range(q.shape[0]):
        top = lapes[b].max()
        assert top > 0 and lapes[b].min() >= -5e-5 * top
    want = _reference(q, Z, X, h)
    assert (-want["lwa"]).min() >= 0


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_maker_draws_the_overturns_it_states(seed):
    B = 8
    s = MAKER.steepness(CONFIG["field"], B, seed, 1)
    assert (s > 1).sum() == B // 2 and (s < 1).sum() == B - B // 2
    Z, X, h, q = _section(nz=100, nx=448, B=B, seed=seed, t=1, noise_K=0.0)
    # b decreasing upwards: a fluid cell above one of smaller b, noise
    # aside (the rows run downwards)
    up, down = q[:, :-1], q[:, 1:]
    inverted = ((up < down) & ~torch.isnan(up) & ~torch.isnan(down)) \
        .flatten(1).any(1)
    assert inverted.tolist() == (s > 1).tolist()
