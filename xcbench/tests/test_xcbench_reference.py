"""Each cell's entry, through the port's CPU path in float64, against the
benchmark's plain reference at small sizes of both configurations: the
two compute the same quantities by different routes, so they agree to
float64 rounding.  And the reference's pieces against hand results."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import compare, harness  # noqa: E402
from xcbench.reference import core  # noqa: E402

from conftest import TINY_CONFIGS, TINY_CELLS  # noqa: E402

F64 = torch.float64


def _inputs(config, seed=20240611, t=0):
    cfg = {**json.loads((REPO / "xcbench" / "configs"
                         / f"{config}.json").read_text()),
           **TINY_CONFIGS[config]}
    lat, lon = harness.coords(cfg)
    maker = harness.load_module(REPO / "xcbench" / "fields"
                                / f"{cfg['field']['maker']}.py")
    q = maker.make(cfg["field"], lat, lon, cfg["batch"], seed, t, "cpu")
    return lat, lon, q.double()


def _cell(name):
    cell = json.loads((REPO / "xcbench" / "cells"
                       / f"{name}.json").read_text())
    return {**cell, **TINY_CELLS[name]}


@pytest.mark.parametrize("name", ["era5.keff_lwa", "era5.clength",
                                  "t170.fractal"])
def test_entry_against_reference(name):
    from xcontour_tpu_torch import core as pcore, grid as pgrid
    cell = _cell(name)
    cfg = cell["config"]
    lat, lon, q = _inputs(cfg)
    grid = pgrid.from_latlon(lat, lon, dtype=F64, device="cpu")
    kw = dict(cell["kwargs"])
    kw["table"] = pcore.cal_area_eqCoord_table_hist(
        grid.fluid_mask(F64), grid.ydef, grid.dA, increase=True, lt=True)
    got = harness.resolve(cell["entry"])(q, grid, **kw)
    chain = harness.load_module(REPO / "xcbench" / "reference"
                                / f"{cell['reference']}.py")
    want = chain.run(q, core.latlon_grid(lat, lon, F64, "cpu"),
                     **cell["reference_kwargs"])
    gaps = compare.gaps(got, want, cell["compare"])
    assert max(gaps.values()) < 1e-8, gaps


def test_archive_chain_against_keff_pipeline():
    from xcontour_tpu_torch import grid as pgrid, pipeline
    lat, lon, q = _inputs("era5_pv16")
    grid = pgrid.from_latlon(lat, lon, dtype=F64, device="cpu")
    got = pipeline.keff_pipeline(q, grid, N=21, hist=True, lmin="analytic")
    want = harness.load_module(REPO / "xcbench" / "reference" / "keff.py") \
        .run(q, core.latlon_grid(lat, lon, F64, "cpu"), N=21)
    gaps = compare.gaps(got["origin"], want,
                        _cell("era5.archive_keff")["compare"])
    assert max(gaps.values()) < 1e-8, gaps


def test_sums_below_by_hand():
    q = torch.tensor([[[1.0, 2.0], [3.0, float("nan")]]], dtype=F64)
    lev = torch.tensor([[1.0, 2.0, 3.0]], dtype=F64)
    w = torch.tensor([[10.0, 20.0], [40.0, 80.0]], dtype=F64)
    (s,) = core.sums_below(q, lev, [w])
    # below 1: none; below 2: the 1; up to and with 3: 1, 2 and 3
    assert s.tolist() == [[0.0, 10.0, 70.0]]


def test_interp_edges():
    xp = torch.tensor([0.0, 1.0, 1.0, 2.0], dtype=F64)
    fp = torch.tensor([0.0, 10.0, 20.0, 30.0], dtype=F64)
    x = torch.tensor([-1.0, 0.5, 1.0, 1.5, 3.0, float("nan")], dtype=F64)
    out = core.interp(x, xp, fp)
    assert out[:5].tolist() == [0.0, 5.0, 20.0, 25.0, 30.0]
    assert math.isnan(out[5])


def test_wave_activity_by_pairs():
    q = torch.tensor([[[0.0, 3.0], [1.0, 1.0], [5.0, 2.0]]], dtype=F64)
    Q = torch.tensor([[1.0, 2.0, 4.0]], dtype=F64)
    dA = torch.ones(3, 2, dtype=F64)
    out = core.wave_activity(q, Q, dA)
    want = torch.zeros(1, 3, 2, dtype=F64)
    for j in range(3):
        for x in range(2):
            for y in range(3):
                e = q[0, y, x] - Q[0, j]
                want[0, j, x] += max(e, 0) if y < j else max(-e, 0)
    assert torch.equal(out, want)


def test_contour_length_of_a_square():
    # a bump in the plane: the level 0.5 cuts every edge next to the
    # centre point at its middle, a diamond of side sqrt(0.5)
    q = torch.zeros(1, 3, 3, dtype=F64)
    q[0, 1, 1] = 1.0
    y = x = torch.arange(3, dtype=F64)
    L = core.contour_lengths(q, torch.tensor([[0.5, 2.0]], dtype=F64), y, x,
                             latlon=False)
    assert L[0, 0].item() == pytest.approx(4 * math.sqrt(0.5))
    assert math.isnan(L[0, 1])


def test_latlon_areas_sum_to_the_sphere():
    g = core.latlon_grid(np.linspace(-90, 90, 181), np.arange(360.0), F64,
                         "cpu")
    assert g["periodic"]
    assert g["dA"].sum().item() == pytest.approx(
        4 * math.pi * core.R_EARTH ** 2, rel=1e-12)


def test_coarsened_rule_leaves_out_vanishing_contours_only():
    # four contours on three strides: the third's coarsest length nearly
    # vanishes in the reference and is missing (NaN) in the program
    spec = {"keys": ["lengths", "D"], "coarsened": ["lengths", "D"],
            "vanish": 1e-3}
    L = torch.tensor([[[10.0, 8.0, 6.0], [12.0, 9.0, 7.0],
                       [11.0, 5.0, 1e-4], [9.0, 7.0, 5.0]]], dtype=F64)
    D = torch.tensor([[1.2, 1.3, 2.6, 1.1]], dtype=F64)
    want = {"lengths": L, "D": D}
    got = {"lengths": L.clone(), "D": D.clone()}
    got["lengths"][0, 2, 2] = float("nan")
    got["D"][0, 2] = 8.7
    assert compare.gaps(got, want, spec) == {"lengths": 0.0, "D": 0.0}
    # a fault on half of the lasting contours is seen in full
    got["D"][0, :2] *= 1.5
    assert compare.gaps(got, want, spec)["D"] == pytest.approx(0.65 / 1.3)
    got["lengths"][0, 3, 1] = float("nan")
    assert compare.gaps(got, want, spec)["lengths"] == compare.MISMATCH
