"""The cell ``era5.local``: K8's frozen work against counts made by hand,
the plain reference of windowed lengths against the program's plain path
and the bfloat16 control against the cell's limits, and the cell's runs on
the CPU at a tiny size (correct, with the traced metrics it names; the
control and the faults of ``test_xcbench_runs.py`` run on it there)."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import compare, harness, roofline_work as rw  # noqa: E402
from xcbench import work_local as wl  # noqa: E402
from xcbench.reference import core, local  # noqa: E402

from xcbench.conftest import TINY_LOCAL  # noqa: E402

from conftest import TINY_CONFIGS, run_cpu  # noqa: E402

F64 = torch.float64
CELL = json.loads((REPO / "xcbench" / "cells" / "era5.local.json")
                  .read_text())


def test_k8_work_by_hand():
    # one 3x4 field 0..11 by rows: cell (i, j) spans [q[i, j], q[i, j] + 5);
    # windows of 3 points (2 cells) at stride 1: two windows, means 5 and
    # 6; the first crosses cells (0, 1), (1, 0), (1, 1), the second
    # (0, 2), (1, 1), (1, 2)
    q = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    lv = local.window_means(q.double(), 3, 1)
    assert lv.tolist() == [[[5.0, 6.0]]]
    assert wl.k8_crossed_cells(q[0].double(), lv[0], 3, 1) == 6
    # the second field shifted by 100 crosses the same cells
    q2 = torch.cat([q, q + 100])
    nbytes, ops = wl.k8_work(q2, torch.zeros(3), torch.zeros(4), True, 3, 1)
    assert nbytes == 4 * (24 + 2 * 4 + 3 + 4)
    # a field: 6 cells covered, 2 windows x 2 x 2 blocks pretested, 6 pairs
    one = rw.CLASSIFY_INSTR * 6 + wl.PRETEST_INSTR * 2 * 4 \
        + rw.SEGMENT_INSTR[True] * 6
    assert ops == 2 * one
    # a NaN corner drops cell (0, 0), which no window crossed
    q2[0, 0, 0] = float("nan")
    assert wl.k8_work(q2, torch.zeros(3), torch.zeros(4), True, 3, 1)[1] \
        == 2 * one


def test_window_means_and_lengths_by_hand():
    # a plane ramp q = x on a unit grid: every window's mean is its middle
    # column's value, and its contour the straight line down that column,
    # window - 1 cells long
    q = torch.arange(7, dtype=F64).repeat(5, 1)[None]
    y, x = torch.arange(5, dtype=F64), torch.arange(7, dtype=F64)
    lv = local.window_means(q, 5, 2)
    assert lv.tolist() == [[[2.0, 4.0]]]
    L = local.window_lengths(q, lv, y, x, 5, 2, latlon=False)
    assert L.tolist() == [[[4.0, 4.0]]]
    # fewer finite points than min_count: NaN mean and length
    q[0, :, 0] = float("nan")
    lv = local.window_means(q, 5, 2, min_count=21)
    assert math.isnan(lv[0, 0, 0]) and lv[0, 0, 1] == 4.0
    L = local.window_lengths(q, lv, y, x, 5, 2, latlon=False)
    assert math.isnan(L[0, 0, 0]) and L[0, 0, 1] == 4.0


def _inputs(seed=2 ** 31 + 11, **over):
    cfg = {**json.loads((REPO / "xcbench" / "configs"
                         / f"{CELL['config']}.json").read_text()),
           **TINY_CONFIGS["era5_pv16"], **over}
    lat, lon = harness.coords(cfg)
    maker = harness.load_module(REPO / "xcbench" / "fields" / "synth_pv.py")
    q = maker.make(cfg["field"], lat, lon, cfg["batch"], seed, 0, "cpu")
    return lat, lon, q


def test_reference_against_program():
    from xcontour_tpu_torch import grid as pgrid
    lat, lon, q = _inputs()
    kw = TINY_LOCAL["kwargs"]
    grid = pgrid.from_latlon(lat, lon, dtype=F64, device="cpu")
    got = harness.resolve(CELL["entry"])(q.double(), grid, **kw)
    want = local.run(q.double(), core.latlon_grid(lat, lon, F64, "cpu"),
                     **TINY_LOCAL["reference_kwargs"])
    assert torch.isnan(want["means"]).sum() == 0
    gaps = compare.gaps(got, want, CELL["compare"])
    assert max(gaps.values()) < 1e-10, gaps
    # a window's length against core.contour_lengths on the window alone
    b, iy, ix, w, s = 1, 3, 5, kw["window"], kw["stride"]
    rows, cols = slice(iy * s, iy * s + w), slice(ix * s, ix * s + w)
    one = core.contour_lengths(
        q.double()[b:b + 1, rows, cols],
        want["means"][b, iy, ix].reshape(1, 1),
        torch.as_tensor(lat[rows]), torch.as_tensor(lon[cols]), latlon=True)
    assert one.item() == pytest.approx(want["llen"][b, iy, ix].item(),
                                       rel=1e-13)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12345])
def test_float32_program_within_and_control_outside_the_limits(seed):
    """On ERA5's 0.25 degree longitudes (121 latitudes, three levels,
    windows of 31 points every 30): the program in float32 well inside the
    cell's limits, the reference in bfloat16 outside every one."""
    from xcontour_tpu_torch import grid as pgrid
    grid_over = {"lat": {"kind": "linspace", "start": -90.0, "stop": 90.0,
                         "num": 121},
                 "lon": {"kind": "periodic", "num": 1440}}
    lat, lon, q = _inputs(seed, grid=grid_over, batch=3,
                          field={"maker": "synth_pv", "nan_levels": 1,
                                 "levels": [265, 300, 850]})
    kw = dict(window=31, stride=30, min_count=1)
    got = harness.resolve(CELL["entry"])(
        q, pgrid.from_latlon(lat, lon, device="cpu"), **kw)
    want = local.run(q.double(), core.latlon_grid(lat, lon, F64, "cpu"),
                     **kw)
    limits = CELL["limits"]
    gaps = compare.gaps(got, want, CELL["compare"])
    assert all(gaps[k] < v / 10 for k, v in limits.items()), gaps
    ctrl = local.run(q.bfloat16(), core.latlon_grid(lat, lon, torch.bfloat16,
                                                    "cpu"), **kw)
    gaps = compare.gaps(ctrl, want, CELL["compare"])
    assert all(gaps[k] > v for k, v in limits.items()), gaps


def test_tiny_copy_cuts_the_cell_and_its_configuration(tiny):
    xc = tiny / "xcbench"
    cfg = json.loads((xc / "configs" / f"{CELL['config']}.json").read_text())
    assert cfg["grid"] == TINY_CONFIGS["era5_pv16"]["grid"]
    cell = json.loads((xc / "cells" / "era5.local.json").read_text())
    assert cell["kwargs"] == TINY_LOCAL["kwargs"]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tiny, trace):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = run_cpu(tiny, "era5.local", trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == set(CELL["limits"])
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if "era5.local" in m["workloads"]}
        assert "k8_roofline_pct" in want
        # a CPU trace has no device operations: only the host's spans
        assert set(out["metrics"]) <= want
        assert "host_ms_per_step" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "snapshots_per_s",
                                       "step_ms_p95"}


# llen alone scaled by 0.9, the means left as they are: every window's gap
# is a tenth of its length, so the widest is a tenth of the largest
# window's, inside the limit of 0.2.  What the limit lets through (PERF.md
# section 2): a K8 error smaller than a fifth of the largest window's
# length in every window.
SCALED = """
import xcontour_tpu_torch.pipeline as _m
_f = _m.local_length_pipeline
def _scaled(*a, **k):
    out = _f(*a, **k)
    out["llen"] = out["llen"] * 0.9
    return out
_m.local_length_pipeline = _scaled
"""


def test_llen_scaled_by_nine_tenths_passes_the_limit(tiny):
    out = run_cpu(tiny, "era5.local", patch=SCALED)
    assert out["correct"] is True
    assert 0.09 < out["checks"]["llen"]["value"] <= 0.1 + 1e-6
    assert out["checks"]["means"]["value"] < 1e-5
