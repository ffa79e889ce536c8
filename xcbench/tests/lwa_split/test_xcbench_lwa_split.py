"""The cell ``era5.lwa_split``: the reference's halves against
``core.wave_activity`` and against a pair-by-pair loop, the step driver's
work a launch for K4, K4's reader on a canned trace, what the reference
imports, the program in float32 within the cell's limits and the bfloat16
control outside them, and the cell's runs on the CPU at a tiny size
(correct, with the traced metrics it names; the control and the faults of
``test_xcbench_runs.py`` run on it there)."""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))
from xcbench import compare, harness, roofline_work as rw  # noqa: E402
from xcbench.reference import core, lwa_split  # noqa: E402

from conftest import run_cpu  # noqa: E402
from lwa_split.conftest import TINY_SPLIT  # noqa: E402

XC = REPO / "xcbench"
CELL = json.loads((XC / "cells" / "era5.lwa_split.json").read_text())
CONFIG = json.loads((XC / "configs" / "era5_pv16_lwa_split.json")
                    .read_text())
HALVES = ["lwa_upper", "lwa_lower", "lwa2_upper", "lwa2_lower"]


def _field(B, Ny, Nx, seed, nan=True):
    g = torch.Generator().manual_seed(seed)
    y = torch.linspace(-1, 1, Ny, dtype=torch.float64)
    q = 2 * y[None, :, None] + torch.randn(B, Ny, Nx, generator=g,
                                           dtype=torch.float64)
    if nan:
        q[0, 3:6, 10:20] = float("nan")
    return q


def _grid(Ny, Nx):
    lat = np.linspace(-90.0, 90.0, Ny)
    lon = np.arange(Nx) * (360.0 / Nx)
    return lat, lon, core.latlon_grid(lat, lon, torch.float64, "cpu")


def _pairwise(q, Q, W, increase, variant2):
    """The halves one (j, y) pair at a time, from the 3-valued mask."""
    B, Ny, Nx = q.shape
    up, lo = torch.zeros_like(q), torch.zeros_like(q)
    inc = increase != variant2
    for j in range(Ny):
        for y in range(Ny):
            qe = q[:, j] - Q[:, y, None] if variant2 else \
                q[:, y] - Q[:, j, None]
            if y >= j:
                m = ((qe < 0) if inc else (qe > 0)).double()
            else:
                m = -((qe > 0) if inc else (qe < 0)).double()
            t = torch.nan_to_num(-qe * m * W[y], nan=0.0)
            keep_up = (m > 0) if increase else (m < 0)
            up[:, j] += torch.where(keep_up, t, 0)
            lo[:, j] += torch.where(keep_up, 0, t)
    return up, lo


@pytest.mark.parametrize("variant2", [False, True])
@pytest.mark.parametrize("increase", [True, False])
def test_halves_against_a_pair_loop(increase, variant2):
    q = _field(2, 9, 7, 3)
    _, _, g = _grid(9, 7)
    Q = torch.linspace(-2, 2, 9, dtype=torch.float64)[None].repeat(2, 1)
    Q[1, 4] = float("nan")
    W = g["dA"] / g["dA"].max() * g["dA"]
    got = lwa_split.halves(q, Q, W, increase=increase, variant2=variant2)
    want = _pairwise(q, Q, W, increase, variant2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 7])
def test_halves_add_up_to_core_wave_activity(seed):
    q = _field(3, 37, 72, seed)
    _, _, g = _grid(37, 72)
    out = lwa_split.run(q, g, N=31)
    whole = core.wave_activity(q, out["Q"], g["dA"])
    torch.testing.assert_close(out["lwa_upper"] + out["lwa_lower"], whole,
                               rtol=1e-12, atol=1e-12 * whole.abs().max())
    assert (out["lwa_upper"] >= 0).all() and (out["lwa_lower"] >= 0).all()
    assert (out["lwa2_upper"] <= 0).all() and (out["lwa2_lower"] <= 0).all()


def test_work_a_launch_by_hand():
    driver = harness.load_module(XC / "drivers" / "step.py")
    st = dict(ring=[torch.zeros(3, 4, 5)] * 2, lat=np.linspace(-90, 90, 4),
              lon=np.arange(5) * 72.0, work={},
              ctx=SimpleNamespace(cell={"kernels": {"K4": {"strides":
                                                           [1, 1]}}}))
    w = driver.work(st, 5)
    # two launches a step (LWA, LWA2), each q, W and Q in and a field out,
    # 3 x 4 x 4 x 5 pairs of 3 instructions
    assert w["K4"] == [(4 * (2 * 60 + 20 + 12), 3 * 240)] * 2
    assert w["K4"][0] == rw.lwa_work(3, 4, 5)


def test_k4_reader_on_a_canned_trace():
    X = lambda name, ts, dur: dict(ph="X", name=name, cat="kernel", ts=ts,  # noqa: E731
                                   dur=dur, tid=1, pid=0)
    events = [dict(ph="X", name="xcbench.window", cat="user_annotation",
                   ts=0, dur=1000, tid=1, pid=0),
              X("void (anonymous namespace)::lwa_dense_kernel<true, false>"
                "(float const*, float*, float*, int, int)", 100, 300),
              X("void (anonymous namespace)::lwa_dense_kernel<true, true>"
                "(float const*, float*, float*, int, int)", 400, 100),
              X("lwa_lin_kernel", 600, 100)]
    kernels = {"K4": harness.load_json(XC / "kernels" / "K4.json")}
    # two launches whose bounds are 50 us each: 25% of K4's 400 us
    work = [(0, 50e-6 * rw.FP32_INSTR_PER_S)] * 2
    tr = harness.Trace(events, 1, 16, {"K4": 2}, kernels, {"K4": work})
    read = harness.load_module(XC / "layer_metrics" / "k4_roofline_pct.py")
    assert read.read(tr) == pytest.approx(25.0)
    tr.launches["K4"] = 4
    assert read.read(tr) is None


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((XC / "reference" / "lwa_split.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "xcontour_tpu", "xcontour_tpu_torch"}


def test_the_cell_and_its_configuration():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == "era5.lwa_split")
    assert wl["chips"] == 1 and wl["config"] == "era5_pv16_lwa_split"
    era5 = json.loads((XC / "configs" / "era5_pv16.json").read_text())
    for key in ("grid", "batch", "dtype", "field", "reduced"):
        assert CONFIG[key] == era5[key], key
    assert CELL["kwargs"] == {"N": 241, "part": "split",
                              "lwa_method": "auto"}
    assert set(CELL["limits"]) == {"contour", "intArea", "latEq", "Q",
                                   *HALVES}
    for m in bench["per_layer"] + bench["end_to_end"]:
        if m["name"] in ("snapshots_per_s", "step_ms_p95", "k4_roofline_pct",
                         "k2_roofline_pct", "graph_replay_pct",
                         "launches_per_step", "glue_ms_per_step",
                         "device_idle_pct.step", "host_ms_per_step"):
            assert "era5.lwa_split" in m["workloads"], m["name"]
        elif m["name"] in ("k3_roofline_pct", "k5_roofline_pct"):
            assert "era5.lwa_split" not in m["workloads"], m["name"]


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12345])
def test_float32_program_within_and_control_outside_the_limits(seed):
    """At ERA5's latitudes cut to a quarter (181 x 360, 4 levels, N = 61):
    the program in float32 within the cell's limits, the reference in
    bfloat16 outside at least one."""
    from xcontour_tpu_torch import core as pcore, grid as pgrid
    lat, lon = np.linspace(-90.0, 90.0, 181), np.arange(360) * 1.0
    maker = harness.load_module(XC / "fields" / "synth_pv.py")
    spec = dict(CONFIG["field"], levels=[265, 330, 475, 850])
    q = maker.make(spec, lat, lon, 4, seed, 0, "cpu")
    grid = pgrid.from_latlon(lat, lon, device="cpu")
    kw = dict(CELL["kwargs"], N=61)
    kw["table"] = pcore.cal_area_eqCoord_table_hist(
        grid.fluid_mask(), grid.ydef, grid.dA, increase=True, lt=True)
    got = harness.resolve(CELL["entry"])(q, grid, **kw)
    want = lwa_split.run(q.double(), core.latlon_grid(lat, lon,
                                                      torch.float64, "cpu"),
                         N=61)
    limits = CELL["limits"]
    gaps = compare.gaps(got, want, CELL["compare"])
    assert all(gaps[k] < v for k, v in limits.items()), gaps
    ctrl = lwa_split.run(q.bfloat16(), core.latlon_grid(lat, lon,
                                                        torch.bfloat16,
                                                        "cpu"), N=61)
    gaps = compare.gaps(ctrl, want, CELL["compare"])
    assert any(gaps[k] > v for k, v in limits.items()), gaps


def test_tiny_copy_cuts_the_cell_and_its_configuration(tiny):
    xc = tiny / "xcbench"
    cfg = json.loads((xc / "configs" / "era5_pv16_lwa_split.json")
                     .read_text())
    assert cfg["grid"]["lat"]["num"] == 37 and cfg["batch"] == 5
    cell = json.loads((xc / "cells" / "era5.lwa_split.json").read_text())
    assert cell["kwargs"] == TINY_SPLIT["kwargs"]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tiny, trace):
    """At the seed the runs of ``test_xcbench_runs.py`` take: on the tiny
    37 x 72 grid some seeds (2**31 + 3, 99) put a float32 cell on the
    other side of a level than its float64 twin, one cell being ~0.4% of
    the area, and ``era5.keff_lwa`` reads the same intArea gap there."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = run_cpu(tiny, "era5.lwa_split", trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == set(CELL["limits"])
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if "era5.lwa_split" in m["workloads"]}
        assert {"k2_roofline_pct", "k4_roofline_pct"} <= want
        # a CPU trace has no device operations: only the host's spans
        assert set(out["metrics"]) <= want
        assert "host_ms_per_step" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "snapshots_per_s",
                                       "step_ms_p95"}
