"""The cell ``lape.lwa``: the section driver's work a launch against
counts made by hand, K5's reader on a canned trace, what the field maker
and the reference import, the program in float32 within the cell's limits
and the bfloat16 control outside them at the cell's own section depth,
and the cell's runs on the CPU at a tiny size (correct, with the traced
metrics it names; the control and the faults of ``test_xcbench_runs.py``
run on it there)."""

import ast
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))
from xcbench import compare, harness, roofline_work as rw  # noqa: E402
from xcbench.reference import lape  # noqa: E402

from conftest import run_cpu  # noqa: E402
from lape.conftest import TINY_LAPE, TINY_SECTION  # noqa: E402

XC = REPO / "xcbench"
CELL = json.loads((XC / "cells" / "lape.lwa.json").read_text())
CONFIG = json.loads((XC / "configs" / "mitgcm_xz_lape.json").read_text())


def test_work_a_launch_by_hand():
    driver = harness.load_module(XC / "drivers" / "section.py")
    st = dict(ring=[torch.zeros(3, 4, 5)] * 2,
              ctx=SimpleNamespace(cell={"kernels": {"K2": {"N": 7, "C": 1},
                                                    "K3": {}, "K5": {}}}))
    w = driver.work(st, 5)
    # K2: values and one weight channel (3 x 20 each), 3 x 8 edges, 3 x 7
    # out; one add a cell.  K3 and K5: q, the field, W and Q; 3 x 4 x 4 x 5
    # pairs of 3 instructions
    assert w["K2"] == [(4 * (3 * 20 * 2 + 3 * 8 + 3 * 7), 60)]
    assert w["K3"] == w["K5"] == [(4 * (2 * 60 + 20 + 12), 3 * 240)]
    assert w["K5"] == [rw.lwa_work(3, 4, 5)]


def test_k5_reader_on_a_canned_trace():
    X = lambda name, ts, dur: dict(ph="X", name=name, cat="kernel", ts=ts,  # noqa: E731
                                   dur=dur, tid=1, pid=0)
    events = [dict(ph="X", name="xcbench.window", cat="user_annotation",
                   ts=0, dur=1000, tid=1, pid=0),
              X("void xc::(anonymous namespace)::lwa_lin2_prep_kernel<true>"
                "(float const*)", 100, 100),
              X("void xc::lwa_lin2_kernel<false>(float const*)", 200, 300),
              X("lwa_lin_kernel", 600, 100)]
    kernels = {"K5": harness.load_json(XC / "kernels" / "K5.json")}
    # one launch whose bound is 100 us: 25% of K5's 400 us
    tr = harness.Trace(events, 1, 64, {"K5": 1}, kernels,
                       {"K5": [(0, 100e-6 * rw.FP32_INSTR_PER_S)]})
    read = harness.load_module(XC / "layer_metrics" / "k5_roofline_pct.py")
    assert read.read(tr) == pytest.approx(25.0)
    tr.launches["K5"] = 2
    assert read.read(tr) is None


@pytest.mark.parametrize("path", ["fields/internalwave.py",
                                  "reference/lape.py"])
def test_maker_and_reference_import_nothing_of_the_program(path):
    tree = ast.parse((XC / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "xcontour_tpu", "xcontour_tpu_torch"}


def _section(nx, B, seed):
    maker = harness.load_module(XC / "fields" / "internalwave.py")
    g = json.loads(json.dumps(CONFIG["grid"]))
    g["x"].update(first=8960.0 / nx / 2, step=8960.0 / nx, num=nx)
    z, x, h = maker.section(g)
    return z, x, h, maker.make(CONFIG["field"], z, x, h, B, seed, 0, "cpu")


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12345])
def test_float32_program_within_and_control_outside_the_limits(seed):
    """At the cell's 100 levels of 2 m and N (448 columns of 20 m, four
    snapshots): the program in float32 within the cell's limits, the
    reference in bfloat16 outside every one.  The first seed reads
    intArea 2.4e-05 and lwa 2.1e-04 (the second 7.6e-08 and 6.8e-06): one
    cell of 40 m^2, a 2.4e-05 share of the section, lies between a float32
    level and its float64 twin and falls on the other side of it; at the
    cell's 2 m columns such a cell is a tenth of that share, and the card
    read at most 7.2e-06 and 4.4e-05 (PERF.md section 2)."""
    from xcontour_tpu_torch import core, grid as pgrid
    z, x, h, q = _section(448, 4, seed)
    grid = pgrid.from_xz(z, x, h, mask=(h > 0).astype("float32"),
                         device="cpu")
    kw = dict(CELL["kwargs"])
    kw["table"] = core.cal_area_eqCoord_table_hist(
        grid.fluid_mask(), grid.ydef, grid.dA, increase=False, lt=False)
    got = harness.resolve(CELL["entry"])(q, grid, **kw)
    want = lape.run(q.double(), lape.xz_grid(z, x, h, torch.float64, "cpu"),
                    **CELL["reference_kwargs"])
    limits = CELL["limits"]
    gaps = compare.gaps(got, want, CELL["compare"])
    assert all(gaps[k] < v for k, v in limits.items()), gaps
    ctrl = lape.run(q.bfloat16(), lape.xz_grid(z, x, h, torch.bfloat16,
                                               "cpu"),
                    **CELL["reference_kwargs"])
    gaps = compare.gaps(ctrl, want, CELL["compare"])
    assert all(gaps[k] > v for k, v in limits.items()), gaps


def test_tiny_copy_cuts_the_cell_and_its_configuration(tiny):
    xc = tiny / "xcbench"
    cfg = json.loads((xc / "configs" / "mitgcm_xz_lape.json").read_text())
    assert cfg["grid"] == TINY_SECTION["grid"] and cfg["batch"] == 4
    cell = json.loads((xc / "cells" / "lape.lwa.json").read_text())
    assert cell["kwargs"] == TINY_LAPE["kwargs"]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(tiny, trace):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    out = run_cpu(tiny, "lape.lwa", seed=2 ** 31 + 3, trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == set(CELL["limits"])
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if "lape.lwa" in m["workloads"]}
        assert {"k2_roofline_pct", "k3_roofline_pct",
                "k5_roofline_pct"} <= want
        # a CPU trace has no device operations: only the host's spans
        assert set(out["metrics"]) <= want
        assert "host_ms_per_step" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "snapshots_per_s",
                                       "step_ms_p95"}
