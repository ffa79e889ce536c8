"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
XC = REPO / "xcbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "xcbench/run.py"]
    assert BENCH["paths"] == ["xcbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs_cells_and_metrics_are_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"xcbench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        cell = json.loads((XC / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert (XC / "drivers" / f"{cell['driver']}.py").exists()
        assert (XC / "reference" / f"{cell['reference']}.py").exists()
        assert set(cell["limits"]) == set(cell["compare"]["keys"])
        for K in cell.get("kernels", {}):
            assert (XC / "kernels" / f"{K}.json").exists()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert (XC / "end_to_end" / f"{m['name']}.py").exists()
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert (XC / "layer_metrics" / f"{m['name']}.py").exists()
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_layers_of_one_name_and_in_perf_md():
    perf = (REPO / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_kernel_specs_resolve():
    import sys
    sys.path.insert(0, str(REPO))
    from xcbench import harness
    for K, spec in harness.kernel_specs().items():
        assert spec["names"] and callable(harness.resolve(spec["work"]))
        assert hasattr(spec["counter"], "launches"), K
