"""Runs of the benchmark on the CPU at tiny sizes, in fresh processes:
each cell end to end (the rehearsal of a chip run), a cell, a
configuration and a layer metric added as new files only, the control
and the faults coming out as not correct, and the refusal without a card.
On the card (``-m cuda``): one short run of each cell as committed."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, run_cpu, tiny_copy

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _expected(cell, trace):
    if not trace:
        return {m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", [cell])}
    return {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(tiny, cell, trace):
    out = run_cpu(tiny, cell, trace=trace)
    assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    # the tiny sizes' own float32 noise is not the cells' limits
    assert set(out["checks"]) == set(json.loads(
        (REPO / "xcbench" / "cells" / f"{cell}.json").read_text())["limits"])
    assert out["device"]["platform"] == "cpu"
    assert out["library_built"] is False  # no kernel library on the CPU
    got = set(out["metrics"])
    if trace:
        assert "breakdown" in out and {"busy_s", "window_s"} <= set(
            out["device"])
        # a CPU trace has no device operations: only the host's spans
        assert got <= _expected(cell, 1)
    else:
        assert got == _expected(cell, 0)
        assert all(v["value"] > 0 for v in out["metrics"].values())


def test_new_files_are_found_without_other_edits(tmp_path):
    root = tiny_copy(tmp_path)
    xc = root / "xcbench"
    before = {p: p.read_bytes() for p in xc.rglob("*") if p.is_file()}
    cfg = json.loads((xc / "configs" / "era5_pv16.json").read_text())
    cfg.update(name="era5_coarse", batch=3,
               field={**cfg["field"], "levels": [265, 430, 850]})
    (xc / "configs" / "era5_coarse.json").write_text(json.dumps(cfg))
    cell = json.loads((xc / "cells" / "era5.clength.json").read_text())
    cell["config"] = "era5_coarse"
    (xc / "cells" / "coarse.clength.json").write_text(json.dumps(cell))
    (xc / "layer_metrics" / "steps_traced.py").write_text(
        "def read(tr):\n    return float(tr.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="era5_coarse",
                                 file="xcbench/configs/era5_coarse.json"))
    bench["workloads"].append(dict(bench["workloads"][-1],
                                   name="coarse.clength",
                                   config="era5_coarse"))
    for m in bench["end_to_end"]:
        if "era5.clength" in m.get("workloads", []):
            m["workloads"].append("coarse.clength")
    bench["per_layer"].append(dict(bench["per_layer"][2],
                                   name="steps_traced", unit="steps",
                                   workloads=["coarse.clength"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(root, "coarse.clength", trace=1)
    assert out["metrics"]["steps_traced"]["value"] == 2.0
    out = run_cpu(root, "coarse.clength")
    assert set(out["metrics"]) == {"setup_s", "snapshots_per_s",
                                   "step_ms_p95"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


CONTROL = """
import torch
from xcbench import harness as _h
_run = _h._run
def _control(ctx, *args):
    d = ctx.driver
    check = d.check
    d.check = lambda st, kept, dtype=None: check(st, kept, torch.bfloat16)
    return _run(ctx, *args)
_h._run = _control
"""
# each output of the entry altered where it is produced: its first element
# moved by 5% of the key's largest magnitude
ALTER = """
import torch
import xcontour_tpu_torch.{module} as _m
_f = _m.{entry}
def _altered(*a, **k):
    out = _f(*a, **k)
    flat = out.get("origin", out)
    for key, v in flat.items():
        if torch.is_tensor(v) and v.is_floating_point() and v.dim() > 1:
            v = v.clone()
            fin = v[torch.isfinite(v)]
            v.view(-1)[0] += 0.05 * fin.abs().max() if fin.numel() else 1.0
            flat[key] = v
    return out
_m.{entry} = _altered
"""
# half of each step's snapshots left out: the entry runs on the first half
# and its outputs for it stand in for the whole batch
HALF = """
import torch
import xcontour_tpu_torch.{module} as _m
_f = _m.{entry}
def _half(t, *a, **k):
    n = max(1, t.shape[0] // 2)
    out = _f(t[:n], *a, **k)
    def fill(v):
        if isinstance(v, dict):
            return {{key: fill(x) for key, x in v.items()}}
        if torch.is_tensor(v) and v.dim() and v.shape[0] == n:
            return v[torch.arange(t.shape[0]) % n]
        return v
    return fill(out)
_m.{entry} = _half
"""
FAULTY = {"era5.keff_lwa": ("pipeline", "keff_lwa_pipeline"),
          "era5.clength": ("pipeline", "clength_pipeline"),
          "t170.fractal": ("pipeline", "fractal_pipeline"),
          "era5.archive_keff": ("pipeline", "keff_pipeline")}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    out = run_cpu(tiny, cell, patch=CONTROL)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(tiny, cell):
    module, entry = FAULTY[cell]
    out = run_cpu(tiny, cell, patch=ALTER.format(module=module, entry=entry))
    assert out["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_is_not_correct(tiny, cell):
    module, entry = FAULTY[cell]
    out = run_cpu(tiny, cell, patch=HALF.format(module=module, entry=entry))
    assert out["correct"] is False


def test_run_refuses_without_a_card():
    code = "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)"
    if subprocess.run([sys.executable, "-c", code]).returncode == 0:
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "xcbench/run.py", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_forbidden_module_is_loaded_or_imported():
    from xcbench import harness
    sys.modules["xcontour_tpu.fake"] = sys.modules["json"]
    try:
        assert harness.forbidden_modules() == ["xcontour_tpu.fake"]
    finally:
        del sys.modules["xcontour_tpu.fake"]
    assert "xcontour_tpu_torch" not in harness.FORBIDDEN
    import ast
    for path in (REPO / "xcbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"jax", "jaxlib", "flax", "xcontour_tpu"}, path
        if "reference" in path.parts:
            assert "xcontour_tpu_torch" not in tops, path


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "xcbench/run.py", "--workload",
                           cell, "--seed", "2718281828", "--seconds", "2",
                           "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, timeout=1200,
                          env=dict(os.environ, BENCH_RUN="test"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
