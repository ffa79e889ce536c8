"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at tiny
sizes in a temporary directory, and a run of one of its cells on the CPU
in a fresh process (``run.py`` itself refuses to run without a card)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# the cells' shapes cut to what a CPU test holds: every other key as the
# benchmark has it
TINY_CONFIGS = {
    "era5_pv16": {"grid": {"lat": {"kind": "linspace", "start": -90.0,
                                   "stop": 90.0, "num": 37},
                           "lon": {"kind": "periodic", "num": 72}},
                  "batch": 5,
                  "field": {"maker": "synth_pv", "nan_levels": 3,
                            "levels": [265, 300, 350, 430, 600]}},
    "baro_t170": {"grid": {"lat": {"kind": "gaussian", "num": 32},
                           "lon": {"kind": "periodic", "num": 64}},
                  "batch": 3,
                  "field": {"maker": "baro_turbulence", "k_max": 20,
                            "rms": 6e-05}},
}
TINY_CELLS = {
    "era5.keff_lwa": {"kwargs": {"N": 21, "lwa_method": "auto"},
                      "kernels": {"K1": {}, "K2": {"N": 21, "C": 2},
                                  "K3": {}},
                      "reference_kwargs": {"N": 21, "nkeff_mask": 2e7}},
    "era5.clength": {"kwargs": {"N": 31},
                     "kernels": {"K2": {"N": 31, "C": 5}, "K7": {"N": 31}},
                     "reference_kwargs": {"N": 31, "nkeff_mask": 1e5}},
    "t170.fractal": {"kwargs": {"N": 15, "strides": [1, 2, 4, 8],
                                "box_counting": True},
                     "kernels": {"K2": {"N": 15, "C": 1},
                                 "K7": {"N": 15, "strides": [1, 2, 4, 8]}},
                     "reference_kwargs": {"N": 15, "strides": [1, 2, 4, 8]}},
    "era5.archive_keff": {"times": 2,
                          "argv": ["keff", "{archive}", "--var", "pv", "-N",
                                   "21", "--batch", "5", "--format", "nc3",
                                   "--out", "{out}"],
                          "reference_kwargs": {"N": 21, "nkeff_mask": 2e7}},
}
COMMON = {"ring": 2, "samples": 2, "trace_warmup": 1, "trace_steps": 2}


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and xcbench/ copied under ``dest``, every
    configuration and cell cut to the tiny sizes above."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "xcbench", dest / "xcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY_CONFIGS.items():
        p = dest / "xcbench" / "configs" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **over}))
    for name, over in TINY_CELLS.items():
        p = dest / "xcbench" / "cells" / f"{name}.json"
        cell = json.loads(p.read_text())
        extra = dict(COMMON)
        if cell["driver"] == "archive":
            extra.pop("ring")
        p.write_text(json.dumps({**cell, **extra, **over}))
    return dest


def run_cpu(root: Path, workload: str, seed: int = 12345, trace: int = 0,
            seconds: float = 0.5, patch: str = "") -> dict:
    """One run of ``workload`` of the benchmark under ``root`` on the CPU,
    in a new process (``patch``: code run there first); its result line."""
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n"
        "t = time.perf_counter()\n"
        "from xcbench import harness\n"
        f"{patch}\n"
        f"out = harness.run({workload!r}, {seed}, {seconds}, {bool(trace)},"
        " 'cpu', t)\n"
        "assert not harness.forbidden_modules(), harness.forbidden_modules()\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
