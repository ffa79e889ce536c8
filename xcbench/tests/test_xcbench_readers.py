"""Each per-layer reader on a small canned profiler trace, and the
end-to-end readers on a canned window."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from xcbench import harness  # noqa: E402


def X(name, cat, ts, dur, tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid, pid=0)


# a window of 1000 us, 2 steps: on the card K2's three kernels (100 us in
# all, one launch), K3's two (300 us, one launch), K1's (40 us), two glue
# kernels (60 us) and a copy (50 us), two of them overlapping; on the host
# the CLI's and the runner's ranges
EVENTS = [
    X("xcbench.window", "user_annotation", 1000, 1000),
    X("void cdf_partial_kernel<8>(float const*, int)", "kernel", 1100, 60),
    X("cdf_fold_kernel", "kernel", 1160, 20),
    X("cdf_scan_kernel(float*, int)", "kernel", 1180, 20),
    X("lwa_lin_prep_kernel", "kernel", 1300, 100),
    X("void xc::lwa_lin_kernel<true>(float const*)", "kernel", 1400, 200),
    X("squared_gradient_kernel", "kernel", 1650, 40),
    X("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel",
      1700, 30),
    X("void at::native::reduce_kernel<512, 1>(int)", "kernel", 1720, 30),
    X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1800, 50),
    X("before the window", "kernel", 500, 100),
    X("cli.open", "user_annotation", 1010, 40),
    X("cli.stream", "user_annotation", 1050, 800),
    X("runner.step", "user_annotation", 1100, 100),
    X("runner.fetch", "user_annotation", 1150, 100),
    X("runner.step", "user_annotation", 1500, 100, tid=2),
    X("cli.label", "user_annotation", 1850, 50),
    X("cli.write", "user_annotation", 1900, 90),
]
KERNELS = {"K1": {"names": ["squared_gradient_kernel"]},
           "K2": {"names": ["cdf_partial_kernel", "cdf_fold_kernel",
                            "cdf_scan_kernel"]},
           "K3": {"names": ["lwa_lin_prep_kernel", "lwa_lin_kernel"]}}
# one launch of each, with work whose bound is 50 us (K2) and 150 us (K3)
WORK = {"K2": [(50e-6 * 3.35e12, 0)], "K3": [(0, 150e-6 * 33.5e12)]}


@pytest.fixture
def tr():
    return harness.Trace(EVENTS, steps=2, units=30,
                         launches={"K1": 1, "K2": 1, "K3": 1},
                         kernels=KERNELS, work=WORK)


def read(name, tr):
    return harness.load_module(REPO / "xcbench" / "layer_metrics"
                               / f"{name}.py").read(tr)


def test_window_and_busy(tr):
    assert tr.window_s == pytest.approx(1e-3)
    # 1100-1200, 1300-1600, 1650-1690, 1700-1750, 1800-1850
    assert tr.busy_s() == pytest.approx(540e-6)


def test_launches_and_glue(tr):
    assert read("launches_per_step", tr) == 4.0
    assert read("glue_ms_per_step", tr) == pytest.approx(0.030)


def test_rooflines(tr):
    assert read("k2_roofline_pct", tr) == pytest.approx(50.0)
    assert read("k3_roofline_pct", tr) == pytest.approx(50.0)
    assert read("k7_roofline_pct", tr) is None        # K7 did not run
    tr.launches["K2"] = 2                              # counts disagree
    assert read("k2_roofline_pct", tr) is None


def test_idle(tr):
    for name in ("device_idle_pct.step", "device_idle_pct.archive"):
        assert read(name, tr) == pytest.approx(46.0)


def test_cli_and_runner(tr):
    assert read("cli_io_ms_per_snapshot", tr) == pytest.approx(
        (40 + 50 + 90) / 1e3 / 30)
    # the stream 1050-1850 on thread 1: inside step or fetch 1100-1250
    assert read("runner_wait_pct", tr) == pytest.approx(100 * 650 / 800)


def test_breakdown(tr):
    b = tr.breakdown(top=3)
    assert b["device_ops"][0] == ["lwa_lin_kernel", pytest.approx(200e-6)]
    assert len(b["device_ops"]) == 3
    names = dict(b["idle_gaps"])
    # six gaps; the last, 1850-2000, has cli.write open over its middle
    assert sum(names.values()) == pytest.approx(460e-6)
    assert names["cli.write"] == pytest.approx(1e-4 + 50e-6)


def test_breakdown_names_a_kernel_by_its_operator():
    ev = [X("xcbench.window", "user_annotation", 0, 100),
          dict(X("aten::where", "cpu_op", 1, 5), args={"External id": 7}),
          dict(X("void at::native::elementwise_kernel<128>(int)", "kernel",
                 10, 30), args={"External id": 7}),
          X("(anonymous namespace)::lengths_kernel(float const*)", "kernel",
            50, 10)]
    b = harness.Trace(ev, 1, 1, {}, KERNELS, {}).breakdown()
    assert b["device_ops"] == [["aten::where:elementwise_kernel",
                                pytest.approx(30e-6)],
                               ["lengths_kernel", pytest.approx(10e-6)]]


def test_readers_give_nothing_without_device_events():
    bare = harness.Trace([X("xcbench.window", "user_annotation", 0, 10)],
                         1, 1, {}, KERNELS, {})
    for name in ("launches_per_step", "glue_ms_per_step", "k2_roofline_pct",
                 "device_idle_pct.step", "cli_io_ms_per_snapshot",
                 "runner_wait_pct"):
        assert read(name, bare) is None


def test_end_to_end_readers():
    win = dict(units=150, window_s=2.0, times=[i / 1000 for i in
                                                range(1, 21)], setup_s=7.5)
    e2e = REPO / "xcbench" / "end_to_end"
    load = lambda n: harness.load_module(e2e / f"{n}.py").read(win)  # noqa
    assert load("snapshots_per_s") == 75.0
    assert load("archive_snapshots_per_s") == 75.0
    assert load("setup_s") == 7.5
    assert load("step_ms_p95") == pytest.approx(19.0)   # rank 19 of 20
