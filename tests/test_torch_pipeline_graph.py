"""The pipeline entries' CUDA graphs (``pipeline.Graphs``).

On the CPU: every call the rule leaves eager (CPU tensors, a gradient, a
mesh layout, no table given) runs the eager body and counts no capture or
replay; the keys and the bounded, weakly held cache; the constants made
without a copy from the host give the bits of the forms they replace;
stage timing through fake graphs and timing events (the untraced key and
graph unchanged, the timed key held apart, one record a call read before
the next call's span, a lost record, records that outlive their graph).

On the card (``-m cuda``; skipped without one): each entry's replay bit
for bit with its eager body; outputs that outlive the next call; one graph
for many inputs; the kernels' launch counts; a capture beside a thread
that copies on its own stream; a replay timed by stage bit for bit with
the plain replay, one stage record a replay, and its stages and the time
outside them summing to the device time of the replay.  K2 adds floats with atomics in no fixed
order, so two eager runs agree bit for bit only where its sums are exact:
the card's fields make every sum exact (:func:`_exact_field`).  Run there
with ``python -m pytest --noconftest -m cuda
tests/test_torch_pipeline_graph.py``.
"""

import gc
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import xcontour_tpu_torch as xt
from xcontour_tpu_torch import core, parallel, pipeline
from xcontour_tpu_torch.diagnostics import fractal
from xcontour_tpu_torch.kernels import (boxcount, extrema, gradw, hist,
                                        length, lwa, rolling, stencil)
from xcontour_tpu_torch.parallel import pipeline as sp
from xcontour_tpu_torch.utils import prof
from xcontour_tpu_torch.utils.synth import synth_pv

ENTRIES = ("keff", "lwa", "keff_lwa", "clength", "fractal", "local")
RECORDS = (stencil.KERNEL, hist.KERNEL, lwa.KERNEL_LIN, lwa.KERNEL_LIN2,
           lwa.KERNEL_DENSE, lwa.KERNEL_DENSE_TALL, length.KERNEL_LENGTHS,
           length.KERNEL_LOCAL_LENGTHS, boxcount.KERNEL, rolling.KERNEL,
           gradw.KERNEL, extrema.KERNEL)


def _field(dev, dtype=torch.float32, B=3, nlat=64, nlon=128, seed=1):
    v, _ = synth_pv(nlev=B, nlat=nlat, nlon=nlon, seed=seed)
    q = v["pv"].astype(np.float64)
    q[0, 2:5, 10:20] = np.nan                 # a below-ground patch
    grid = xt.from_latlon(v["latitude"].astype(np.float64),
                          v["longitude"].astype(np.float64), dtype=dtype,
                          device=dev)
    return torch.as_tensor(q, dtype=dtype, device=dev), grid


def _exact_field(dev, seed=1, B=3, ny=64, nx=128):
    """A field on a unit Cartesian grid (dA = 1) whose every K2 sum is
    exact, and so the same whatever the order of K2's float atomics: even
    integers along x (a triangle, so the centred |dq/dx| is 0 or 2), the
    same on every row (dq/dy = 0), a NaN patch on the first snapshot.
    Areas count cells; |grad q|^2 is 0 or 4, |grad q| 0 or 2."""
    x = torch.arange(nx)
    tri = torch.minimum(x, nx - x)
    q = 2.0 * (tri[None, None, :] + 3 * torch.arange(B)[:, None, None]
               + seed)
    q = q.expand(B, ny, nx).to(torch.float32).clone()
    q[0, 2:5, 10:20] = float("nan")
    grid = xt.from_cartesian(np.arange(ny, dtype=np.float64),
                             np.arange(nx, dtype=np.float64), device=dev)
    return q.to(dev), grid


def _table(grid):
    return core.cal_area_eqCoord_table_hist(grid.fluid_mask(), grid.ydef,
                                            grid.dA, increase=True, lt=True)


def _call(name, grid, table):
    """(entry, keyword arguments) of each entry as a step calls it."""
    dev, dtype = grid.dA.device, grid.dA.dtype
    return {
        "keff": (pipeline.keff_pipeline,
                 dict(N=31, table=table, pre_y=torch.linspace(
                     grid.ydef[2].item(), grid.ydef[-3].item(), 17,
                     dtype=dtype, device=dev))),
        "lwa": (pipeline.lwa_pipeline, dict(N=31, table=table)),
        "keff_lwa": (pipeline.keff_lwa_pipeline, dict(N=31, table=table)),
        "clength": (pipeline.clength_pipeline, dict(N=31, table=table)),
        "fractal": (pipeline.fractal_pipeline,
                    dict(N=31, strides=[1, 2, 4], table=table)),
        "local": (pipeline.local_length_pipeline, dict(window=9, stride=4)),
    }[name]


def _same(got, want, where=""):
    """Bit for bit, NaN patterns included, nested dicts key by key."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, where
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=where)


@pytest.fixture
def graphs(monkeypatch):
    """A fresh cache and its counters in place of the module's."""
    g = pipeline.Graphs()
    monkeypatch.setattr(pipeline, "GRAPHS", g)
    return g


def _untouched(g, eager):
    assert (g.captures, g.replays, g.eager, len(g)) == (0, 0, eager, 0)


# ---------------------------------------------------------------- the CPU
@pytest.mark.parametrize("name", ENTRIES)
def test_cpu_calls_run_the_eager_body(graphs, name):
    q, grid = _field("cpu", torch.float64)
    fn, kw = _call(name, grid, _table(grid))
    want = fn.__wrapped__(q, grid, **kw)
    for _ in range(3):
        _same(fn(q, grid, **kw), want, name)
    _untouched(graphs, 3)


def _as_if_on_card(monkeypatch):
    """The rule's later tests, reached with CPU tensors."""
    monkeypatch.setattr(pipeline, "_on_card", lambda t: True)


def test_a_call_needing_a_gradient_stays_eager(graphs, monkeypatch):
    _as_if_on_card(monkeypatch)
    q, grid = _field("cpu", torch.float64)
    fn, kw = _call("keff_lwa", grid, _table(grid))
    want = fn.__wrapped__(q, grid, **kw)
    got = fn(q.clone().requires_grad_(True), grid, **kw)
    assert got["lwa"].requires_grad
    _same({k: v.detach() for k, v in got.items()}, want)
    _untouched(graphs, 1)


def test_a_call_without_a_table_stays_eager(graphs, monkeypatch):
    _as_if_on_card(monkeypatch)
    q, grid = _field("cpu", torch.float64)
    for name in ("keff", "lwa", "keff_lwa", "clength", "fractal"):
        fn, kw = _call(name, grid, None)
        _same(fn(q, grid, **kw), fn.__wrapped__(q, grid, **kw), name)
    _untouched(graphs, 5)


def test_a_mesh_layout_stays_eager(graphs, monkeypatch, tmp_path):
    _as_if_on_card(monkeypatch)
    q, grid = _field("cpu", torch.float64)
    table = _table(grid)
    store = dist.FileStore(os.path.join(str(tmp_path), "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(x_size=1)
        got = sp.sharded_keff_lwa_pipeline(q, grid, mesh, N=31, table=table)
        want = pipeline.keff_lwa_pipeline.__wrapped__(
            q, grid, N=31, table=table, _layout=sp._MeshLayout(mesh))
    finally:
        dist.destroy_process_group()
    _same(got, want)
    _untouched(graphs, 1)


def test_keys_differ_by_shape_dtype_arguments_and_table():
    q, grid = _field("cpu")
    t1, t2 = _table(grid), _table(grid)
    fn = pipeline.keff_lwa_pipeline.__wrapped__

    def key(tracer, **kw):
        return pipeline.graph_key(fn, tracer, grid, (), dict(N=31, **kw))[0]
    base = key(q, table=t1)
    assert key(q.clone(), table=t1) == base        # the tracer by its shape
    assert key(q[:2].contiguous(), table=t1) != base
    assert key(q.double(), table=t1) != base
    assert key(q, table=t1, lt=False) != base
    assert key(q, table=t2) != base
    fr = pipeline.fractal_pipeline.__wrapped__
    assert pipeline.graph_key(fr, q, grid, (), dict(strides=[1, 2]))[0] == \
        pipeline.graph_key(fr, q, grid, (), dict(strides=(1, 2)))[0]
    with pytest.raises(TypeError):
        pipeline.graph_key(fn, q, grid, (), dict(N=31, extra={}))


def test_a_freed_table_drops_its_entry():
    q, grid = _field("cpu")
    g = pipeline.Graphs()
    table = _table(grid)
    key, held = pipeline.graph_key(pipeline.lwa_pipeline.__wrapped__, q,
                                   grid, (), dict(table=table))
    g.hold(key, "graph", held)
    del held
    assert len(g) == 1
    del table
    gc.collect()
    assert len(g) == 0
    assert grid is not None


def test_the_cache_stays_at_its_bound():
    q, grid = _field("cpu")
    g = pipeline.Graphs()
    fn = pipeline.lwa_pipeline.__wrapped__
    keys = [pipeline.graph_key(fn, q, grid, (), dict(N=n))
            for n in range(g.SIZE + 3)]
    for key, held in keys:
        g.hold(key, "graph", held)
        assert len(g) <= g.SIZE
    # the least recently used go first; holding a key again renews it
    g.hold(keys[3][0], "graph", keys[3][1])
    key, held = pipeline.graph_key(fn, q, grid, (), dict(N=99))
    g.hold(key, "graph", held)
    kept = list(g._entries)
    assert len(kept) == g.SIZE and keys[3][0] in kept
    assert keys[4][0] not in kept and keys[-1][0] in kept


# ---------------------------------------------- stage timing on the CPU
class _Event:
    """A timing event on a clock that each record moves on by 1 ms; one
    recorded in a capture is a node of the capturing graph."""

    now = 0.0
    made = []

    def __init__(self, external):
        self.external, self.t, self.done = external, None, True
        _Event.made.append(self)

    def record(self, stream=None):
        if _Graph.capturing is not None:   # a node: no time passes
            assert self.external and stream == "capturing"
            _Graph.capturing.nodes.append(self)
            return
        assert not self.external and stream == "current"
        _Event.now += 1.0
        self.t = _Event.now

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


class _Graph:
    """A CUDA graph whose replay records its event nodes, 1 ms apart (it
    runs no kernel: its outputs are the capture's)."""

    capturing = None

    def __init__(self):
        self.nodes = []

    def replay(self):
        for ev in self.nodes:
            _Event.now += 1.0
            ev.t, ev.done = _Event.now, True


class _Capture:
    def __init__(self, graph, **kw):
        self.graph = graph

    def __enter__(self):
        _Graph.capturing = self.graph

    def __exit__(self, *exc):
        _Graph.capturing = None
        return False


@pytest.fixture
def timed_cpu(graphs, monkeypatch):
    """CPU calls taken as calls on the card, captured into fake graphs
    and timed with fake events; no stage record of other tests."""
    _as_if_on_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: _Graph.capturing is not None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _Capture)
    monkeypatch.setattr(prof, "_event", _Event)
    # the stream current where a body's events are made
    monkeypatch.setattr(prof, "_current", lambda device: (
        "capturing" if _Graph.capturing is not None else "current"))
    monkeypatch.setattr(prof, "_records", type(prof._records)(
        maxlen=prof.LOG_SIZE))
    monkeypatch.setattr(prof, "_pending", {})
    monkeypatch.setattr(prof, "_lost", [0])
    monkeypatch.setattr(_Event, "made", [])
    return graphs


KEFF_LWA_STAGES = ["stage.gradient", "stage.contours", "stage.cdf",
                   "stage.lookup", "stage.lmin", "stage.keff",
                   "stage.interp", "stage.lwa"]


def test_untraced_keys_and_graphs_time_nothing(timed_cpu):
    q, grid = _field("cpu")
    table = _table(grid)
    fn, kw = _call("keff_lwa", grid, table)
    for _ in range(3):                 # warm-up, capture and replay, replay
        fn(q, grid, **kw)
    assert (timed_cpu.captures, timed_cpu.replays, timed_cpu.eager) == \
        (1, 2, 1)
    ((key, (g, _)),) = timed_cpu._entries.items()
    # the key as before stage timing, with False where timing is on
    held = []
    assert key == (fn.__wrapped__, tuple(q.shape), q.dtype, q.device, 0,
                   pipeline._part(grid, held), (),
                   tuple(sorted((k, pipeline._part(v, held))
                                for k, v in kw.items())), False)
    assert g.stages is None and not _Event.made
    assert prof.stage_times() == []


def test_timed_and_untimed_keys_are_held_apart(timed_cpu):
    q, grid = _field("cpu")
    fn, kw = _call("keff_lwa", grid, _table(grid))
    fn(q, grid, **kw)
    fn(q, grid, **kw)                  # the untimed graph
    with prof.logging():
        for _ in range(3):             # the timed key's warm-up, capture
            fn(q, grid, **kw)          # and replay, replay
    fn(q, grid, **kw)                  # the untimed graph again
    assert (timed_cpu.captures, timed_cpu.replays, timed_cpu.eager) == \
        (2, 4, 2)
    keys = list(timed_cpu._entries)
    assert len(keys) == 2 and [k[-1] for k in keys] == [True, False]
    assert keys[0][:-1] == keys[1][:-1]
    timed, untimed = (timed_cpu._entries[k][0] for k in keys)
    assert untimed.stages is None and timed.stages is not None
    # the bound counts them as two: SIZE - 1 other keys drop the timed
    other = pipeline.lwa_pipeline.__wrapped__
    for n in range(timed_cpu.SIZE - 1):
        key, held = pipeline.graph_key(other, q, grid, (), dict(N=n))
        timed_cpu.hold(key, "graph", held)
    assert keys[0] not in timed_cpu._entries
    assert keys[1] in timed_cpu._entries
    assert len(prof.stage_times()) == 3


def test_each_timed_call_leaves_one_record(timed_cpu, monkeypatch):
    q, grid = _field("cpu")
    fn, kw = _call("keff_lwa", grid, _table(grid))
    settled = []
    settle = prof.settle
    monkeypatch.setattr(prof, "settle", lambda entry: (
        settled.append((entry, time.perf_counter_ns())), settle(entry)))
    with prof.logging():
        for _ in range(4):
            fn(q, grid, **kw)
    recs = prof.stage_times()
    assert [(r.kind, r.ordinal) for r in recs] == \
        [("eager", 1), ("replay", 1), ("replay", 2), ("replay", 3)]
    for r in recs:
        assert r.entry == "pipeline.keff_lwa_pipeline"
        assert [n for n, _, _ in r.stages] == KEFF_LWA_STAGES
        # each stage 1 ms, 2 ms apart from the body's first event; the
        # body's 17 ms less the stages'
        assert [(a, ms) for _, a, ms in r.stages] == \
            [(1.0 + 2 * i, 1.0) for i in range(8)]
        assert r.outside_ms == 9.0
    assert all(a.launch_ns < b.launch_ns for a, b in zip(recs, recs[1:]))
    # each call read the last one's record before its entry's span opened
    opened = [s[2] for s in prof.spans()
              if s[0] == "pipeline.keff_lwa_pipeline"][-4:]
    assert [e for e, _ in settled] == ["pipeline.keff_lwa_pipeline"] * 4
    assert all(t < a for (_, t), a in zip(settled, opened))
    assert all(a < r.launch_ns for a, r in zip(opened, recs))


def test_a_replay_unfinished_at_the_next_call_is_lost(timed_cpu):
    q, grid = _field("cpu")
    fn, kw = _call("lwa", grid, _table(grid))
    with prof.logging():
        fn(q, grid, **kw)
        fn(q, grid, **kw)
        graph = next(iter(timed_cpu._entries.values()))[0]
        graph.stages.events[-1][3].done = False
        prof._pending["pipeline.lwa_pipeline"][-1]._end.done = False
        fn(q, grid, **kw)
    assert prof.stage_records_lost() == 1
    assert [(r.kind, r.ordinal) for r in prof.stage_times()] == \
        [("eager", 1), ("replay", 2)]


def test_records_outlive_their_graph(timed_cpu):
    q, grid = _field("cpu")
    table = _table(grid)
    fn, kw = _call("clength", grid, table)
    with prof.logging():
        for _ in range(3):
            fn(q, grid, **kw)
    assert len(timed_cpu) == 1
    del kw, table
    gc.collect()
    assert len(timed_cpu) == 0         # the table freed drops the graph
    recs = prof.stage_times()
    assert [r.kind for r in recs] == ["eager", "replay", "replay"]
    assert [n for n, _, _ in recs[-1].stages] == [
        "stage.contours", "stage.gradient", "stage.cdf", "stage.lookup",
        "stage.lengths", "stage.lmin", "stage.keff"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_keep_their_bits(dtype):
    q, grid = _field("cpu", dtype)
    q[1] = float("nan")                        # an all-NaN plane
    # the parent's forms: 0-d constants made on the tracer's device
    isn = torch.isnan(q)
    inf = torch.tensor(float("inf"), dtype=dtype)
    nan = torch.tensor(float("nan"), dtype=dtype)
    lo = torch.where(isn, inf, q).amin(dim=(-2, -1))
    hi = torch.where(isn, -inf, q).amax(dim=(-2, -1))
    got_lo, got_hi = core.masked_extrema(q)
    _same(got_lo, lo)
    _same(got_hi, hi)
    for inc in (True, False):
        a = torch.where(lo == inf, nan, lo)
        b = torch.where(hi == -inf, nan, hi)
        start, end = (a, b) if inc else (b, a)
        steps = (end - start) / torch.full_like(end, 30.0)
        want = steps[..., None] * torch.arange(31, dtype=dtype) \
            + start[..., None]
        want[..., -1] = end
        _same(core.levels_from_extrema(lo, hi, 31, increase=inc), want)
    # the fractal rulers and dimension: the strides made once
    strides = [1, 2, 4]
    out = pipeline.fractal_pipeline(q, grid, N=31, strides=strides,
                                    table=_table(grid))
    reso = grid.xdef[1] - grid.xdef[0]
    rulers = (torch.as_tensor(strides, dtype=dtype)
              * torch.cos(torch.deg2rad(out["Yeq"]))[..., None]
              * torch.deg2rad(reso).to(dtype) * pipeline._REARTH)
    _same(out["rulers"], rulers)
    _same(out["D"], fractal.fractal_dimension(out["lengths"], rulers))


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    return [r.launches for r in RECORDS]


def _delta(before):
    return [a - b for a, b in zip(_counts(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRIES)
def test_replay_is_the_eager_body_bit_for_bit(cuda, graphs, name):
    q0, grid = _exact_field(cuda, seed=1)
    q1, _ = _exact_field(cuda, seed=2)
    fn, kw = _call(name, grid, _table(grid))
    want0 = fn.__wrapped__(q0, grid, **kw)
    want1 = fn.__wrapped__(q1, grid, **kw)
    _same(fn(q0, grid, **kw), want0, "warm-up")
    _same(fn(q1, grid, **kw), want1, "capture")
    _same(fn(q0, grid, **kw), want0, "replay")
    assert (graphs.captures, graphs.replays, graphs.eager) == (1, 2, 1)


@pytest.mark.cuda
def test_a_kept_output_outlives_the_next_call(cuda, graphs):
    q0, grid = _exact_field(cuda, seed=1)
    q1, _ = _exact_field(cuda, seed=2)
    fn, kw = _call("keff_lwa", grid, _table(grid))
    fn(q0, grid, **kw)
    kept = fn(q1, grid, **kw)
    again = fn(q1, grid, **kw)
    fn(q0, grid, **kw)
    torch.cuda.synchronize()
    _same(kept, fn.__wrapped__(q1, grid, **kw))
    _same(again, kept)
    assert graphs.replays == 3


@pytest.mark.cuda
def test_four_inputs_replay_one_graph(cuda, graphs):
    _, grid = _exact_field(cuda)
    ring = [_exact_field(cuda, seed=s)[0] for s in range(4)]
    fn, kw = _call("clength", grid, _table(grid))
    outs = [fn(ring[i % 4], grid, **kw) for i in range(8)]
    assert (graphs.captures, graphs.replays, graphs.eager, len(graphs)) == \
        (1, 7, 1, 1)
    for i, out in enumerate(outs):
        _same(out, fn.__wrapped__(ring[i % 4], grid, **kw), f"call {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRIES)
def test_a_replay_counts_each_launch_once(cuda, graphs, name):
    q, grid = _exact_field(cuda)
    fn, kw = _call(name, grid, _table(grid))
    per_call = []
    for _ in range(3):                 # warm-up, capture and replay, replay
        before = _counts()
        fn(q, grid, **kw)
        per_call.append(_delta(before))
    assert graphs.captures == 1 and graphs.replays == 2
    assert any(per_call[0])
    assert per_call[1] == per_call[0] and per_call[2] == per_call[0]


@pytest.fixture
def fresh_records(monkeypatch):
    """No stage record of other tests."""
    monkeypatch.setattr(prof, "_records", type(prof._records)(
        maxlen=prof.LOG_SIZE))
    monkeypatch.setattr(prof, "_pending", {})
    monkeypatch.setattr(prof, "_lost", [0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRIES)
def test_a_timed_replay_is_the_plain_replay_bit_for_bit(cuda, graphs, name,
                                                        fresh_records):
    q0, grid = _exact_field(cuda, seed=1)
    q1, _ = _exact_field(cuda, seed=2)
    fn, kw = _call(name, grid, _table(grid))
    plain = [fn(q, grid, **kw) for q in (q0, q1, q0)]
    timed = []
    with prof.logging():
        for q in (q0, q1, q0):
            timed.append(fn(q, grid, **kw))
            # finished before the next call reads its record
            torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(timed, plain)):
        _same(got, want, f"call {i}")
    assert (graphs.captures, graphs.replays, graphs.eager, len(graphs)) == \
        (2, 4, 2, 2)
    recs = prof.stage_times()
    assert [(r.kind, r.ordinal) for r in recs] == \
        [("eager", 2), ("replay", 3), ("replay", 4)]
    assert prof.stage_records_lost() == 0
    assert all(r.entry == f"pipeline.{fn.__name__}" and r.stages
               for r in recs)
    assert [n for n, _, _ in recs[1].stages] == \
        [n for n, _, _ in recs[0].stages]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRIES)
def test_stages_and_outside_sum_to_the_replaying_call(cuda, graphs, name,
                                                      fresh_records):
    # an ERA5-sized step, so that launching it is a small part of the pair
    # of events around it
    q, grid = _exact_field(cuda, B=16, ny=720, nx=1440)
    fn, kw = _call(name, grid, _table(grid))
    sums, around = [], []
    with prof.logging():
        for i in range(7):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(q, grid, **kw)
            b.record()
            torch.cuda.synchronize()
            rec = prof.stage_times()[-1]
            if i >= 2:                 # the warm-up and capture done
                assert rec.kind == "replay"
                sums.append(sum(ms for _, _, ms in rec.stages)
                            + rec.outside_ms)
                around.append(a.elapsed_time(b))
    assert all(0.0 <= ms for r in prof.stage_times() for _, _, ms in
               r.stages)
    sums.sort()
    around.sort()
    assert sums[2] == pytest.approx(around[2], rel=0.05)


@pytest.mark.cuda
def test_a_capture_beside_a_copying_thread(cuda, graphs):
    q, grid = _exact_field(cuda)
    fn, kw = _call("keff_lwa", grid, _table(grid))
    host = torch.randn(1 << 22).pin_memory()
    stop, copies = threading.Event(), [0]

    def copy():
        stream = torch.cuda.Stream(cuda)
        dst = torch.empty(host.shape, device=cuda)
        with torch.cuda.stream(stream):
            while not stop.is_set():
                dst.copy_(host, non_blocking=True)
                stream.synchronize()
                copies[0] += 1

    worker = threading.Thread(target=copy)
    worker.start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fn(q, grid, **kw)
            got = fn(q, grid, **kw)
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and copies[0] > 0
    assert graphs.captures == 1
    _same(got, fn.__wrapped__(q, grid, **kw))
