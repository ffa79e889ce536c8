"""The port's batch runner (``xcontour_tpu_torch.runner``) on the CPU.

The runner tests of ``tests/test_runner_checks.py`` and the failure
injection of ``tests/test_failure_injection.py``, ported (checkpoint and
resume, retries with backoff, ``.failed`` records, prefetch read faults,
damaged checkpoints, the f16/bf16 wire and its range guard), and the port
held against the JAX runner on the same snapshots: the same pipeline step
through each ``run_batched`` (float64, within 1e-10 of each key's largest
magnitude), the same chunk files and ``.failed`` records, stems read
across packages, and the wire's host rounding bit for bit.  Every call
passes ``device='cpu'``: the runner's default is the card.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import grid as jgrid
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu import runner as jrunner
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import runner as R
from xcontour_tpu_torch.runner import WireRangeError, load_chunks, run_batched
from xcontour_tpu_torch.utils import checks as tchecks
from xcontour_tpu_torch.utils.ncio import load_dataset, save_dataset
from xcontour_tpu_torch.utils.synth import synth_pv

CPU = "cpu"
QUIET = dict(log=lambda s: None, device=CPU)


def _step(x):
    return {"mean": x.mean(dim=(-2, -1)), "double": x * 2}


def _jstep(x):
    return {"mean": jnp.mean(x, axis=(-2, -1)), "double": x * 2}


def _mean(a):
    return a.mean(axis=(1, 2))


# -- the JAX runner's tests, ported -----------------------------------------

def test_runner_in_memory(rng):
    snaps = rng.normal(size=(10, 8, 16))
    out = run_batched(_step, snaps, batch=4, **QUIET)
    assert out["mean"].shape == (10,)
    assert isinstance(out["mean"], np.ndarray)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=1e-6)
    np.testing.assert_allclose(out["double"], snaps * 2, rtol=1e-6)


def test_runner_tail_chunk_runs_at_its_own_size(rng):
    """No padding: eager torch reuses no compiled shape, so the tail chunk
    runs at its own size, and its outputs equal the padded JAX run's (the
    means to the summation order)."""
    snaps = rng.normal(size=(10, 8, 16))
    sizes = []

    def step(x):
        sizes.append(x.shape[0])
        return _step(x)

    out = run_batched(step, snaps, batch=4, **QUIET)
    assert sizes == [4, 4, 2]
    want = jrunner.run_batched(jax.jit(_jstep), snaps, batch=4,
                               log=lambda s: None)
    np.testing.assert_array_equal(out["double"], np.asarray(want["double"]))
    np.testing.assert_allclose(out["mean"], np.asarray(want["mean"]),
                               rtol=1e-12, atol=0)


def test_runner_resume(tmp_path, rng):
    snaps = rng.normal(size=(10, 8, 16))
    stem = str(tmp_path / "out")
    calls = []

    def counting_step(x):
        calls.append(1)
        return _step(x)

    run_batched(counting_step, snaps, batch=4, out_stem=stem, **QUIET)
    assert len(calls) == 3
    # delete one chunk -> only that chunk recomputes
    os.remove(stem + "_ck00001.npz")
    run_batched(counting_step, snaps, batch=4, out_stem=stem, **QUIET)
    assert len(calls) == 4
    out = load_chunks(stem)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=1e-6)


def _nan_poisoned(snaps, bad_chunk, batch):
    snaps = snaps.copy()
    snaps[bad_chunk * batch] = np.nan
    return snaps


def _validate_finite(out_np):
    for k, v in out_np.items():
        if not np.isfinite(v).all():
            raise ValueError(f"non-finite output in {k!r}")


def test_runner_skip_bad_chunk_in_memory(rng):
    """A NaN-poisoned chunk is retried, then NaN-filled; the rest of the
    archive survives with aligned time indices."""
    snaps = _nan_poisoned(rng.normal(size=(12, 8, 16)), bad_chunk=1, batch=4)
    attempts = []

    def step(x):
        attempts.append(1)
        return _step(x)

    out = run_batched(step, snaps, batch=4, retries=1, on_error="skip",
                      retry_wait=0.0, validate=_validate_finite, **QUIET)
    assert len(attempts) == 3 + 1          # 3 chunks + 1 retry of the bad one
    assert out["mean"].shape == (12,)
    assert np.isnan(out["mean"][4:8]).all()      # failed chunk NaN-filled
    good = np.r_[0:4, 8:12]
    np.testing.assert_allclose(out["mean"][good], _mean(snaps[good]),
                               rtol=1e-6)


def test_runner_raise_is_default(rng):
    snaps = _nan_poisoned(rng.normal(size=(8, 8, 16)), bad_chunk=0, batch=4)
    with pytest.raises(ValueError, match="non-finite"):
        run_batched(_step, snaps, batch=4, validate=_validate_finite,
                    **QUIET)


def test_runner_failed_marker_and_resume_retry(tmp_path, rng):
    """File mode: the bad chunk leaves a structured .failed record,
    load_chunks refuses it by default / NaN-fills on request, and a resumed
    run with the poison removed repairs the archive and clears the marker."""
    snaps = _nan_poisoned(rng.normal(size=(12, 8, 16)), bad_chunk=2, batch=4)
    stem = str(tmp_path / "era")
    run_batched(_step, snaps, batch=4, out_stem=stem, on_error="skip",
                retry_wait=0.0, validate=_validate_finite, **QUIET)
    marker = stem + "_ck00002.failed"
    assert os.path.exists(marker)
    with pytest.raises(RuntimeError, match="failed chunk"):
        load_chunks(stem)
    out = load_chunks(stem, allow_failed=True)
    assert out["mean"].shape == (12,) and np.isnan(out["mean"][8:]).all()

    calls = []
    fixed = snaps.copy()
    fixed[8] = 0.0

    def counting_step(x):
        calls.append(1)
        return _step(x)

    run_batched(counting_step, fixed, batch=4, out_stem=stem,
                on_error="skip", retry_wait=0.0, validate=_validate_finite,
                **QUIET)
    assert len(calls) == 1
    assert not os.path.exists(marker)
    out = load_chunks(stem)
    assert np.isfinite(out["mean"]).all()


def test_runner_checks_guard_surfaces_in_record(tmp_path, rng):
    """A ``utils.checks`` guard recorded inside ``checked`` and thrown by the
    step rejects the chunk, and its message lands in the .failed record."""
    snaps = rng.normal(size=(8, 8, 16))
    snaps[5] = 7.0                                  # constant row -> zero diff

    def guarded(x):
        tchecks.check_monotonic(x, axis=-1, name="tracer")
        return _step(x)

    def step_with_guard(x):
        err, out = tchecks.checked(guarded)(x)
        err.throw()
        return out

    stem = str(tmp_path / "guard")
    run_batched(step_with_guard, snaps, batch=4, out_stem=stem,
                on_error="skip", retry_wait=0.0, **QUIET)
    with open(stem + "_ck00001.failed") as f:
        rec = json.load(f)
    assert "monotonic" in rec["error"]
    assert rec["chunk"] == 1 and rec["nvalid"] == 4
    assert not os.path.exists(stem + "_ck00000.failed")


def test_fetch_bit_identical(rng):
    """The fetch returns exactly each output's values and dtype, across
    mixed dtypes, ranks, a non-tensor and an unbatchable scalar."""
    x = torch.from_numpy(rng.normal(size=(6, 4, 8)).astype(np.float32))
    out = {"a": x.mean(dim=(-2, -1)), "b": x * 2,
           "c": torch.argmax(x.reshape(6, -1), dim=1), "s": x.sum(),
           "n": np.arange(6)}
    got = R._fetch(out, torch.device(CPU))
    assert list(got) == list(out)
    for k, v in out.items():
        want = v.numpy() if isinstance(v, torch.Tensor) else v
        np.testing.assert_array_equal(got[k], want)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape


# -- reduced-precision host->device transfers --------------------------------

def test_transfer_dtype_f16_bounded_error(rng):
    """transfer_dtype=float16 halves the wire payload; outputs stay within
    the f16 INPUT-rounding bound (~5e-4 relative) of the f32 run -- and the
    device still computes in f32."""
    snaps = rng.normal(size=(8, 16, 32)).astype(np.float32)
    f32 = run_batched(_step, snaps, batch=4, **QUIET)
    f16 = run_batched(_step, snaps, batch=4, transfer_dtype=np.float16,
                      **QUIET)
    assert not np.array_equal(f16["mean"], f32["mean"])     # really narrowed
    np.testing.assert_allclose(f16["mean"], f32["mean"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(f16["double"], f32["double"], rtol=2e-3)
    np.testing.assert_array_equal(
        f16["double"], 2.0 * snaps.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("wire", [torch.bfloat16, "bfloat16"])
def test_transfer_dtype_bf16(rng, wire):
    snaps = rng.normal(size=(4, 8, 16)).astype(np.float32)
    out = run_batched(_step, snaps, batch=4, transfer_dtype=wire, **QUIET)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=0, atol=2e-2)
    assert out["mean"].dtype == np.float32                  # upcast held


@pytest.mark.parametrize("wire", [np.float32, torch.float32, torch.float64,
                                  "float64"])
def test_transfer_dtype_must_narrow(rng, wire):
    snaps = rng.normal(size=(4, 8, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="not narrower"):
        run_batched(_step, snaps, batch=4, transfer_dtype=wire, **QUIET)


def test_transfer_dtype_range_guard(rng):
    """Values outside the wire dtype's range raise a named error, not
    silently become inf (overflow) or collapse into subnormals."""
    base = rng.normal(size=(4, 8, 16)).astype(np.float32)
    kw = dict(batch=4, **QUIET)
    with pytest.raises(ValueError, match="overflow"):      # |v| > f16 max
        run_batched(_step, base * 1e5, transfer_dtype=np.float16, **kw)
    with pytest.raises(ValueError, match="subnormal"):     # whole chunk tiny
        run_batched(_step, base * 1e-6, transfer_dtype=np.float16, **kw)
    out = run_batched(_step, base * 1e5, transfer_dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(out["mean"], _mean(base * 1e5), rtol=0,
                               atol=2e-2 * 1e5)
    masked = base.copy()
    masked[:, 0, 0] = np.nan
    masked[:, 1, 1] = np.inf
    run_batched(_step, masked, transfer_dtype=np.float16, **kw)


def test_wire_range_error_is_not_retried_or_skipped(rng, monkeypatch):
    """A deterministic out-of-range chunk is a configuration error: it
    aborts at once, with no backoff and no NaN-filled chunk."""
    base = rng.normal(size=(4, 8, 16)).astype(np.float32) * 1e5
    sleeps = []
    monkeypatch.setattr(R.time, "sleep", sleeps.append)
    with pytest.raises(WireRangeError, match="overflow"):
        run_batched(_step, base, batch=4, transfer_dtype=np.float16,
                    retries=3, on_error="skip", **QUIET)
    assert sleeps == []


def test_runner_rejects_scalar_outputs(rng):
    snaps = rng.normal(size=(6, 8, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="total"):
        run_batched(lambda x: {"total": x.sum()}, snaps, batch=4, **QUIET)


def test_load_chunks_detects_index_gap(tmp_path, rng):
    snaps = rng.normal(size=(10, 8, 16))
    stem = str(tmp_path / "gap")
    run_batched(_step, snaps, batch=4, out_stem=stem, **QUIET)
    os.remove(stem + "_ck00001.npz")
    with pytest.raises(RuntimeError, match="gap"):
        load_chunks(stem)
    run_batched(_step, snaps, batch=4, out_stem=stem, **QUIET)
    out = load_chunks(stem)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=1e-6)


# -- failure injection, ported ---------------------------------------------

def test_chunk_fails_k_times_then_succeeds(rng, monkeypatch):
    """A chunk that fails twice and succeeds on the third attempt heals with
    no residue, after the backoff retry_wait * 2**attempt."""
    snaps = rng.normal(size=(12, 8, 16))
    fails_left = {1: 2}
    waits = []
    monkeypatch.setattr(time, "sleep", lambda s: waits.append(s))

    def flaky_step(x):
        k = int(np.round(float(x[0, 0, 0])))
        if fails_left.get(k, 0) > 0:
            fails_left[k] -= 1
            raise RuntimeError(f"transient fault on chunk {k}")
        return _step(x)

    marked = snaps.copy()
    for k in range(3):
        marked[k * 4, 0, 0] = k               # chunk id beacon
    out = run_batched(flaky_step, marked, batch=4, retries=2,
                      on_error="raise", retry_wait=0.125, **QUIET)
    assert fails_left == {1: 0}
    assert waits == [0.125, 0.25]
    assert np.isfinite(out["mean"]).all()
    np.testing.assert_allclose(out["mean"], _mean(marked), rtol=1e-6)


def test_retries_exhausted_then_raise(rng, monkeypatch):
    snaps = rng.normal(size=(4, 8, 16))
    monkeypatch.setattr(time, "sleep", lambda s: None)
    n = {"v": 0}

    def always_bad(x):
        n["v"] += 1
        raise RuntimeError(f"attempt {n['v']}")

    with pytest.raises(RuntimeError, match="attempt 3"):
        run_batched(always_bad, snaps, batch=4, retries=2, retry_wait=0.0,
                    **QUIET)
    assert n["v"] == 3


class _FlakySource:
    """A lazy (T, Ny, Nx) source whose reads of one chunk's row range fail a
    configurable number of times (a transient read error on the prefetch
    thread)."""

    def __init__(self, data, bad_rows, fails):
        self._data = np.asarray(data)
        self._bad = bad_rows
        self.fails_left = fails
        self.read_attempts = 0
        self.shape, self.ndim = self._data.shape, self._data.ndim
        self.dtype = self._data.dtype

    def __getitem__(self, sl):
        rows = range(*sl.indices(self._data.shape[0]))
        if self._bad in rows:
            self.read_attempts += 1
            if self.fails_left > 0:
                self.fails_left -= 1
                raise OSError("simulated transient read error "
                              f"(rows {rows.start}:{rows.stop})")
        return self._data[sl]


def test_prefetch_read_transient_failure_heals(rng):
    data = rng.normal(size=(12, 8, 16))
    src = _FlakySource(data, bad_rows=4, fails=1)   # chunk 1, fails once
    out = run_batched(_step, src, batch=4, retries=0, retry_wait=0.0,
                      **QUIET)
    assert src.read_attempts == 2                   # prefetch fail + re-read
    np.testing.assert_allclose(out["mean"], _mean(data), rtol=1e-6)


def test_prefetch_read_permanent_failure_isolated(tmp_path, rng):
    data = rng.normal(size=(12, 8, 16))
    src = _FlakySource(data, bad_rows=4, fails=10 ** 9)
    stem = str(tmp_path / "flaky")
    run_batched(_step, src, batch=4, out_stem=stem, retries=1,
                on_error="skip", retry_wait=0.0, **QUIET)
    with open(stem + "_ck00001.failed") as f:
        rec = json.load(f)
    assert rec["chunk"] == 1 and "read error" in rec["error"]
    out = load_chunks(stem, allow_failed=True, expect_chunks=3)
    assert np.isnan(out["mean"][4:8]).all()
    good = np.r_[0:4, 8:12]
    np.testing.assert_allclose(out["mean"][good], _mean(data[good]),
                               rtol=1e-6)

    src2 = _FlakySource(data, bad_rows=8, fails=10 ** 9)
    out2 = run_batched(_step, src2, batch=4, retries=0, on_error="skip",
                       retry_wait=0.0, **QUIET)
    assert np.isnan(out2["mean"][8:]).all()
    np.testing.assert_allclose(out2["mean"][:8], _mean(data[:8]), rtol=1e-6)

    src3 = _FlakySource(data, bad_rows=4, fails=0)
    run_batched(_step, src3, batch=4, out_stem=stem, on_error="skip",
                retry_wait=0.0, **QUIET)
    assert not os.path.exists(stem + "_ck00001.failed")
    out3 = load_chunks(stem, expect_chunks=3)
    np.testing.assert_allclose(out3["mean"], _mean(data), rtol=1e-6)


@pytest.fixture
def written_stem(tmp_path, rng):
    snaps = rng.normal(size=(12, 8, 16))
    stem = str(tmp_path / "arch")
    run_batched(_step, snaps, batch=4, out_stem=stem, **QUIET)
    return stem, snaps


def test_corrupt_chunk_named_in_error(written_stem, rng):
    stem, snaps = written_stem
    bad = stem + "_ck00001.npz"
    with open(bad, "wb") as f:
        f.write(bytes(rng.integers(0, 256, 200, dtype=np.uint8)))
    with pytest.raises(RuntimeError, match="ck00001.npz.*corrupt"):
        load_chunks(stem)
    os.remove(bad)
    run_batched(_step, snaps, batch=4, out_stem=stem, **QUIET)
    out = load_chunks(stem, expect_chunks=3)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=1e-6)


def test_truncated_chunk_named_in_error(written_stem):
    stem, _ = written_stem
    bad = stem + "_ck00002.npz"
    with open(bad, "rb") as f:
        blob = f.read()
    with open(bad, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(RuntimeError, match="ck00002.npz.*corrupt"):
        load_chunks(stem)


def test_corrupt_failed_marker_named_in_error(written_stem):
    stem, _ = written_stem
    with open(stem + "_ck00001.failed", "w") as f:
        f.write("{not json")
    with pytest.raises(RuntimeError, match="ck00001.failed.*unreadable"):
        load_chunks(stem)
    with pytest.raises(RuntimeError, match="ck00001.failed.*unreadable"):
        load_chunks(stem, allow_failed=True)


def test_missing_trailing_chunk_detected(written_stem):
    stem, snaps = written_stem
    os.remove(stem + "_ck00002.npz")
    out = load_chunks(stem)                    # undetectable by design
    assert out["mean"].shape == (8,)
    with pytest.raises(RuntimeError, match="gap.*\\[2\\]"):
        load_chunks(stem, expect_chunks=3)


def test_stale_tmp_from_killed_write_is_ignored(written_stem):
    stem, snaps = written_stem
    with open(stem + "_ck00001.npz.tmp.npz", "wb") as f:
        f.write(b"partial write at kill time")
    calls = []
    run_batched(lambda x: (calls.append(1), _step(x))[1], snaps, batch=4,
                out_stem=stem, **QUIET)
    assert calls == []
    out = load_chunks(stem, expect_chunks=3)
    np.testing.assert_allclose(out["mean"], _mean(snaps), rtol=1e-6)


def test_garbage_netcdf_clear_error(tmp_path, rng):
    path = str(tmp_path / "garbage.nc")
    with open(path, "wb") as f:
        f.write(bytes(rng.integers(0, 256, 512, dtype=np.uint8)))
    for lazy in (False, True):
        with pytest.raises(ValueError, match="not a readable netCDF"):
            load_dataset(path, lazy=lazy)


def test_truncated_nc4_clear_error(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "trunc.nc")
    save_dataset(path, {"q": np.zeros((4, 8, 16), np.float32)},
                 {"q": ("time", "lat", "lon")},
                 coords={"lat": np.linspace(-80, 80, 8),
                         "lon": np.linspace(0.0, 337.5, 16)})
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="not a readable netCDF"):
        load_dataset(path)


def test_runner_rejects_bad_on_error(rng):
    with pytest.raises(ValueError, match="on_error"):
        run_batched(_step, rng.normal(size=(4, 8, 16)), batch=4,
                    on_error="ignore", device=CPU)


def test_all_chunks_failed_in_memory(rng):
    def bad(x):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError, match="all chunks failed"):
        run_batched(bad, rng.normal(size=(8, 8, 16)), batch=4,
                    on_error="skip", retry_wait=0.0, **QUIET)


def test_load_chunks_no_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="no chunks"):
        load_chunks(str(tmp_path / "nothing"))


def test_load_chunks_all_failed(tmp_path):
    stem = str(tmp_path / "af")
    with open(stem + "_ck00000.failed", "w") as f:
        f.write('{"chunk": 0, "nvalid": 2, "error": "boom"}')
    with pytest.raises(RuntimeError, match="nothing to assemble"):
        load_chunks(stem, allow_failed=True)


# -- the port's own contract ------------------------------------------------

def test_default_device_is_the_card(rng, monkeypatch):
    """``device=None`` streams to the card and raises where there is none;
    it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batched(_step, rng.normal(size=(4, 8, 16)), batch=4,
                    log=lambda s: None)


def test_big_endian_memmap_rejected_by_both_runners(tmp_path, rng):
    """A classic netCDF file's lazy variable is a read-only big-endian
    memmap: both runners reject it; the CLI's _LazyField converts it."""
    from xcontour_tpu_torch.utils.ncio import save_dataset_nc3
    q = rng.normal(size=(4, 8, 16)).astype(np.float32)
    path = str(tmp_path / "be.nc")
    save_dataset_nc3(path, {"q": q}, {"q": ("time", "lat", "lon")})
    raw = load_dataset(path, lazy=True)["q"]
    assert raw.dtype == np.dtype(">f4") and not raw.flags.writeable
    with pytest.raises(TypeError, match="byte order"):
        run_batched(_step, raw, batch=2, **QUIET)
    with pytest.raises(TypeError):
        jrunner.run_batched(jax.jit(_jstep), raw, batch=2,
                            log=lambda s: None)


# -- parity with the JAX runner ---------------------------------------------

def _pv(T=7, nlat=24, nlon=36, seed=5):
    v, _ = synth_pv(nlev=T, nlat=nlat, nlon=nlon, seed=seed)
    q = v["pv"].astype(np.float64)
    q[0, 2:5, 10:20] = np.nan                 # a below-ground patch
    return v["latitude"].astype(np.float64), v["longitude"].astype(np.float64), q


def _keff_lwa_steps(lat, lon, N=12):
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)

    def jstep(x):
        flat = jpipe.flatten_output(jpipe.keff_lwa_pipeline(x, jg, N=N))
        flat.pop("table", None)
        return flat

    def tstep(x):
        flat = xt.flatten_output(xt.keff_lwa_pipeline(x, tg, N=N))
        flat.pop("table", None)
        return flat

    return jax.jit(jstep), tstep


def _close(got, want, tol=1e-10):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        m = np.isfinite(b)
        scale = np.abs(b[m]).max() if m.any() else 1.0
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=tol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("stem", [False, True])
def test_keff_lwa_through_both_runners(tmp_path, stem):
    """The same float64 keff_lwa step through each package's runner, 7
    snapshots in chunks of 3 (JAX pads the tail, the port does not)."""
    lat, lon, q = _pv()
    jstep, tstep = _keff_lwa_steps(lat, lon)
    kw = dict(batch=3, log=lambda s: None)
    if stem:
        js, ts = str(tmp_path / "j"), str(tmp_path / "t")
        jrunner.run_batched(jstep, q, out_stem=js, **kw)
        run_batched(tstep, q, out_stem=ts, device=CPU, **kw)
        jo, to = jrunner.load_chunks(js), load_chunks(ts)
        assert sorted(os.listdir(tmp_path)) == sorted(
            [f"{p}_ck{k:05d}.npz" for p in "jt" for k in range(3)])
    else:
        jo = jrunner.run_batched(jstep, q, **kw)
        to = run_batched(tstep, q, device=CPU, **kw)
    _close(to, jo)


def test_stems_load_across_packages(tmp_path, rng):
    """Each load_chunks reads a stem the other runner wrote, failed chunk
    and all; the arrays are equal."""
    snaps = _nan_poisoned(rng.normal(size=(10, 8, 16)), bad_chunk=1, batch=4)
    js, ts = str(tmp_path / "j"), str(tmp_path / "t")
    kw = dict(batch=4, log=lambda s: None, on_error="skip", retry_wait=0.0,
              validate=_validate_finite)
    jrunner.run_batched(jax.jit(_jstep), snaps, out_stem=js, **kw)
    run_batched(_step, snaps, out_stem=ts, device=CPU, **kw)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{p}_ck{k:05d}.{e}" for p in "jt"
                           for k, e in ((0, "npz"), (1, "failed"),
                                        (2, "npz")))
    for p in "jt":
        with open(tmp_path / f"{p}_ck00001.failed") as f:
            rec = json.load(f)
        assert set(rec) == {"chunk", "nvalid", "error"}
        assert rec["chunk"] == 1 and rec["nvalid"] == 4
        assert "non-finite" in rec["error"]
    for stem, own in ((js, jrunner.load_chunks), (ts, load_chunks)):
        ref = own(stem, allow_failed=True)
        for load in (jrunner.load_chunks, load_chunks):
            with pytest.raises(RuntimeError, match="failed chunk"):
                load(stem)
            out = load(stem, allow_failed=True, expect_chunks=3)
            assert list(out) == list(ref)
            for k in ref:
                np.testing.assert_array_equal(out[k], ref[k])
    # the two writers' values agree to the summation order
    a = jrunner.load_chunks(js, allow_failed=True)
    b = load_chunks(ts, allow_failed=True)
    np.testing.assert_allclose(b["mean"], a["mean"], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(b["double"], a["double"])


def _wire_inputs():
    """float32 values that pin the rounding: ties to even, values just
    above and below ties, +-0, +-inf, both NaN signs, subnormals, the wire
    maxima, and random normals."""
    u = np.array([0x3F808000, 0x3F818000, 0x3F808001, 0x3F807FFF,
                  0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                  0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF,
                  0x00000001, 0x00400000, 0x7F7FFFFF, 0x477FE000,
                  0x477FF000, 0x38800000, 0x33800000, 0x33000001],
                 np.uint32)
    rng = np.random.default_rng(11)
    extra = rng.normal(size=3000).astype(np.float32) * \
        np.float32(10.0) ** rng.integers(-6, 5, 3000).astype(np.float32)
    return np.concatenate([u.view(np.float32), extra]).reshape(1, 3020, 1)


@pytest.mark.parametrize("name", ["float16", "bfloat16"])
def test_wire_rounding_matches_jax_bit_for_bit(name):
    """The host cast of the port's runner equals the JAX runner's
    (``astype(float16)``, ml_dtypes' ``bfloat16``), bit for bit, NaN signs
    included."""
    arr = _wire_inputs()
    if name == "float16":
        arr = arr[np.isnan(arr) | (np.abs(arr) <= 65504.0)]
    arr = np.ascontiguousarray(arr.reshape(1, -1, 1))
    with np.errstate(invalid="ignore"):     # ml_dtypes warns on NaN
        want = arr.astype(jnp.dtype(name)).view(np.uint16)    # the JAX runner
    out = torch.empty(arr.shape, dtype=torch.int16)
    R._to_wire(arr, getattr(torch, name), out)
    np.testing.assert_array_equal(out.numpy().view(np.uint16), want)
    # a read-only source (a memmap) goes through the same rounding
    ro = arr.copy()
    ro.flags.writeable = False
    R._to_wire(ro, getattr(torch, name), out)
    np.testing.assert_array_equal(out.numpy().view(np.uint16), want)


@pytest.mark.parametrize("name", ["float16", "bfloat16"])
def test_wire_upcast_input_matches_jax(rng, name):
    """What ``step`` receives through each runner's wire is equal, bit for
    bit where finite and NaN at the same cells."""
    snaps = rng.normal(size=(5, 6, 8)).astype(np.float32)
    snaps[1, 2, 3] = np.nan
    snaps[2, 0, 0] = -np.inf
    seen = {}

    def jstep(x):
        seen.setdefault("j", []).append(np.asarray(x))
        return {"m": jnp.nanmean(x, axis=(-2, -1))}

    def tstep(x):
        seen.setdefault("t", []).append(x.numpy().copy())
        return {"m": torch.nanmean(x, dim=(-2, -1))}

    jrunner.run_batched(jstep, snaps, batch=5, log=lambda s: None,
                        transfer_dtype=jnp.dtype(name))
    run_batched(tstep, snaps, batch=5, transfer_dtype=getattr(torch, name),
                **QUIET)
    a, b = seen["t"][0], seen["j"][0]
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(b)
    np.testing.assert_array_equal(a[m].view(np.uint32), b[m].view(np.uint32))


@pytest.mark.parametrize("name, fmax, tiny", [
    ("float16", 65504.0, 6.103515625e-05),
    ("bfloat16", 3.3895313892515355e38, 1.1754943508222875e-38)])
def test_wire_range_guard_thresholds_match_jax(name, fmax, tiny):
    """Both guards raise at the same two thresholds: above the wire dtype's
    max, and a whole chunk below its smallest normal."""
    jwire = jnp.dtype(name)
    twire = getattr(torch, name)
    f32 = np.float32
    for m, raises in ((fmax, False), (np.nextafter(f32(fmax), f32(np.inf)),
                                      True),
                      (tiny, False), (np.nextafter(f32(tiny), f32(0)), True),
                      (0.0, False)):
        arr = np.array([[[-m, m / 2]]], np.float32)
        for check, wire in ((jrunner._check_wire_range, jwire),
                            (R._check_wire_range, twire)):
            if raises:
                with pytest.raises(ValueError, match="cannot carry"):
                    check(arr, wire)
            else:
                check(arr, wire)
