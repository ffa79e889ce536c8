"""The port's ``--mesh``, ``run_batched(sharding=)``, mesh topology and
dry run, on gloo CPU ranks.

* ``python -m torch.distributed.run --standalone --nproc-per-node 4 -m
  xcontour_tpu_torch keff-lwa ... --device cpu --f64 --mesh {4x1,2x2,1x4}``
  against the JAX CLI unsharded (tests/test_cli.py:312-344's bounds:
  rtol 1e-12 on the contour-space keys, lwa at rtol 1e-9 with an atol of
  1e-9 of its largest magnitude), and a ``--stem`` run whose chunks the
  JAX ``runner.load_chunks`` reads; ``--mesh 1`` and ``1x1`` in process;
  the refusals with the JAX CLI's messages (those a torchrun rank meets
  before it joins the group, driven in process under a torchrun
  environment).
* ``run_batched(sharding=)`` on a 2x2 mesh (``rank_runner`` in
  tests/torch_parallel_cases.py): a step failing on one rank only under
  ``on_error='skip'`` ends with one ``.failed`` record naming that rank,
  a read failing once on one rank heals under ``retries=1``, ``validate``
  on rank 0 NaN-fills the in-memory chunk it rejects, a WireRangeError
  on one rank's block raises on every rank, each rank reads only its
  block and sends rank 0 only what it needs, and a run whose every chunk
  fails returns None after its records; the healthy chunks against the
  unsharded runner.  ``_LazyField[rows, :, cols]``, the CLI's read of a
  rank's block, against ``_LazyField[rows]``'s columns.
* ``hybrid_device_array`` on rank records, ``make_mesh``'s default x and
  its error (JAX tests/test_parallel.py:401-466), and
  ``dryrun_multichip(8)``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from xcontour_tpu import cli as jcli
from xcontour_tpu import runner as jrunner
from xcontour_tpu.utils.ncio import load_dataset, save_dataset
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import cli
from xcontour_tpu_torch import parallel as P
from xcontour_tpu_torch.parallel.dryrun import dryrun_multichip
from xcontour_tpu_torch.parallel.launch import run_ranks
from xcontour_tpu_torch.parallel.mesh import hybrid_device_array
from xcontour_tpu_torch.runner import load_chunks, run_batched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES_FILE = os.path.join(ROOT, "tests", "torch_parallel_cases.py")
_spec = importlib.util.spec_from_file_location("torch_parallel_cases",
                                               CASES_FILE)
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)

EXACT_KEYS = ("nkeff", "Yeq", "Leq2", "Lmin", "Q", "intArea", "intgrdS",
              "levels")
TORCHRUN_ENV = dict(RANK="0", WORLD_SIZE="4", LOCAL_RANK="0",
                    LOCAL_WORLD_SIZE="4")


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """(path, the JAX CLI's unsharded keff-lwa output): a (time=6, lat=16,
    lon=32) float32 archive, so batch 4 leaves a padded tail chunk."""
    d = tmp_path_factory.mktemp("mesh_cli")
    T, Ny, Nx = 6, 16, 32
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / Nx, Nx)
    rng = np.random.default_rng(5)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.25 * rng.standard_normal((T, Ny, Nx))).astype(np.float32)
    q[2, 4:7, 10:20] = np.nan
    path = str(d / "synth.nc")
    save_dataset(path, {"q": q, "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon,
                         "time": np.arange(T, dtype=np.int32)})
    plain = str(d / "plain.nc")
    assert jcli.main(["keff-lwa", path, "--var", "q", "-N", "21", "--batch",
                      "4", "--f64", "--out", plain, "--format", "nc3"]) == 0
    return path, load_dataset(plain)


def _base(path):
    return ["keff-lwa", path, "--var", "q", "-N", "21", "--batch", "4",
            "--f64", "--device", "cpu", "--format", "nc3"]


def _torchrun(argv, n=4):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    for k in TORCHRUN_ENV:
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "xcontour_tpu_torch", *argv],
        env=env, capture_output=True, text=True, timeout=240)


def _same_as_jax(got, want, what):
    for k in EXACT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=f"{what}:{k}")
    scale = np.nanmax(np.abs(want["lwa"]))
    np.testing.assert_allclose(got["lwa"], want["lwa"], rtol=1e-9,
                               atol=1e-9 * scale, err_msg=f"{what}:lwa")


@pytest.mark.parametrize("spec", ["4x1", "2x2", "1x4"])
def test_cli_mesh_under_torchrun_matches_the_jax_cli(archive, tmp_path, spec):
    path, want = archive
    out = str(tmp_path / f"mesh{spec}.nc")
    res = _torchrun(_base(path) + ["--mesh", spec, "--out", out])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    _same_as_jax(load_dataset(out), want, spec)


def test_cli_mesh_stem_loads_in_the_jax_runner(archive, tmp_path):
    """--stem over a 2x2 mesh: rank 0 writes the chunk files the JAX
    runner's load_chunks reads, equal to the JAX CLI's results."""
    path, want = archive
    stem = str(tmp_path / "ck" / "era")
    out = str(tmp_path / "stem.nc")
    res = _torchrun(_base(path) + ["--mesh", "2x2", "--stem", stem,
                                   "--out", out])
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    chunks = jrunner.load_chunks(stem, expect_chunks=2)
    assert chunks["lwa"].shape == want["lwa"].shape
    flat = dict(chunks, levels=chunks["contour"])
    _same_as_jax(flat, want, "stem")
    _same_as_jax(load_dataset(out), want, "stem out")


@pytest.mark.parametrize("spec", ["1", "1x1"])
def test_cli_mesh_of_one_runs_in_process(archive, tmp_path, spec):
    """Outside torchrun a mesh of one is a group of one in this process
    (the ring of one), equal to the run without --mesh."""
    path, want = archive
    plain, meshed = str(tmp_path / "plain.nc"), str(tmp_path / "one.nc")
    assert cli.main(_base(path) + ["--out", plain]) == 0
    assert cli.main(_base(path) + ["--mesh", spec, "--out", meshed]) == 0
    assert not dist.is_initialized()
    a, b = load_dataset(plain), load_dataset(meshed)
    for k in a.variables:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0,
                                   equal_nan=True, err_msg=k)
    _same_as_jax(b, want, spec)


@pytest.mark.parametrize("argv, env, match", [
    (["--mesh", "axb"], {}, "expected a device count N or BxX"),
    (["--mesh", "0"], {}, "counts must be >= 1"),
    (["--mesh", "64"], {}, "64 devices requested, 1 available.*torchrun"),
    (["--mesh", "8"], TORCHRUN_ENV, "8 devices requested, 4 available"),
    (["--mesh", "4", "--batch", "3"], TORCHRUN_ENV,
     "not divisible by the 2-way batch axis"),
    (["--mesh", "4x1", "--batch", "3"], TORCHRUN_ENV,
     "not divisible by the 4-way batch axis"),
    (["--mesh", "1x4"], TORCHRUN_ENV,
     "grid Nx 30 not divisible by the 4-way spatial axis"),
])
def test_cli_mesh_refusals(archive, tmp_path, monkeypatch, argv, env, match):
    """The JAX CLI's refusals, word for word, before any rank joins a
    group (a torchrun rank's environment set in this process)."""
    path, _ = archive
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = str(tmp_path / "refused.nc")
    if "grid Nx" in match:
        lat, lon = np.linspace(-60, 60, 8), np.linspace(0, 348, 30)
        path = str(tmp_path / "nx30.nc")
        save_dataset(path, {"q": np.ones((2, 8, 30), np.float32),
                            "latitude": lat, "longitude": lon},
                     {"q": ("time", "latitude", "longitude"),
                      "latitude": ("latitude",),
                      "longitude": ("longitude",)},
                     coords={"latitude": lat, "longitude": lon})
    # the last --batch given wins
    with pytest.raises(SystemExit, match=match):
        cli.main(_base(path) + argv + ["--out", out])
    assert not os.path.exists(out)
    assert not dist.is_initialized()


def test_sharded_runner_decides_together(tmp_path):
    """run_batched(sharding=) on a 2x2 mesh with failures on one rank
    only: no rank hangs, the records name the rank, and the healthy
    chunks equal the unsharded runner's."""
    d = str(tmp_path)
    run_ranks(CASES_FILE + ":rank_runner", 4, d, args=["2x2"], timeout=240)
    snaps = C.inputs()["tracer"][:7]
    ll = C.grids()[0]

    def step(t):
        return xt.pipeline.flatten_output(xt.keff_lwa_pipeline(t, ll, N=C.N))
    want = run_batched(step, snaps, batch=4, device="cpu",
                       log=lambda msg: None)

    def close(got, rows, what):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v[rows], rtol=1e-9,
                                       atol=1e-12 * np.nanmax(np.abs(v)),
                                       equal_nan=True, err_msg=f"{what}:{k}")

    stem = os.path.join(d, "skip")
    assert os.path.exists(stem + "_ck00000.npz")
    assert not os.path.exists(stem + "_ck00001.npz")
    with open(stem + "_ck00001.failed") as f:
        rec = json.load(f)
    assert rec["chunk"] == 1 and rec["nvalid"] == 3
    assert "rank 1" in rec["error"] and "injected step failure" in rec["error"]
    assert "rank 0" not in rec["error"]
    got = load_chunks(stem, allow_failed=True)
    close({k: v[:4] for k, v in got.items()}, slice(0, 4), "skip")
    assert np.isnan(got["lwa"][4:]).all()

    heal = load_chunks(os.path.join(d, "heal"), expect_chunks=2)
    assert not any(f.startswith("heal") and f.endswith(".failed")
                   for f in os.listdir(d))
    close(heal, slice(None), "heal")

    mem = dict(np.load(os.path.join(d, "memory.npz")))
    close({k: v[:4] for k, v in mem.items()}, slice(0, 4), "memory")
    assert np.isnan(mem["nkeff"][4:]).all() and mem["nkeff"].shape[0] == 7

    for r in range(4):
        with open(os.path.join(d, f"wire{r}.txt")) as f:
            msg = f.read()
        assert "rank 0" in msg and "float16" in msg, (r, msg)

    # each rank reads only its block: its 2 of a chunk's 4 snapshots (the
    # tail's last snapshot again past the end) and its 24 of 48 columns;
    # the lead gathers every key, the other rank of x index 0 sends the
    # replicated keys, the ranks of x index 1 send lwa only
    nkeys = len(want)
    for r in range(4):
        with open(os.path.join(d, f"runner{r}.json")) as f:
            info = json.load(f)
        ib, ix = info["coords"]
        assert info["reads"] == [
            [[2 * ib, 2 * ib + 2], [None, None], [24 * ix, 24 * ix + 24]],
            [[4 + min(2 * ib, 2), 4 + min(2 * ib + 2, 3)], [None, None],
             [24 * ix, 24 * ix + 24]]], (r, info["reads"])
        assert info["gathers"] == 2 * (nkeys if ix == 0 else 1), (r, info)
        # every chunk failed: the records are written and, as in the JAX
        # runner, run_batched returns None on every rank
        assert info["all_failed_returns"] == "None"
    for k in range(2):
        with open(os.path.join(d, f"none_ck{k:05d}.failed")) as f:
            assert json.load(f)["chunk"] == k


@pytest.mark.parametrize("vdims,isel,sdims,flip", [
    (("time", "lat", "lon"), {}, ("lat", "lon"), False),
    (("time", "lev", "lat", "lon"), {"lev": 1}, ("time", "lon"), True),
    (("time", "lev", "lat", "lon"), {}, ("lev", "lat"), False),
])
def test_lazy_field_reads_a_rank_s_columns(vdims, isel, sdims, flip):
    """``_LazyField[rows, :, cols]``, the read of a rank's block, is
    ``_LazyField[rows]``'s columns: --isel, --scale-var, the fluid mask
    and the latitude flip applied to those columns alone."""
    rng = np.random.default_rng(3)
    sizes = dict(time=5, lev=3, lat=6, lon=8)
    src = rng.normal(size=[sizes[d] for d in vdims])
    scale = rng.uniform(0.5, 2.0, size=[sizes[d] for d in sdims])
    mask = (rng.uniform(size=(6, 8)) > 0.2).astype(np.float32)
    f = cli._LazyField(src, vdims, isel, scale, sdims, mask, np.float32,
                       flip_y=flip)
    T = f.shape[0]
    for rows in (slice(0, 2), slice(1, T), slice(T - 1, T)):
        for cols in (slice(0, 4), slice(4, 8), slice(2, 6)):
            np.testing.assert_array_equal(f[rows, :, cols],
                                          f[rows][..., cols])
    with pytest.raises(TypeError):
        f[0:2, 1:3, 0:4]


class _Rec:
    def __init__(self, rank):
        self.rank = rank

    def __repr__(self):
        return f"r{self.rank}"


def test_hybrid_device_array_topology(monkeypatch):
    """JAX tests/test_parallel.py's placement on rank records: every x row
    within one node, nodes stacked along batch in node order."""
    recs = [_Rec(i) for i in range(8)]
    node = lambda d: d.rank // 4               # noqa: E731
    arr = hybrid_device_array(recs, x_size=4, slice_of=node)
    assert arr.shape == (2, 4)
    assert [d.rank for d in arr.ravel()] == list(range(8))
    arr2 = hybrid_device_array(recs, x_size=2, slice_of=node)
    assert arr2.shape == (4, 2)
    for row in arr2:
        assert len({node(d) for d in row}) == 1
    assert [node(d) for d in arr2[:, 0]] == [0, 0, 1, 1]
    shuffled = [recs[i] for i in (3, 4, 0, 7, 1, 5, 2, 6)]
    for row in hybrid_device_array(shuffled, x_size=2, slice_of=node):
        assert len({node(d) for d in row}) == 1
    # the default node is rank // LOCAL_WORLD_SIZE, ints as records
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    arr4 = hybrid_device_array(list(range(8)), x_size=2)
    assert arr4.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="uneven"):
        hybrid_device_array([_Rec(0), _Rec(1), _Rec(4)], x_size=1,
                            slice_of=node)
    with pytest.raises(ValueError, match="divisible"):
        hybrid_device_array(recs, x_size=3, slice_of=node)


def test_make_mesh_in_a_group_of_one(tmp_path):
    """make_mesh's default x (1 for one rank) and JAX's error for an x
    that does not divide the ranks; the hybrid mesh of one node is
    make_mesh."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert tuple(P.make_mesh().shape) == (1, 1)
        assert P.make_mesh().mesh_dim_names == ("batch", "x")
        with pytest.raises(ValueError, match="divisible"):
            P.make_mesh(x_size=8)
        assert tuple(P.make_hybrid_mesh().shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip():
    log = dryrun_multichip(8, timeout=240)
    assert "dryrun_multichip OK on 8 ranks" in log
