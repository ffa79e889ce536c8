"""The port's batch CLI (``python -m xcontour_tpu_torch ...``) on the CPU.

Drives ``cli.main()`` in-process (and once as a killed and resumed
subprocess) on small netCDF files written through ``utils.ncio``, both
HDF5/nc4 and classic nc3.  The tests of ``tests/test_cli.py`` (its
``--mesh`` test is tests/test_torch_parallel_cli.py's), the CLI's failure
injection, and the port's CLI
held against the JAX CLI on the same files for every subcommand: float64
within 1e-10 of each variable's largest magnitude with the same NaN
pattern, float32 within the port suite's float32 tolerances; the same
variables, dims, coordinates and attributes, and the same resume
fingerprint (apart from the port's ``device``).
Every run passes ``--device cpu``: the CLI's default is the card.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from xcontour_tpu import cli as jcli
from test_torch_geometry_pipeline import F32_TOL as GEOM_F32_TOL
from test_torch_pipeline import F32_TOL
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import cli
from xcontour_tpu_torch.diagnostics.local_length import local_contour_lengths
from xcontour_tpu_torch.utils.ncio import (load_dataset, save_dataset,
                                           save_dataset_nc3)
from xcontour_tpu_torch.utils.synth import synth_pv

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(dim_names=("latitude", "longitude"), device=CPU)


def run(argv):
    """The port's CLI on the CPU."""
    return cli.main(argv + ["--device", CPU])


@pytest.fixture
def synth_nc(tmp_path, rng):
    """A small (time=5, lat=24, lon=36) archive in netCDF-4 flavor."""
    pytest.importorskip("h5py")
    T, Ny, Nx = 5, 24, 36
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 350.0, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.25 * rng.standard_normal((T, Ny, Nx))).astype(np.float32)
    path = str(tmp_path / "synth.nc")
    save_dataset(path,
                 {"q": q, "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon,
                         "time": np.arange(T, dtype=np.int32)})
    return path, q, lat, lon


def _tq(q):
    return torch.from_numpy(np.ascontiguousarray(q))


# -- the JAX CLI's tests, ported --------------------------------------------

def test_cli_keff_matches_pipeline(synth_nc, tmp_path, capsys):
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "keff.nc")
    assert run(["keff", path, "--var", "q", "-N", "21", "--batch", "3",
                "--out", out]) == 0
    assert "wrote" in capsys.readouterr().out

    ds = load_dataset(out)
    assert ds.dims_of("nkeff") == ("time", "contour")
    assert ds["nkeff"].shape == (5, 21)

    grid = xt.from_latlon(lat, lon, **GRID)
    ref = xt.keff_pipeline(_tq(q), grid, N=21, increase=True, lt=True,
                           lmin="analytic")
    np.testing.assert_array_equal(ds["nkeff"], ref["origin"]["nkeff"].numpy())
    np.testing.assert_array_equal(ds["Yeq"], ref["origin"]["Yeq"].numpy())
    np.testing.assert_array_equal(ds["levels"],
                                  ref["origin"]["contour"].numpy())

    out2 = str(tmp_path / "keff_sub.nc")
    assert run(["keff", path, "--var", "q", "-N", "21", "--fields", "nkeff",
                "--out", out2]) == 0
    ds2 = load_dataset(out2)
    assert set(ds2.variables) == {"nkeff", "latitude", "longitude",
                                  "contour", "time"}
    assert ds2.dims_of("nkeff") == ("time", "contour")
    np.testing.assert_array_equal(ds2["nkeff"], ds["nkeff"])


def test_cli_autodetect_var_and_default_out(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    assert run(["clength", path, "-N", "11"]) == 0
    ds = load_dataset(str(tmp_path / "synth_clength.nc"))
    assert ds["lengths"].shape == (5, 11)
    assert np.isfinite(ds["lengths"]).any()


@pytest.mark.parametrize("batch", ["2", "32"])
def test_cli_unbatched_table_not_streamed(synth_nc, tmp_path, batch):
    """keff's A(Yeq) table is batch-independent: it is dropped before chunk
    streaming, not sliced along its bin axis."""
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "kt.nc")
    assert run(["keff", path, "--var", "q", "-N", "11", "--batch", batch,
                "--out", out]) == 0
    assert "table" not in load_dataset(out).variables


def test_cli_partial_dims_override(tmp_path, rng):
    pytest.importorskip("h5py")
    Ny, Nx = 12, 18
    ylat = np.linspace(-40.0, 40.0, Ny)
    lon = np.linspace(0.0, 340.0, Nx)
    q = rng.standard_normal((2, Ny, Nx)).astype(np.float32)
    path = str(tmp_path / "p.nc")
    save_dataset(path, {"q": q, "ylat": ylat, "longitude": lon},
                 {"q": ("time", "ylat", "longitude"),
                  "ylat": ("ylat",), "longitude": ("longitude",)},
                 coords={"ylat": ylat, "longitude": lon})
    out = str(tmp_path / "p_out.nc")
    assert run(["clength", path, "--var", "q", "-N", "7", "--dims", "Y=ylat",
                "--out", out]) == 0
    assert load_dataset(out).dims_of("lengths") == ("time", "contour")
    with pytest.raises(SystemExit, match="not in file"):
        run(["clength", path, "--var", "q", "--dims", "Y=nope"])
    with pytest.raises(SystemExit, match="expected X= or Y="):
        run(["clength", path, "--var", "q", "--dims", "W=ylat"])


def test_cli_lwa_nc3_roundtrip(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "lwa.nc")
    assert run(["lwa", path, "--var", "q", "-N", "21", "--format", "nc3",
                "--out", out, "--fields", "lwa,Q"]) == 0
    ds = load_dataset(out)
    assert set(ds.variables) >= {"lwa", "Q"}
    assert "Yeq" not in ds.variables
    assert ds.dims_of("lwa") == ("time", "latitude", "longitude")
    assert ds.dims_of("Q") == ("time", "latitude")
    grid = xt.from_latlon(lat, lon, **GRID)
    ref = xt.lwa_pipeline(_tq(q), grid, N=21, increase=True, lt=True)
    np.testing.assert_array_equal(ds["lwa"], ref["lwa"].numpy())


def test_cli_keff_lwa_interp_eq(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "kl.nc")
    assert run(["keff-lwa", path, "--var", "q", "-N", "21", "--interp-eq",
                "--out", out]) == 0
    ds = load_dataset(out)
    assert ds.dims_of("nkeff_at") == ("time", "latitude")
    assert ds["nkeff_at"].shape == (5, len(lat))


def test_cli_isel_and_lead_dims(tmp_path, rng):
    pytest.importorskip("h5py")
    T, L, Ny, Nx = 3, 2, 16, 24
    lat = np.linspace(-45.0, 45.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = rng.standard_normal((T, L, Ny, Nx)).astype(np.float32)
    path = str(tmp_path / "four_d.nc")
    save_dataset(path,
                 {"pv": q, "latitude": lat, "longitude": lon},
                 {"pv": ("time", "lev", "latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon,
                         "lev": np.asarray([850.0, 500.0]),
                         "time": np.arange(T, dtype=np.int32)})
    out = str(tmp_path / "k4.nc")
    assert run(["keff", path, "--var", "pv", "-N", "11", "--batch", "4",
                "--out", out]) == 0
    ds = load_dataset(out)
    assert ds.dims_of("nkeff") == ("time", "lev", "contour")
    assert ds["nkeff"].shape == (T, L, 11)
    np.testing.assert_array_equal(ds["lev"], [850.0, 500.0])

    out2 = str(tmp_path / "k4_sel.nc")
    assert run(["keff", path, "--var", "pv", "-N", "11", "--isel", "lev=1",
                "--out", out2]) == 0
    ds2 = load_dataset(out2)
    assert ds2["nkeff"].shape == (T, 11)
    np.testing.assert_array_equal(ds2["nkeff"], ds["nkeff"][:, 1])


def test_cli_resume_stem(synth_nc, tmp_path, capsys):
    path, q, lat, lon = synth_nc
    stem = str(tmp_path / "ck" / "run")
    (tmp_path / "ck").mkdir()
    out1 = str(tmp_path / "a.nc")
    assert run(["keff", path, "--var", "q", "-N", "11", "--batch", "2",
                "--stem", stem, "--out", out1]) == 0
    first = capsys.readouterr().out
    out2 = str(tmp_path / "b.nc")
    assert run(["keff", path, "--var", "q", "-N", "11", "--batch", "2",
                "--stem", stem, "--out", out2]) == 0
    second = capsys.readouterr().out
    assert second.count("skipped") == 3  # ceil(5/2) chunks all resumed
    a, b = load_dataset(out1), load_dataset(out2)
    for k in a.variables:
        np.testing.assert_array_equal(a[k], b[k])
    assert first
    with pytest.raises(SystemExit, match="different run"):
        run(["keff", path, "--var", "q", "-N", "21", "--batch", "2",
             "--stem", stem, "--out", str(tmp_path / "c.nc")])
    with pytest.raises(SystemExit, match="different run"):
        run(["keff", path, "--var", "q", "-N", "11", "--batch", "3",
             "--stem", stem, "--out", str(tmp_path / "c.nc")])


def test_cli_pipeline_option_flags(synth_nc, tmp_path):
    """--no-hist, --metric dy, and --with-lwa2 reach the pipeline kwargs."""
    path, q, lat, lon = synth_nc
    grid = xt.from_latlon(lat, lon, **GRID)
    out = str(tmp_path / "bh.nc")
    assert run(["keff", path, "--var", "q", "-N", "11", "--no-hist",
                "--out", out]) == 0
    ref = xt.keff_pipeline(_tq(q), grid, N=11, increase=True, lt=True,
                           hist=False, lmin="analytic")
    np.testing.assert_array_equal(load_dataset(out)["nkeff"],
                                  ref["origin"]["nkeff"].numpy())
    out = str(tmp_path / "dy.nc")
    assert run(["lwa", path, "--var", "q", "-N", "11", "--metric", "dy",
                "--out", out]) == 0
    ref = xt.lwa_pipeline(_tq(q), grid, N=11, increase=True, lt=True,
                          metric="dy")
    np.testing.assert_array_equal(load_dataset(out)["lwa"],
                                  ref["lwa"].numpy())
    out = str(tmp_path / "l2.nc")
    assert run(["keff-lwa", path, "--var", "q", "-N", "11", "--with-lwa2",
                "--out", out]) == 0
    ds = load_dataset(out)
    assert ds.dims_of("lwa2") == ("time", "latitude", "longitude")


def test_cli_scale_var_sigma_production(tmp_path, rng):
    pytest.importorskip("h5py")
    T, Ny, Nx = 3, 16, 24
    lat = np.linspace(-45.0, 45.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = rng.standard_normal((T, Ny, Nx)).astype(np.float32)
    sigma = (120.0 * (1.0 + 0.5 * np.cos(np.deg2rad(lat)) ** 2)
             ).astype(np.float32)
    path = str(tmp_path / "sig.nc")
    save_dataset(path,
                 {"q": q, "sigma": sigma, "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "sigma": ("latitude",),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon})
    out = str(tmp_path / "sig_lwa.nc")
    assert run(["lwa", path, "--var", "q", "--scale-var", "sigma", "-N",
                "11", "--out", out]) == 0
    grid = xt.from_latlon(lat, lon, **GRID)
    ref = xt.lwa_pipeline(_tq(q * sigma[None, :, None]), grid, N=11,
                          increase=True, lt=True)
    np.testing.assert_array_equal(load_dataset(out)["lwa"],
                                  ref["lwa"].numpy())
    with pytest.raises(SystemExit, match="--scale-var 'nope' not in file"):
        run(["lwa", path, "--var", "q", "--scale-var", "nope"])
    save_dataset(str(tmp_path / "bad.nc"),
                 {"q": q, "w": np.ones((2, Ny), np.float32),
                  "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "w": ("member", "latitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon,
                         "member": np.arange(2)})
    with pytest.raises(SystemExit, match="are not dims of"):
        run(["lwa", str(tmp_path / "bad.nc"), "--var", "q", "--scale-var",
             "w"])
    save_dataset(str(tmp_path / "edge.nc"),
                 {"q": q, "sige": np.ones(Ny + 1, np.float32),
                  "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "sige": ("latitude",),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon})
    with pytest.raises(SystemExit, match="has length 17, but 'q' has 16"):
        run(["lwa", str(tmp_path / "edge.nc"), "--var", "q", "--scale-var",
             "sige"])


def _masked_file(tmp_path, rng, nan_land):
    Ny, Nx = 16, 24
    lat = np.linspace(-45.0, 45.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.2 * rng.standard_normal((3, Ny, Nx))).astype(np.float32)
    land = np.zeros((Ny, Nx), bool)
    land[5:9, 3:8] = True
    if nan_land:
        q[:, land] = np.nan
    maskC = (~land).astype(np.float32)
    path = str(tmp_path / "ocean.nc")
    save_dataset(path,
                 {"q": q, "maskC": maskC, "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "maskC": ("latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon})
    return path, q, lat, lon, maskC


def test_cli_ocean_mask(tmp_path, rng):
    pytest.importorskip("h5py")
    path, q, lat, lon, maskC = _masked_file(tmp_path, rng, nan_land=True)
    outs = {}
    for name, extra in (("nan", ["--mask-from-nan"]),
                        ("var", ["--mask-var", "maskC"]), ("plain", [])):
        outs[name] = str(tmp_path / f"m_{name}.nc")
        assert run(["keff", path, "--var", "q", "-N", "11", *extra,
                    "--out", outs[name]]) == 0
    a, b, p = (load_dataset(outs[n]) for n in ("nan", "var", "plain"))
    np.testing.assert_array_equal(a["Yeq"], b["Yeq"])
    grid = xt.from_latlon(lat, lon, mask=maskC, **GRID)
    ref = xt.keff_pipeline(_tq(q), grid, N=11, increase=True, lt=True,
                           lmin="analytic")
    np.testing.assert_array_equal(a["Yeq"], ref["origin"]["Yeq"].numpy())
    assert not np.array_equal(a["Yeq"], p["Yeq"])
    with pytest.raises(SystemExit, match="exclusive"):
        run(["keff", path, "--var", "q", "--mask-var", "maskC",
             "--mask-from-nan"])
    with pytest.raises(SystemExit, match="--mask-var 'q' dims"):
        run(["keff", path, "--var", "q", "--mask-var", "q"])


def test_cli_mask_reaches_geometry_kernels(tmp_path, rng):
    pytest.importorskip("h5py")
    path, q, lat, lon, maskC = _masked_file(tmp_path, rng, nan_land=False)
    out_m, out_p = str(tmp_path / "cm.nc"), str(tmp_path / "cp.nc")
    assert run(["clength", path, "--var", "q", "-N", "9", "--mask-var",
                "maskC", "--out", out_m]) == 0
    assert run(["clength", path, "--var", "q", "-N", "9", "--out",
                out_p]) == 0
    Lm = load_dataset(out_m)["lengths"]
    Lp = load_dataset(out_p)["lengths"]
    fin = np.isfinite(Lm) & np.isfinite(Lp)
    assert fin.any()
    assert not np.allclose(Lm[fin], Lp[fin])
    assert (Lm[fin] <= Lp[fin] + 1e-3).all()
    grid = xt.from_latlon(lat, lon, mask=maskC, **GRID)
    qn = np.where(maskC[None] != 0, q, np.nan)
    ref = xt.clength_pipeline(_tq(qn), grid, N=9, increase=True, lt=True)
    np.testing.assert_array_equal(Lm, ref["lengths"].numpy())


def test_cli_local_length(synth_nc, tmp_path):
    """local-length runs K8's wrapper once a snapshot and labels the
    window-center dims; values match direct calls."""
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "ll.nc")
    assert run(["local-length", path, "--var", "q", "--window", "9",
                "--stride", "5", "--out", out]) == 0
    ds = load_dataset(out)
    assert ds.dims_of("llen") == ("time", "y_window", "x_window")
    latf = torch.as_tensor(lat, dtype=torch.float32)
    lonf = torch.as_tensor(lon, dtype=torch.float32)
    want = [local_contour_lengths(s, latf, lonf, window=9, stride=5,
                                  latlon=True) for s in _tq(q)]
    np.testing.assert_allclose(ds["llen"],
                               torch.stack([w[0] for w in want]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(ds["y_window"], want[0][1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(ds["x_window"], want[0][2].numpy(), rtol=1e-6)
    with pytest.raises(SystemExit, match="--window"):
        run(["local-length", path, "--var", "q", "--window", "99"])
    with pytest.raises(SystemExit, match="--stride"):
        run(["local-length", path, "--var", "q", "--window", "9",
             "--stride", "0"])


def test_cli_validate_finite(tmp_path, rng, capsys):
    pytest.importorskip("h5py")
    Ny, Nx = 12, 18
    lat = np.linspace(-40.0, 40.0, Ny)
    lon = np.linspace(0.0, 340.0, Nx)
    q = rng.standard_normal((4, Ny, Nx)).astype(np.float32)
    q[2] = np.nan
    path = str(tmp_path / "v.nc")
    save_dataset(path, {"q": q, "latitude": lat, "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon})
    out = str(tmp_path / "v_out.nc")
    assert run(["clength", path, "--var", "q", "-N", "7", "--batch", "1",
                "--validate", "finite", "--on-error", "skip",
                "--out", out]) == 0
    assert "FAILED" in capsys.readouterr().out
    L = load_dataset(out)["lengths"]
    assert not np.isfinite(L[2]).any()
    assert np.isfinite(L[[0, 1, 3]]).any()
    with pytest.raises(ValueError, match="entirely non-finite"):
        run(["clength", path, "--var", "q", "-N", "7", "--batch", "1",
             "--validate", "finite", "--out", str(tmp_path / "x.nc")])


def test_cli_fractal_and_gt_decrease_flags(tmp_path, rng):
    Ny, Nx = 16, 32
    lat = np.linspace(-45.0, 45.0, Ny)
    lon = np.linspace(0.0, 348.75, Nx)
    q = rng.standard_normal((2, Ny, Nx)).astype(np.float32)
    path = str(tmp_path / "f.nc")
    save_dataset_nc3(path, {"q": q},
                     {"q": ("time", "latitude", "longitude"),
                      "latitude": ("latitude",),
                      "longitude": ("longitude",)},
                     coords={"latitude": lat, "longitude": lon})
    out = str(tmp_path / "frac.nc")
    assert run(["fractal", path, "--var", "q", "-N", "11", "--strides",
                "1,2,4", "--decrease", "--gt", "--format", "nc3",
                "--out", out]) == 0
    ds = load_dataset(out)
    assert ds["D"].shape == (2, 11)
    grid = xt.from_latlon(lat, lon, **GRID)
    ref = xt.fractal_pipeline(_tq(q), grid, N=11, strides=(1, 2, 4),
                              increase=False, lt=False, box_counting=True)
    np.testing.assert_array_equal(ds["D"], ref["D"].numpy())


def test_cli_info_and_errors(synth_nc, tmp_path, capsys):
    path, q, lat, lon = synth_nc
    assert cli.main(["info", path]) == 0
    assert "q  dims=" in capsys.readouterr().out
    for argv, match in (
            (["keff", path, "--var", "nope"], "not in file"),
            (["keff", path, "--var", "q", "--isel", "lev=0"], "--isel dim"),
            (["keff", path, "--var", "q", "--isel", "time=surface"],
             "must be an integer"),
            (["keff", path, "--var", "q", "--isel", "time=9"],
             "out of range"),
            (["keff", path, "--var", "q", "--batch", "0"], "--batch must be"),
            (["fractal", path, "--var", "q", "--strides", "7"],
             "do not divide"),
            (["clength", path, "--var", "q", "--fields", "bogus", "--out",
              str(tmp_path / "x.nc")], "not among outputs")):
        with pytest.raises(SystemExit, match=match):
            run(argv)


def test_cli_lwa_part_cyclone_maps_to_upper(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    out = str(tmp_path / "lwa_cyc.nc")
    assert run(["lwa", path, "--var", "q", "-N", "9", "--batch", "5",
                "--part", "cyclone", "--out", out]) == 0
    grid = xt.from_latlon(lat, lon, **GRID)
    ref = xt.lwa_pipeline(_tq(q), grid, N=9, increase=True, lt=True,
                          part="upper")
    np.testing.assert_array_equal(load_dataset(out)["lwa"],
                                  ref["lwa"].numpy())
    stem = str(tmp_path / "ck")
    assert run(["lwa", path, "--var", "q", "-N", "9", "--batch", "5",
                "--part", "cyclone", "--stem", stem,
                "--out", str(tmp_path / "a.nc")]) == 0
    assert run(["lwa", path, "--var", "q", "-N", "9", "--batch", "5",
                "--part", "upper", "--stem", stem,
                "--out", str(tmp_path / "b.nc")]) == 0
    a = load_dataset(str(tmp_path / "a.nc"))
    b = load_dataset(str(tmp_path / "b.nc"))
    np.testing.assert_array_equal(a["lwa"], b["lwa"])


@pytest.mark.parametrize("part", ["upper", "lower", "cyclone", "anticyclone",
                                  "split"])
def test_cli_lwa_lin_rejects_part_split(synth_nc, part):
    path, *_ = synth_nc
    with pytest.raises(SystemExit, match="lwa-method lin"):
        run(["lwa", path, "--var", "q", "--part", part, "--lwa-method",
             "lin"])


def test_cli_stem_resume_with_isel_and_trailing_chunk_guard(synth_nc,
                                                            tmp_path):
    from xcontour_tpu_torch import runner
    path, q, lat, lon = synth_nc
    stem = str(tmp_path / "ck")
    argv = ["keff", path, "--var", "q", "-N", "9", "--batch", "2",
            "--isel", "time=0", "--dims", "X=longitude,Y=latitude",
            "--stem", stem, "--out", str(tmp_path / "a.nc")]
    assert run(argv) == 0
    assert run(argv[:-1] + [str(tmp_path / "b.nc")]) == 0
    a = load_dataset(str(tmp_path / "a.nc"))
    b = load_dataset(str(tmp_path / "b.nc"))
    np.testing.assert_array_equal(a["nkeff"], b["nkeff"])
    snaps = np.random.default_rng(3).normal(size=(6, 8, 12))
    stem2 = str(tmp_path / "tail")
    runner.run_batched(lambda x: {"m": x.mean(dim=(-2, -1))}, snaps,
                       batch=2, out_stem=stem2, log=lambda s: None,
                       device=CPU)
    os.remove(stem2 + "_ck00002.npz")
    with pytest.raises(RuntimeError, match="gap"):
        runner.load_chunks(stem2, expect_chunks=3)
    assert runner.load_chunks(stem2)["m"].shape[0] == 4


def test_cli_dims_z_rejected(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    with pytest.raises(SystemExit, match="use --isel"):
        run(["keff", path, "--var", "q", "--dims", "Z=time",
             "--out", str(tmp_path / "z.nc")])


def test_lazy_load_and_lazy_field_equivalence(synth_nc, tmp_path):
    path, q, lat, lon = synth_nc
    ds = load_dataset(path, lazy=True)
    assert not isinstance(ds["q"], np.ndarray)
    np.testing.assert_array_equal(np.asarray(ds["q"][1:3]), q[1:3])
    sigma = np.linspace(0.5, 1.5, lat.size).astype(np.float32)
    qn = q.copy()
    qn[:, 2, 3] = np.nan
    p2 = str(tmp_path / "lazy2.nc")
    save_dataset(p2, {"q": qn, "sigma": sigma, "latitude": lat,
                      "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "sigma": ("latitude",),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat, "longitude": lon,
                         "time": np.arange(5, dtype=np.int32)})
    args = argparse.Namespace(
        input=p2, var="q", dims=None, isel=["time=1"], scale_var="sigma",
        mask_var=None, mask_from_nan=True, batch=2, f64=False, device=CPU)
    tracer, grid, lead_names, lead_shape, _ = cli._load_field(args)
    assert type(tracer).__name__ == "_LazyField"
    assert tracer.shape == (1, lat.size, lon.size)
    want = (qn[1] * sigma[:, None]).astype(np.float32)
    want = np.where(np.isfinite(qn).all(axis=0), want, np.nan)
    np.testing.assert_array_equal(tracer[0:1][0], want)
    np.testing.assert_array_equal(grid.mask.numpy(),
                                  np.isfinite(qn).all(axis=0).astype(
                                      np.float32))


def test_lazy_nc3_memmap(tmp_path, rng):
    """A classic file loads lazily as a big-endian, read-only memmap;
    _LazyField hands the runner native float32 chunks, and the CLI streams
    it without the mmap-close warning."""
    Ny, Nx = 12, 18
    lat = np.linspace(-50.0, 50.0, Ny)
    lon = np.linspace(0.0, 340.0, Nx)
    q = rng.standard_normal((3, Ny, Nx)).astype(np.float32)
    path = str(tmp_path / "c.nc")
    save_dataset_nc3(path, {"q": q, "lat": lat, "lon": lon},
                     {"q": ("time", "lat", "lon"), "lat": ("lat",),
                      "lon": ("lon",)},
                     coords={"lat": lat, "lon": lon})
    ds = load_dataset(path, lazy=True)
    np.testing.assert_allclose(np.asarray(ds["q"][2:3]), q[2:3], rtol=1e-7)
    args = argparse.Namespace(
        input=path, var="q", dims=None, isel=None, scale_var=None,
        mask_var=None, mask_from_nan=False, batch=2, f64=False, device=CPU)
    tracer = cli._load_field(args)[0]
    assert tracer.src.dtype == np.dtype(">f4")
    assert not tracer.src.flags.writeable
    chunk = tracer[0:2]
    assert chunk.dtype == np.float32 and chunk.dtype.isnative
    np.testing.assert_array_equal(chunk, q[0:2])
    out = str(tmp_path / "c_out.nc")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert run(["clength", path, "--var", "q", "-N", "7", "--batch", "2",
                    "--format", "nc3", "--out", out]) == 0
    assert load_dataset(out)["lengths"].shape == (3, 7)


def test_cli_descending_latitude_normalized(synth_nc, tmp_path, capsys):
    path, q, lat, lon = synth_nc
    pd = str(tmp_path / "desc.nc")
    save_dataset(pd, {"q": q[:, ::-1].copy(), "latitude": lat[::-1].copy(),
                      "longitude": lon},
                 {"q": ("time", "latitude", "longitude"),
                  "latitude": ("latitude",), "longitude": ("longitude",)},
                 coords={"latitude": lat[::-1].copy(), "longitude": lon,
                         "time": np.arange(5, dtype=np.int32)})
    out_a, out_d = str(tmp_path / "asc_lwa.nc"), str(tmp_path / "desc_lwa.nc")
    assert run(["lwa", path, "--var", "q", "-N", "9", "--batch", "5",
                "--out", out_a]) == 0
    assert run(["lwa", pd, "--var", "q", "-N", "9", "--batch", "5",
                "--out", out_d]) == 0
    assert "normalized to ascending" in capsys.readouterr().out
    a, d = load_dataset(out_a), load_dataset(out_d)
    np.testing.assert_array_equal(np.asarray(d["latitude"]),
                                  np.asarray(a["latitude"]))
    np.testing.assert_array_equal(np.asarray(d["lwa"]), np.asarray(a["lwa"]))


def test_cli_transfer_flag(tmp_path, rng):
    """--transfer f16 streams end to end; results track the f32 run within
    the input-rounding bound, and a changed --transfer invalidates a resume
    stem."""
    pytest.importorskip("h5py")
    T, Ny, Nx = 4, 16, 24
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 345.0, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.2 * rng.standard_normal((T, Ny, Nx))).astype(np.float32)
    path = str(tmp_path / "t.nc")
    save_dataset(path, {"q": q}, {"q": ("time", "latitude", "longitude")},
                 coords={"latitude": lat, "longitude": lon,
                         "time": np.arange(T, dtype=np.int32)})
    outs = {}
    for mode in ("f32", "f16"):
        out = str(tmp_path / f"o_{mode}.nc")
        assert run(["keff", path, "--var", "q", "-N", "11", "--batch", "2",
                    "--transfer", mode, "--out", out]) == 0
        outs[mode] = load_dataset(out)
    np.testing.assert_allclose(outs["f16"]["Yeq"], outs["f32"]["Yeq"],
                               rtol=0, atol=1.0)
    a, b = outs["f32"]["nkeff"], outs["f16"]["nkeff"]
    fin = np.isfinite(a) & np.isfinite(b)
    assert fin.any() and not np.array_equal(a, b)
    rel = np.abs(b[fin] - a[fin]) / np.maximum(np.abs(a[fin]), 1e-6)
    assert np.median(rel) < 0.02 and rel.max() < 0.5
    stem = str(tmp_path / "ck")
    args = ["keff", path, "--var", "q", "-N", "11", "--batch", "2",
            "--stem", stem, "--out", str(tmp_path / "s1.nc")]
    assert run(args + ["--transfer", "f16"]) == 0
    with pytest.raises(SystemExit, match="different run"):
        run(args + ["--transfer", "bf16"])


def test_cli_rejects_garbage_input(tmp_path, rng):
    path = str(tmp_path / "garbage.nc")
    with open(path, "wb") as f:
        f.write(bytes(rng.integers(0, 256, 512, dtype=np.uint8)))
    with pytest.raises(SystemExit, match="cannot open"):
        cli.main(["info", path])
    for target in (path, str(tmp_path / "does_not_exist.nc")):
        with pytest.raises(SystemExit, match="cannot open"):
            run(["keff", target, "-N", "11", "--out", str(tmp_path / "o.nc")])


# -- the port's own contract ------------------------------------------------

def test_cli_needs_the_card_unless_told(synth_nc, tmp_path, monkeypatch):
    """Without a card and without --device cpu the CLI exits with its
    message; it never falls back to the CPU."""
    path, *_ = synth_nc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.nc")
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        cli.main(["keff", path, "--var", "q", "--out", out])
    assert not os.path.exists(out)


def test_cli_f64_on_the_card_exits(synth_nc, monkeypatch):
    """The kernels take float32: --f64 --device cuda exits naming --device
    cpu, before anything runs."""
    path, *_ = synth_nc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="--f64.*--device cpu"):
        cli.main(["keff", path, "--var", "q", "--f64"])


def test_cli_nc4_without_h5py_exits_before_any_chunk(synth_nc, tmp_path,
                                                     monkeypatch, capsys):
    import importlib.util
    path, *_ = synth_nc
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py"
                        else find_spec(name, *a))
    with pytest.raises(SystemExit, match="--format nc3"):
        run(["keff", path, "--var", "q", "--stem", str(tmp_path / "ck")])
    assert "[runner]" not in capsys.readouterr().out
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    out = str(tmp_path / "o.nc")
    assert run(["keff", path, "--var", "q", "--format", "nc3", "--out",
                out]) == 0


@pytest.mark.parametrize("fmt", ["nc3", "nc4"])
def test_cli_kill9_and_resume(tmp_path, rng, fmt):
    """SIGKILL ``python -m xcontour_tpu_torch`` mid-archive; a rerun with
    the same --stem resumes from the surviving chunks (left as they were)
    and the output equals an uninterrupted run."""
    if fmt == "nc4":
        pytest.importorskip("h5py")
    T, Ny, Nx = 30, 24, 36
    lat = np.linspace(-60.0, 60.0, Ny)
    lon = np.linspace(0.0, 350.0, Nx)
    q = (np.sin(np.deg2rad(lat))[None, :, None]
         + 0.25 * rng.standard_normal((T, Ny, Nx))).astype(np.float32)
    path = str(tmp_path / "kill.nc")
    writer = save_dataset if fmt == "nc4" else save_dataset_nc3
    writer(path, {"q": q}, {"q": ("time", "latitude", "longitude")},
           coords={"latitude": lat, "longitude": lon,
                   "time": np.arange(T, dtype=np.int32)})
    stem = str(tmp_path / "ck")
    out = str(tmp_path / "out.nc")
    args = ["keff", path, "--var", "q", "-N", "21", "--batch", "1",
            "--stem", stem, "--out", out, "--format", fmt, "--device", CPU]
    proc = subprocess.Popen([sys.executable, "-m", "xcontour_tpu_torch",
                             *args], cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 300
    killed = False
    try:
        while time.time() < deadline and proc.poll() is None:
            done = len([f for f in os.listdir(tmp_path)
                        if f.startswith("ck_ck") and f.endswith(".npz")])
            if 2 <= done < T:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.002)
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait(timeout=60)
    if killed:
        partial = [f for f in os.listdir(tmp_path) if f.startswith("ck_ck")]
        assert 0 < len(partial) < T
        assert not os.path.exists(out)
    else:
        assert proc.returncode == 0
        os.remove(stem + "_ck00007.npz")
        os.remove(stem + f"_ck{T - 1:05d}.npz")
        os.remove(out)
    kept = {f: (os.stat(tmp_path / f).st_mtime_ns,
                (tmp_path / f).read_bytes())
            for f in os.listdir(tmp_path)
            if f.startswith("ck_ck") and f.endswith(".npz")
            and not f.endswith(".tmp.npz")}
    assert cli.main(args) == 0
    for f, (mtime, blob) in kept.items():
        assert os.stat(tmp_path / f).st_mtime_ns == mtime
        assert (tmp_path / f).read_bytes() == blob
    got = load_dataset(out)
    out2 = str(tmp_path / "ref.nc")
    assert run(["keff", path, "--var", "q", "-N", "21", "--batch", "1",
                "--format", fmt, "--out", out2]) == 0
    ref = load_dataset(out2)
    np.testing.assert_array_equal(got["nkeff"], ref["nkeff"])
    np.testing.assert_array_equal(got["Yeq"], ref["Yeq"])


# -- parity with the JAX CLI ------------------------------------------------

COMMANDS = {
    "keff": ["-N", "12", "--interp-eq"],
    "lwa": ["-N", "12", "--metric", "dy"],
    "keff-lwa": ["-N", "12", "--with-lwa2", "--lmin", "frac"],
    "clength": ["-N", "12"],
    "local-length": ["--window", "9", "--stride", "5"],
    "fractal": ["-N", "12", "--strides", "1,2,4"],
}
GEOMETRY = ("clength", "local-length", "fractal")


def _archive(tmp_path, fmt):
    """synth_pv at 5 levels of 24x36, a below-ground NaN patch, latitude
    stored descending as ERA5 stores it."""
    v, _ = synth_pv(nlev=5, nlat=24, nlon=36, seed=3)
    pv = v["pv"].astype(np.float32)[:, ::-1].copy()
    pv[0, 3:6, 10:20] = np.nan
    lat = v["latitude"][::-1].copy()
    path = str(tmp_path / f"arch_{fmt}.nc")
    writer = save_dataset if fmt == "nc4" else save_dataset_nc3
    writer(path, {"pv": pv}, {"pv": ("level", "latitude", "longitude")},
           coords={"level": v["level"], "latitude": lat,
                   "longitude": v["longitude"]})
    return path


def _same_files(got, want, cmd, dtype):
    assert sorted(got.variables) == sorted(want.variables)
    tols = GEOM_F32_TOL if cmd in GEOMETRY else F32_TOL
    for k in want.variables:
        assert tuple(got.dims_of(k)) == tuple(want.dims_of(k)), k
        assert {a: str(v) for a, v in got.attrs.get(k, {}).items()} == \
            {a: str(v) for a, v in want.attrs.get(k, {}).items()}, k
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        m = np.isfinite(b)
        assert np.array_equal(m, np.isfinite(a)), k
        tol = 1e-10 if dtype == "f64" else tols.get(k[:-3] if k.endswith(
            "_at") else k, 2e-5)
        scale = np.abs(b[m]).max() if m.any() else 1.0
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=tol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("fmt", ["nc4", "nc3"])
@pytest.mark.parametrize("cmd", list(COMMANDS))
def test_cli_matches_the_jax_cli(tmp_path, cmd, fmt, dtype):
    """Each subcommand through both CLIs on the same file (an nc3 input
    streams as a lazy big-endian memmap through each _LazyField): the same
    file out, and the same resume fingerprint but for the port's
    'device'."""
    if fmt == "nc4":
        pytest.importorskip("h5py")
    path = _archive(tmp_path, fmt)
    base = [cmd, path, "--var", "pv", "--batch", "2", "--format", fmt,
            *COMMANDS[cmd]] + (["--f64"] if dtype == "f64" else [])
    jout, tout = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jstem, tstem = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcli.main(base + ["--out", jout, "--stem", jstem]) == 0
    assert run(base + ["--out", tout, "--stem", tstem]) == 0
    _same_files(load_dataset(tout), load_dataset(jout), cmd, dtype)
    with open(jstem + ".meta.json") as f:
        jfp = json.load(f)
    with open(tstem + ".meta.json") as f:
        tfp = json.load(f)
    assert set(tfp) - {"device"} == set(jfp)
    assert tfp["device"] == CPU
    assert {k: v for k, v in tfp.items() if k not in ("device", "input")} \
        == {k: v for k, v in jfp.items() if k != "input"}


def test_lazy_nc3_exit_leaves_stderr_clean(tmp_path):
    """An interpreter that exits with a lazy nc3 Dataset alive prints
    nothing (the finalizer once imported at exit: "Exception ignored in"),
    through ncio directly and through ``python -m xcontour_tpu_torch``."""
    path = str(tmp_path / "c.nc")
    save_dataset_nc3(path, {"q": np.ones((2, 4, 6), np.float32)},
                     {"q": ("time", "lat", "lon")},
                     coords={"lat": np.linspace(-30.0, 30.0, 4),
                             "lon": np.linspace(0.0, 300.0, 6)})
    code = ("import sys; from xcontour_tpu_torch.utils.ncio import "
            "load_dataset; ds = load_dataset(sys.argv[1], lazy=True); "
            "x = ds['q'][0:1]")
    for argv in (["-c", code, path],
                 ["-m", "xcontour_tpu_torch", "info", path],
                 ["-m", "xcontour_tpu_torch", "clength", path, "-N", "4",
                  "--device", CPU, "--format", "nc3", "--out",
                  str(tmp_path / "o.nc")]):
        res = subprocess.run([sys.executable, *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stderr == "", res.stderr
