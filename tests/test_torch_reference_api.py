"""The port's reference namespace (``xcontour_tpu_torch.xcontour``), its
metric constructors, ``metrics.py``, ``pipeline.flatten_output`` /
``as_dataset`` and ``utils/ncio.py`` against the JAX package's on the same
seeded numpy inputs.

Tolerances: ``metrics.py`` and ``utils/ncio.py`` are numpy copies (the
latter reads classic files without h5py, where the JAX package's raises)
and the constructors' metric dicts are numpy, so they are held bit for bit
(``assert_array_equal``), as are the grids both packages build in float64
from the same float64 metrics.  ``as_dataset`` labels the same outputs with
the same dims, coordinates and attrs; the values are the pipelines' own,
held at 1e-10 of each variable's largest magnitude in float64 (the
pipeline suites' bound, tests/test_torch_keff_pipeline.py).  Round trips
through nc3 and nc4 are exact.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import metrics as jmetrics
from xcontour_tpu import pipeline as jpipe
from xcontour_tpu import xcontour as JX
from xcontour_tpu.utils import ncio as jncio
from xcontour_tpu.utils import synth
import xcontour_tpu_torch as xt
from xcontour_tpu_torch import metrics as tmetrics
from xcontour_tpu_torch import pipeline as tpipe
from xcontour_tpu_torch import xcontour as TX
from xcontour_tpu_torch.utils import ncio as tncio

CPU = "cpu"
LEAVES = ("ydef", "xdef", "dA", "dxF", "dyF", "mask")


def _same_grid(tg, jg):
    """The port's float64 grid equals the JAX package's leaf for leaf, with
    the same static fields."""
    for leaf in LEAVES:
        a, b = getattr(tg, leaf), getattr(jg, leaf)
        assert (a is None) == (b is None), leaf
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), leaf)
    assert tuple(tg.dim_names) == tuple(jg.dim_names)
    assert (tg.latlon, tg.periodic_x, tg.bc_y) == \
        (jg.latlon, jg.periodic_x, jg.bc_y)


def _same_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      k)


LATLON_CASES = {
    "global": (dict(latitude=np.linspace(-90.0, 90.0, 19),
                    longitude=np.arange(36) * 10.0), {}),
    "levels": (dict(lat=np.linspace(-60.0, 75.0, 12),
                    lon=np.arange(24) * 15.0,
                    lev=np.array([1000.0, 850.0, 500.0, 250.0])),
               dict(boundary={"Y": "reflect"})),
    "regional": (dict(YC=np.linspace(10.0, 50.0, 9),
                      XC=np.linspace(100.0, 160.0, 13)),
                 dict(boundary={"X": "fill", "Y": "fill"})),
    "named": (dict(y=np.linspace(-30.0, 30.0, 7), x=np.arange(10) * 36.0),
              dict(dims={"X": "x", "Y": "y"}, Rearth=6.4e6)),
}


@pytest.mark.parametrize("case", sorted(LATLON_CASES))
def test_add_latlon_metrics_matches_jax(case):
    dset, kw = LATLON_CASES[case]
    tm, tg = TX.add_latlon_metrics(dset, dtype=torch.float64, device=CPU,
                                   **kw)
    jm, jg = JX.add_latlon_metrics(dset, dtype=jnp.float64, **kw)
    _same_dict(tm, jm)
    _same_grid(tg, jg)


@pytest.mark.parametrize("case", ["global", "levels", "named"])
def test_add_latlon_metrics_old_matches_jax(case):
    dset, kw = LATLON_CASES[case]
    kw = {k: v for k, v in kw.items() if k in ("dims", "boundary")}
    tm, tg = TX.add_latlon_metrics_old(dset, dtype=torch.float64, device=CPU,
                                       **kw)
    jm, jg = JX.add_latlon_metrics_old(dset, dtype=jnp.float64, **kw)
    _same_dict(tm, jm)
    _same_grid(tg, jg)
    np.testing.assert_allclose(tm["rA"], tm["dyF"] * tm["dxF"], rtol=1e-12)


def _cgrid(ny=6, nx=8, nz=3):
    """A synthetic C-grid with distinct ramps per field
    (tests/test_metrics_staggered.py's)."""
    rng = np.random.default_rng(7)
    return {
        "XC": np.arange(nx) + 0.5, "YC": np.arange(ny) + 0.5,
        "Z": -(np.arange(nz) + 0.5),
        "dxC": 100.0 + 10.0 * np.arange(nx)[None, :] + np.arange(ny)[:, None],
        "dyC": 200.0 + 20.0 * np.arange(ny)[:, None] + np.arange(nx)[None, :],
        "dxG": 300.0 + 30.0 * np.arange(nx)[None, :] + np.arange(ny)[:, None],
        "dyG": 400.0 + 40.0 * np.arange(ny)[:, None] + np.arange(nx)[None, :],
        "drF": np.array([1.0, 2.0, 4.0]),
        "hFacC": rng.uniform(0.2, 1.0, (nz, ny, nx)),
        "hFacW": rng.uniform(0.2, 1.0, (nz, ny, nx)),
        "hFacS": rng.uniform(0.2, 1.0, (nz, ny, nx)),
        "rA": np.ones((ny, nx)),
    }


def _horizontal():
    ds = _cgrid()
    del ds["Z"], ds["drF"]
    for k in ("hFacC", "hFacW", "hFacS"):
        ds[k] = ds[k][0]
    return ds


def _horizontal_mask3d():
    maskC = np.ones((3, 6, 8))
    maskC[0, 2, 3] = 0.0
    maskC[1] = 0.0
    return {"YC": np.arange(6) + 0.5, "XC": np.arange(8) + 0.5,
            "rA": np.full((6, 8), 4.0), "dxF": np.full((6, 8), 2.0),
            "dyF": np.full((6, 8), 2.0), "maskC": maskC}


def _vertical_minimal():
    return {"Z": -(np.arange(5) + 0.5), "XC": np.arange(12) + 0.5,
            "drF": np.full(5, 2.0), "dxC": np.full(12, 3.0)}


def _vertical_mask():
    maskC = np.ones((4, 10))
    maskC[2:, :3] = 0.0
    return {"Z": -(np.arange(4) + 0.5), "XC": np.arange(10) + 0.5,
            "drF": np.full(4, 1.5), "dxF": np.full((4, 10), 2.0),
            "maskC": maskC}


MITGCM_CASES = {
    "lape": (lambda: synth.synth_internalwave(nt=1, nz=12, nx=32)[0], {}),
    "cgrid_xy": (_cgrid, dict(periodic="XY")),
    "cgrid_no_partial": (_cgrid, dict(partial_cell=False,
                                      boundary={"Y": "fill"})),
    "horizontal": (_horizontal, {}),
    "horizontal_mask3d": (_horizontal_mask3d, {}),
    "vertical_minimal": (_vertical_minimal, dict(periodic=None)),
    "vertical_mask": (_vertical_mask, {}),
}


@pytest.mark.parametrize("case", sorted(MITGCM_CASES))
def test_add_mitgcm_missing_metrics_matches_jax(case):
    make, kw = MITGCM_CASES[case]
    dset = make()
    tm, tg = TX.add_MITgcm_missing_metrics(dset, dtype=torch.float64,
                                           device=CPU, **kw)
    jm, jg = JX.add_MITgcm_missing_metrics(dset, dtype=jnp.float64, **kw)
    _same_dict(tm, jm)
    _same_grid(tg, jg)


@pytest.mark.parametrize("dset,match", [({"XC": np.arange(4) + 0.5},
                                         "Z\\+XC or YC\\+XC"),
                                        ({"YC": np.arange(6) + 0.5,
                                          "XC": np.arange(8) + 0.5}, "rA")])
def test_add_mitgcm_missing_metrics_raises_as_jax(dset, match):
    with pytest.raises(ValueError, match=match):
        JX.add_MITgcm_missing_metrics(dset)
    with pytest.raises(ValueError, match=match):
        TX.add_MITgcm_missing_metrics(dset, device=CPU)


@pytest.mark.parametrize("name", ["add_latlon_metrics",
                                     "add_latlon_metrics_old",
                                     "add_MITgcm_missing_metrics"])
def test_metric_constructors_default_to_the_card(name, monkeypatch):
    """No ``device`` means the card, as every grid constructor: without one
    the call raises and names ``device='cpu'``."""
    dset = (synth.synth_internalwave(nt=1, nz=6, nx=8)[0]
            if name == "add_MITgcm_missing_metrics"
            else LATLON_CASES["global"][0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(TX, name)(dset)
    _, grid = getattr(TX, name)(dset, device=CPU)
    assert grid.dA.device.type == "cpu" and grid.dA.dtype == torch.float32


@pytest.mark.parametrize("call", [
    lambda m: m.validate_boundary(None),
    lambda m: m.validate_boundary({"X": "fill", "Y": "reflect"}),
    lambda m: m.VALID_BOUNDARY,
    lambda m: m.interp_cgrid(np.array([1.0, 2.0, 4.0, 8.0]), 0, "left"),
    lambda m: m.interp_cgrid(np.arange(12.0).reshape(3, 4) ** 2, 1, "center",
                             periodic=True),
    lambda m: m.interp_cgrid(np.arange(12.0).reshape(3, 4) ** 2, 0, "left",
                             bc="fill"),
    lambda m: m.build_latlon_metrics(np.linspace(-88.0, 88.0, 23),
                                     np.arange(40) * 9.0, periodic_x=True),
    lambda m: m.build_latlon_metrics(np.linspace(20.0, 60.0, 9),
                                     np.linspace(0.0, 90.0, 10),
                                     periodic_x=False,
                                     boundary={"X": "fill"}, Rearth=6.0e6),
    lambda m: m.complete_mitgcm_metrics(_cgrid(), periodic="X"),
    lambda m: m.complete_mitgcm_metrics(_cgrid(), periodic=None,
                                        partial_cell=False),
], ids=["bc_default", "bc_given", "valid", "interp_left", "interp_periodic",
        "interp_fill", "latlon_global", "latlon_regional", "mitgcm_x",
        "mitgcm_none"])
def test_metrics_copy_is_bit_for_bit(call):
    got, want = call(tmetrics), call(jmetrics)
    if isinstance(want, dict):
        _same_dict(got, want)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("bad", [{"W": "fill"}, {"X": "periodic"}])
def test_validate_boundary_raises_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jmetrics.validate_boundary(bad)
    with pytest.raises(ValueError) as got:
        tmetrics.validate_boundary(bad)
    assert str(got.value) == str(want.value)


def test_namespace_reexports_and_constants():
    """Every symbol of the JAX reference namespace, minus the JAX-only
    ones, under the same name; the constants and autodetect lists equal."""
    names = ["Contour2D", "Table", "add_latlon_metrics",
             "add_latlon_metrics_old", "add_MITgcm_missing_metrics",
             "latitude_lengths_at", "equivalent_latitudes", "find_contour",
             "contour_length", "contour_area", "Rearth", "g", "omega",
             "deg2m", "dimXList", "dimYList", "dimZList", "build_latlon_metrics",
             "complete_mitgcm_metrics", "interp_cgrid", "validate_boundary",
             "from_latlon", "from_metrics", "Grid"]
    for n in names:
        assert hasattr(TX, n), n
        assert hasattr(JX, n), n
    for n in ("Rearth", "g", "omega", "dimXList", "dimYList", "dimZList"):
        assert getattr(TX, n) == getattr(JX, n), n
    assert TX.deg2m() == JX.deg2m() and TX.deg2m(6.0e6) == JX.deg2m(6.0e6)
    for n in ("Rearth", "g", "omega", "deg2m", "Contour2D", "lwa_masks_at",
              "add_latlon_metrics", "add_latlon_metrics_old",
              "add_MITgcm_missing_metrics", "contour_area", "contour_length",
              "compat"):
        assert hasattr(xt, n), n
    assert xt.Contour2D is TX.Contour2D
    with pytest.raises(ValueError, match="unknown dimension names"):
        TX.add_latlon_metrics({"a": np.arange(3.0), "b": np.arange(4.0)},
                              device=CPU)


def test_import_loads_no_optional_module():
    """Importing the port, its runner, CLI, profiling helpers and sharded
    package (with its rank-process entry module) imports none of h5py,
    scipy.io, matplotlib, pandas, ml_dtypes or JAX (a fresh interpreter:
    this one has them loaded)."""
    code = ("import sys, xcontour_tpu_torch, xcontour_tpu_torch.xcontour, "
            "xcontour_tpu_torch.runner, xcontour_tpu_torch.cli, "
            "xcontour_tpu_torch.utils.prof, xcontour_tpu_torch.parallel, "
            "xcontour_tpu_torch.parallel.launch, "
            "xcontour_tpu_torch.parallel.dryrun; "
            "bad = [m for m in ('h5py', 'scipy.io', 'scipy', 'matplotlib', "
            "'pandas', 'jax', 'ml_dtypes', 'xcontour_tpu') "
            "if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_pipeline_imports_nothing_of_parallel():
    """The steps' module loads no module of the sharded package: the
    sharded steps import the steps, never the other way (a fresh
    interpreter)."""
    code = ("import sys, xcontour_tpu_torch.pipeline; "
            "bad = sorted(m for m in sys.modules "
            "if m.startswith('xcontour_tpu_torch.parallel')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- labelled outputs -------------------------------------------------------

def _pipe_case():
    rng = np.random.default_rng(21)
    lat = np.linspace(-80.0, 80.0, 24)
    lon = np.linspace(0.0, 350.0, 36)
    tr = np.sin(np.deg2rad(lat))[None, :, None] \
        + 0.1 * rng.standard_normal((3, 24, 36))
    pre_y = np.linspace(-90.0, 90.0, 31)
    jg = JX.from_latlon(lat, lon, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, dtype=torch.float64, device=CPU)
    return jg, tg, tr, pre_y


def _outputs(name, pre):
    jg, tg, tr, pre_y = _pipe_case()
    if pre == "grid":
        pre_y = np.asarray(jg.ydef)
    elif pre == "none":
        pre_y = None
    kw = dict(N=12, increase=True, lt=True)
    calls = {
        "keff_lwa": lambda P, g, q, p: P.keff_lwa_pipeline(q, g, pre_y=p,
                                                           with_lwa2=True,
                                                           **kw),
        "keff": lambda P, g, q, p: P.keff_pipeline(q, g, pre_y=p, hist=True,
                                                   **kw),
        "clength": lambda P, g, q, p: P.clength_pipeline(q, g, **kw),
        "fractal": lambda P, g, q, p: P.fractal_pipeline(q, g, strides=(1, 2),
                                                         **kw),
    }
    fn = calls[name]
    jp = None if pre_y is None else jnp.asarray(pre_y)
    tp = None if pre_y is None else torch.as_tensor(pre_y)
    jout = fn(jpipe, jg, jnp.asarray(tr), jp)
    tout = fn(tpipe, tg, torch.as_tensor(tr), tp)
    return jg, tg, pre_y, jout, tout


DATASET_CASES = [("keff_lwa", "interp"), ("keff_lwa", "grid"),
                 ("keff", "interp"), ("clength", "none"), ("fractal", "none")]


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    if m.any():
        scale = max(np.abs(want[m]).max(), 1e-300)
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("name,pre", DATASET_CASES)
def test_flatten_output_matches_jax(name, pre):
    _, _, _, jout, tout = _outputs(name, pre)
    jf, tf = jpipe.flatten_output(jout), tpipe.flatten_output(tout)
    assert set(tf) == set(jf)
    for k in jf:
        assert isinstance(tf[k], torch.Tensor), k
        _close(tf[k].numpy(), jf[k])


def test_flatten_output_drops_tables():
    """A Table has ``lookup_coordinates`` and no shape: flatten_output drops
    it (the JAX package's tests/test_coverage_gaps.py pins the same)."""
    table = xt.Table(values=torch.arange(4.0), coords=torch.arange(4.0))
    assert hasattr(table, "lookup_coordinates")
    out = tpipe.flatten_output({"nkeff": torch.arange(4.0), "table": table,
                                "origin": {"Q": torch.ones(2)},
                                "interp": {"Lmin": torch.zeros(3)},
                                "extra": {"x": torch.ones(1)},
                                "label": "not an array"})
    assert set(out) == {"nkeff", "Q", "Lmin_at", "extra_x"}


@pytest.mark.parametrize("name,pre", DATASET_CASES)
def test_as_dataset_matches_jax(name, pre):
    jg, tg, pre_y, jout, tout = _outputs(name, pre)
    extra = {"time": np.array([1.0, 2.0, 3.0])}
    jds = jpipe.as_dataset(jout, jg, pre_y=pre_y, extra_coords=extra)
    tds = tpipe.as_dataset(tout, tg, pre_y=None if pre_y is None
                           else torch.as_tensor(pre_y), extra_coords=extra)
    assert tds.dims == jds.dims
    assert tds.attrs == jds.attrs
    assert set(tds.coords) == set(jds.coords)
    for k in jds.coords:
        np.testing.assert_array_equal(tds.coords[k], jds.coords[k], k)
    for k in jds.variables:
        assert isinstance(tds.variables[k], np.ndarray)
        _close(tds.variables[k], jds.variables[k])


@pytest.mark.parametrize("fmt", ["nc3", "nc4"])
@pytest.mark.parametrize("lazy", [False, True])
def test_dataset_round_trips(fmt, lazy, tmp_path):
    """The port's labelled dataset written with ``to_nc3``/``to_nc4`` and
    read back by both packages' ``load_dataset``: values equal, dims,
    coordinates and attrs as written."""
    pytest.importorskip("scipy" if fmt == "nc3" else "h5py")
    jg, tg, pre_y, _, tout = _outputs("keff_lwa", "interp")
    ds = tpipe.as_dataset(tout, tg, pre_y=torch.as_tensor(pre_y))
    path = str(tmp_path / f"out.{fmt}.nc")
    getattr(ds, f"to_{fmt}")(path)
    back = tncio.load_dataset(path, lazy=lazy)
    ref = jncio.load_dataset(path, lazy=lazy)
    assert set(back.variables) == set(ref.variables) >= set(ds.variables)
    for k in ds.variables:
        np.testing.assert_array_equal(np.asarray(back[k][...]), ds[k], k)
        np.testing.assert_array_equal(np.asarray(back[k][...]),
                                      np.asarray(ref[k][...]), k)
        assert back.dims_of(k) == ds.dims_of(k) == ref.dims_of(k), k
    for k in ds.coords:
        np.testing.assert_array_equal(np.asarray(back[k][...]), ds.coords[k])
    name = back.attrs["lwa"]["long_name"]
    name = name.decode() if isinstance(name, bytes) else name
    assert name == ds.attrs["lwa"]["long_name"]


@pytest.mark.parametrize("writer", ["save_dataset", "save_dataset_nc3"])
def test_ncio_writers_are_copies(writer, tmp_path):
    """The same call through either package's writer gives files that
    either reader loads to the same arrays, dims and attrs."""
    pytest.importorskip("h5py" if writer == "save_dataset" else "scipy")
    rng = np.random.default_rng(3)
    variables = {"a": rng.standard_normal((2, 5)),
                 "n": np.arange(5, dtype=np.int64),
                 "x": np.linspace(0.0, 1.0, 5)}
    dims = {"a": ("t", "x"), "n": ("x",), "x": ("x",)}
    coords = {"x": variables["x"]}
    attrs = {"a": {"units": "m"}}
    loads = []
    for mod in (tncio, jncio):
        path = str(tmp_path / f"{mod.__name__}.nc")
        getattr(mod, writer)(path, variables, dims, coords, attrs)
        loads.append((tncio.load_dataset(path), jncio.load_dataset(path)))
    first = loads[0][0]
    for got in (loads[0][1], loads[1][0], loads[1][1]):
        assert set(got.variables) == set(first.variables)
        for k in first.variables:
            np.testing.assert_array_equal(got[k], first[k])
            assert got.dims_of(k) == first.dims_of(k)
        assert got.attrs.keys() == first.attrs.keys()


@pytest.mark.parametrize("lazy", [False, True])
def test_nc3_round_trip_without_h5py(lazy, tmp_path, monkeypatch):
    """Where h5py is not installed (the GPU machine) the port's
    ``load_dataset`` reads a classic file through scipy alone; the JAX
    package's copy raises ModuleNotFoundError from its HDF5 reader there."""
    pytest.importorskip("scipy")
    _, tg, pre_y, _, tout = _outputs("keff_lwa", "interp")
    ds = tpipe.as_dataset(tout, tg, pre_y=torch.as_tensor(pre_y))
    path = str(tmp_path / "no_h5py.nc")
    monkeypatch.setitem(sys.modules, "h5py", None)
    ds.to_nc3(path)
    back = tncio.load_dataset(path, lazy=lazy)
    for k in ds.variables:
        np.testing.assert_array_equal(np.asarray(back[k][...]), ds[k], k)
        assert back.dims_of(k) == ds.dims_of(k), k
    bad = tmp_path / "garbage.nc"
    bad.write_bytes(b"not a netcdf file")
    with pytest.raises(ValueError, match="not a readable netCDF file"):
        tncio.load_dataset(str(bad))


def test_load_dataset_errors_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        tncio.load_dataset(str(tmp_path / "missing.nc"))
    bad = tmp_path / "garbage.nc"
    bad.write_bytes(b"not a netcdf file")
    with pytest.raises(ValueError, match="not a readable netCDF file"):
        tncio.load_dataset(str(bad))
