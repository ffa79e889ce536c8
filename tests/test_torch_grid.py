"""The port's grid metrics and synthetic data against the JAX package.

The metric maths is float64 numpy in both packages, so in float64 every
leaf must agree bit for bit; ``synth_pv`` and ``synth_internalwave`` must
return identical arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xcontour_tpu import grid as jgrid
from xcontour_tpu.utils.synth import synth_internalwave as jax_synth_iw
from xcontour_tpu.utils.synth import synth_pv as jax_synth_pv
import xcontour_tpu_torch as xt
from xcontour_tpu_torch.utils.synth import synth_internalwave, synth_pv

# the grid constructors run on the card unless told otherwise
CPU = "cpu"

LEAVES = ("ydef", "xdef", "dA", "dxF", "dyF", "mask")
STATIC = ("dim_names", "latlon", "periodic_x", "bc_y")


def _assert_same_grid(jg, tg):
    for name in LEAVES:
        a, b = getattr(jg, name), getattr(tg, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for name in STATIC:
        assert tuple(np.atleast_1d(getattr(jg, name))) == \
            tuple(np.atleast_1d(getattr(tg, name))), name


def _constructor_cases():
    """constructor name -> (the port's call, a check of what it built): the
    grids against the JAX package's on the same small inputs, float64; a
    table carried across as numpy against its arrays."""
    lat, lon = np.linspace(-80.0, 80.0, 9), np.linspace(0.0, 350.0, 36)
    y, x = np.linspace(0.0, 8e5, 9), np.linspace(0.0, 1.4e6, 15)
    z = -np.linspace(5.0, 395.0, 9)
    hf = np.random.default_rng(2).uniform(0.3, 1.0, (9, 15))
    dA = np.random.default_rng(3).uniform(1.0, 2.0, (9, 15))
    f64 = dict(dtype=jnp.float64)
    jll = jgrid.from_latlon(lat, lon, **f64)
    leaves = {k: np.asarray(getattr(jll, k)) for k in LEAVES if k != "mask"}
    same = lambda jg: lambda tg: _assert_same_grid(jg, tg)
    values = np.sort(np.random.default_rng(4).uniform(0.0, 5.0, (2, 9)), -1)

    def same_table(t):
        np.testing.assert_array_equal(t.values.numpy(), values)
        np.testing.assert_array_equal(t.coords.numpy(), lat)
    return {
        "from_latlon": (lambda **kw: xt.from_latlon(lat, lon, **kw),
                        same(jll)),
        "from_cartesian": (lambda **kw: xt.from_cartesian(y, x, **kw),
                           same(jgrid.from_cartesian(y, x, **f64))),
        "from_xz": (lambda **kw: xt.from_xz(z, x, hf, **kw),
                    same(jgrid.from_xz(z, x, hf, **f64))),
        "from_metrics": (lambda **kw: xt.from_metrics(y, x, dA, **kw),
                         same(jgrid.from_metrics(y, x, dA, **f64))),
        "grid_from_numpy": (
            lambda **kw: xt.grid_from_numpy(
                **leaves, dim_names=jll.dim_names, latlon=True,
                periodic_x=jll.periodic_x, **kw),
            same(jll)),
        "Table.from_numpy": (
            lambda **kw: xt.Table.from_numpy(values, lat, **kw), same_table),
    }


@pytest.mark.parametrize("constructor", ["from_latlon", "from_cartesian",
                                         "from_xz", "from_metrics",
                                         "grid_from_numpy",
                                         "Table.from_numpy"])
def test_constructors_default_to_the_card(constructor, monkeypatch):
    """No ``device`` means the card: on a host without one the constructor
    raises and names ``device='cpu'`` rather than falling back; with
    ``device='cpu'`` it builds what it built before, bit for bit."""
    build, check = _constructor_cases()[constructor]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(dtype=torch.float64)
    built = build(dtype=torch.float64, device=CPU)
    leaf = built.values if constructor == "Table.from_numpy" else built.dA
    assert leaf.device.type == "cpu"
    check(built)


@pytest.mark.parametrize("nlat,nlon,masked", [(41, 64, False), (64, 128, True),
                                              (721 // 8 + 1, 1440 // 8, False)])
def test_from_latlon_matches_jax_bitwise(nlat, nlon, masked):
    lat = np.linspace(-90.0, 90.0, nlat)
    lon = np.linspace(0.0, 360.0 - 360.0 / nlon, nlon)
    mask = None
    if masked:
        mask = np.ones((nlat, nlon))
        mask[nlat // 3: nlat // 2, nlon // 4: nlon // 2] = 0.0
    jg = jgrid.from_latlon(lat, lon, mask=mask, dtype=jnp.float64)
    tg = xt.from_latlon(lat, lon, mask=mask, dtype=torch.float64, device=CPU)
    _assert_same_grid(jg, tg)
    assert tg.periodic_x and tg.latlon and tg.shape == (nlat, nlon)


def test_grid_from_numpy_carries_a_jax_grid():
    lat = np.linspace(-80.0, 80.0, 40)
    lon = np.linspace(0.0, 355.0, 72)
    jg = jgrid.from_latlon(lat, lon, dtype=jnp.float64, bc_y="reflect")
    leaves = {k: None if getattr(jg, k) is None else np.asarray(getattr(jg, k))
              for k in LEAVES}
    tg = xt.grid_from_numpy(**leaves, dim_names=jg.dim_names,
                            latlon=jg.latlon, periodic_x=jg.periodic_x,
                            bc_y=jg.bc_y, device=CPU)
    _assert_same_grid(jg, tg)
    _assert_same_grid(jg, xt.from_latlon(lat, lon, dtype=torch.float64,
                                         bc_y="reflect", device=CPU))
    # f32 cast of the carried grid equals the port's own f32 grid
    t32 = xt.grid_from_numpy(**leaves, latlon=True, periodic_x=True,
                             dtype=torch.float32, device=CPU)
    own = xt.from_latlon(lat, lon, dtype=torch.float32, device=CPU)
    for name in ("ydef", "xdef", "dA", "dxF", "dyF"):
        assert torch.equal(getattr(t32, name), getattr(own, name)), name


def test_cartesian_and_metrics_builders_match_jax():
    y = np.linspace(0.0, 5e5, 24)
    x = np.linspace(0.0, 8e5, 40)
    _assert_same_grid(jgrid.from_cartesian(y, x, periodic_x=True,
                                           dtype=jnp.float64),
                      xt.from_cartesian(y, x, periodic_x=True,
                                        dtype=torch.float64, device=CPU))
    dA = np.random.default_rng(3).uniform(1.0, 2.0, (24, 40))
    dxF = np.linspace(1.0, 2.0, 40)           # 1-D line element, broadcast
    _assert_same_grid(jgrid.from_metrics(y, x, dA, dxF=dxF, dtype=jnp.float64),
                      xt.from_metrics(y, x, dA, dxF=dxF, dtype=torch.float64,
                                      device=CPU))


def test_grid_to_and_helpers():
    tg = xt.from_latlon(np.linspace(-90, 90, 19), np.arange(0, 360, 20.0),
                        dtype=torch.float64, device=CPU)
    moved = tg.to("cpu")
    assert dataclasses.is_dataclass(moved) and moved.periodic_x
    with pytest.raises(dataclasses.FrozenInstanceError):
        tg.latlon = False
    np.testing.assert_allclose(float(tg.dA.sum()), 4 * np.pi * 6371200.0 ** 2,
                               rtol=1e-12)
    lats = np.linspace(-90, 90, 13)
    np.testing.assert_allclose(
        xt.latitude_lengths_at(torch.as_tensor(lats)).numpy(),
        np.asarray(jgrid.latitude_lengths_at(jnp.asarray(lats))), rtol=1e-15)
    areas = np.linspace(0.0, 5.1e14, 11)
    np.testing.assert_allclose(
        xt.equivalent_latitudes(torch.as_tensor(areas)).numpy(),
        np.asarray(jgrid.equivalent_latitudes(jnp.asarray(areas))),
        rtol=1e-13, atol=1e-12)


def test_descending_latitude_warns():
    with pytest.warns(UserWarning, match="DESCENDING"):
        xt.from_latlon(np.linspace(90, -90, 7), np.arange(0, 360, 45.0),
                       device=CPU)


@pytest.mark.parametrize("nlev,nlat,nlon,seed", [(3, 41, 64, 1), (15, 25, 48, 7)])
def test_synth_pv_matches_jax_package(nlev, nlat, nlon, seed):
    got, dims = synth_pv(nlev=nlev, nlat=nlat, nlon=nlon, seed=seed)
    want, wdims = jax_synth_pv(nlev=nlev, nlat=nlat, nlon=nlon, seed=seed)
    assert dims == wdims and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("nt,nz,nx,seed", [(3, 100, 448, 2), (5, 24, 40, 9)])
def test_synth_internalwave_matches_jax_package(nt, nz, nx, seed):
    got, dims = synth_internalwave(nt=nt, nz=nz, nx=nx, seed=seed)
    want, wdims = jax_synth_iw(nt=nt, nz=nz, nx=nx, seed=seed)
    assert dims == wdims and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("partial,periodic", [(True, True), (False, False)])
def test_from_xz_matches_jax_bitwise(partial, periodic):
    """The MITgcm x-z plane: decreasing Z, partial bottom cells (hFacC in
    (0, 1)) and the fluid mask, in float64 bit for bit; float32 equals the
    port's own cast."""
    v, _ = synth_internalwave(nt=1, nz=30, nx=56, seed=4)
    hf = v["hFacC"] if partial else None
    mask = v["maskC"] if partial else None
    kw = dict(hFacC=hf, mask=mask, periodic_x=periodic)
    jg = jgrid.from_xz(v["Z"], v["XC"], dtype=jnp.float64, **kw)
    tg = xt.from_xz(v["Z"], v["XC"], dtype=torch.float64, **kw, device=CPU)
    _assert_same_grid(jg, tg)
    assert tg.dim_names == ("Z", "XC") and not tg.latlon
    assert bool(tg.ydef[0] > tg.ydef[-1])              # z decreases
    if partial:
        frac = (v["hFacC"] > 0) & (v["hFacC"] < 1)
        assert frac.any()
        np.testing.assert_allclose(
            tg.dA.numpy(), v["yA"].astype(np.float64), rtol=1e-5)
    t32 = xt.from_xz(v["Z"], v["XC"], dtype=torch.float32, **kw, device=CPU)
    for name in ("ydef", "xdef", "dA", "dxF", "dyF"):
        assert torch.equal(getattr(t32, name), getattr(tg, name).float()), name
