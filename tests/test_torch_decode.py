"""The archive decode (``kernels.decode``, ``csrc/decode.cu``) and the
runner's raw path.

A source that offers its raw planes (the CLI's ``_LazyField`` over an nc3
memmap or an ndarray) crosses the runner's read thread as the file's bytes,
and the decode makes the snapshots: byte order, latitude flip, cast and
fluid mask.  On the CPU: the decode's plain version on ``raw_into``'s bytes
against ``_LazyField.__getitem__``, bit for bit, over file byte order and
dtype, run dtype, latitude order, mask and lead layouts, with no kernel
launch counted; which CLI runs take the raw path, counted by the runner's
calls of ``decode_planes``, and that a raw run writes the host path's
file.  On the card (``-m cuda``; on the
card's machine, which has no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_decode.py``): the kernel against the plain version,
vector and one-cell-a-lane layouts, and a CLI chunk against the host
path's.
"""

import numpy as np
import pytest
import torch

from xcontour_tpu_torch import cli, runner
from xcontour_tpu_torch.kernels import decode
from xcontour_tpu_torch.utils.ncio import (load_dataset, save_dataset,
                                           save_dataset_nc3)

SIZES = dict(time=5, lev=3, lat=6, lon=8)
LAYOUTS = {
    "one_lead": (("time", "lat", "lon"), {}),
    "two_lead": (("time", "lev", "lat", "lon"), {}),
    "isel": (("time", "lev", "lat", "lon"), {"lev": 1}),
}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.itemsize == 4 else np.uint64)


def _field(layout, file_dtype, run_dtype, flip, masked, seed):
    """A _LazyField over an ndarray of ``file_dtype`` with NaNs in it."""
    vdims, isel = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    src = rng.normal(size=[SIZES[d] for d in vdims]).astype(file_dtype)
    src.reshape(-1)[::7] = np.nan
    mask = ((rng.uniform(size=(SIZES["lat"], SIZES["lon"])) > 0.3)
            .astype(run_dtype) if masked else None)
    return cli._LazyField(src, vdims, isel, None, (), mask, run_dtype,
                          flip_y=flip)


def _raw(f, rows):
    n = len(range(*rows.indices(f.shape[0])))
    itemsize = f.raw_planes().file_dtype.itemsize
    out = np.empty((n, f.shape[1], f.shape[2] * itemsize), np.uint8)
    f.raw_into(rows, out)
    return out


def _mask(planes, device="cpu"):
    return None if planes.mask is None else \
        torch.from_numpy(planes.mask).to(device)


@pytest.fixture
def decodes(monkeypatch):
    """The number of ``decode_planes`` calls (the chunks that took the raw
    path), as a one-element list."""
    calls, real = [0], decode.decode_planes

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    monkeypatch.setattr(decode, "decode_planes", counted)
    return calls


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("flip", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("run_dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("file_dtype", [">f4", "<f4", ">f8", "<f8"])
def test_plain_decode_matches_lazy_field(file_dtype, run_dtype, flip,
                                         masked, layout):
    """The plain decode of ``raw_into``'s bytes is ``field[rows]`` bit for
    bit (NaNs of the data and of the mask included), for whole, shifted
    and one-snapshot chunks; on the CPU no kernel launch is counted."""
    f = _field(layout, file_dtype, run_dtype, flip, masked,
               seed=len(file_dtype) + 7 * flip + 13 * masked)
    planes = f.raw_planes()
    assert planes is not None and planes.flip == flip
    T = f.shape[0]
    before = decode.KERNEL.launches
    for rows in (slice(0, T), slice(1, T - 1), slice(T - 1, T)):
        got = decode.decode_planes(torch.from_numpy(_raw(f, rows)), planes,
                                   _mask(planes)).numpy()
        want = f[rows]
        assert got.dtype == want.dtype == np.dtype(run_dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert decode.KERNEL.launches == before


def test_raw_into_copies_file_planes_unchanged():
    """``raw_into`` copies the file's planes as they are stored: under
    --isel a chunk is a run of planes a lead step apart, each copied
    unchanged; a plain chunk is the file's bytes in one piece."""
    src = np.arange(2 * 3 * 2 * 4, dtype=">f8").reshape(2, 3, 2, 4)
    f = cli._LazyField(src, ("time", "lev", "lat", "lon"), {"lev": 2},
                       None, (), None, np.float32)
    np.testing.assert_array_equal(_raw(f, slice(0, 2)),
                                  src[:, 2].view(np.uint8))
    g = cli._LazyField(src, ("time", "lev", "lat", "lon"), {}, None, (),
                       None, np.float32)
    np.testing.assert_array_equal(_raw(g, slice(1, 5)).reshape(-1),
                                  src.reshape(-1, 2, 4)[1:5]
                                  .view(np.uint8).reshape(-1))


def test_raw_planes_offered_only_where_the_source_allows():
    """No raw planes under --scale-var, from a non-contiguous or non-numpy
    source, or of a dtype the decode does not take."""
    src = np.zeros((3, 4, 6), ">f4")
    dims = ("time", "lat", "lon")
    assert cli._LazyField(src, dims, {}, None, (), None,
                          np.float32).raw_planes() is not None
    assert cli._LazyField(src, dims, {}, np.ones(3), ("time",), None,
                          np.float32).raw_planes() is None
    assert cli._LazyField(src[:, :, ::2], dims, {}, None, (), None,
                          np.float32).raw_planes() is None
    assert cli._LazyField(src.astype(np.int16), dims, {}, None, (), None,
                          np.float32).raw_planes() is None

    class Wrapped:      # an object that slices like an array (h5py-like)
        shape, dtype = src.shape, src.dtype

        def __getitem__(self, key):
            return src[key]
    assert cli._LazyField(Wrapped(), dims, {}, None, (), None,
                          np.float32).raw_planes() is None


def test_decode_refuses_what_it_cannot_decode():
    planes = decode.Planes(np.dtype(">f4"), False, None, np.dtype("f4"))
    with pytest.raises(ValueError, match="uint8"):
        decode.decode_planes(torch.zeros(2, 3, 10, dtype=torch.uint8), planes)
    with pytest.raises(ValueError, match="mask"):
        decode.decode_planes(torch.zeros(2, 3, 8, dtype=torch.uint8), planes,
                             torch.ones(2, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="mask"):
        decode.decode_planes(torch.zeros(2, 3, 8, dtype=torch.uint8), planes,
                             torch.ones(3, 2))
    with pytest.raises(TypeError, match="file dtype"):
        decode.decode_planes(torch.zeros(2, 3, 8, dtype=torch.uint8),
                             decode.Planes(np.dtype("<i4"), False, None,
                                           np.dtype("f4")))


# -- which runs take the raw path -------------------------------------------

def _archive(tmp_path, nc4=False):
    """pv(time=3, level=2, latitude=12, longitude=16), latitude stored
    descending as ERA5 stores it, and a sigma(level) to scale by."""
    rng = np.random.default_rng(11)
    lat = np.linspace(60.0, -60.0, 12)
    lon = np.linspace(0.0, 337.5, 16)
    pv = (np.sin(np.deg2rad(lat))[None, None, :, None]
          + 0.3 * rng.standard_normal((3, 2, 12, 16))).astype(np.float32)
    variables = {"pv": pv, "sigma": np.array([1.0, 2.0], np.float32),
                 "latitude": lat, "longitude": lon}
    dims = {"pv": ("time", "level", "latitude", "longitude"),
            "sigma": ("level",), "latitude": ("latitude",),
            "longitude": ("longitude",)}
    coords = {"latitude": lat, "longitude": lon,
              "level": np.array([320, 330], np.int32),
              "time": np.arange(3, dtype=np.int32)}
    path = str(tmp_path / ("a.h5.nc" if nc4 else "a.nc"))
    (save_dataset if nc4 else save_dataset_nc3)(path, variables, dims,
                                                 coords=coords)
    return path


def _keff(decodes, path, out, extra=()):
    before = decodes[0]
    assert cli.main(["keff", path, "--var", "pv", "-N", "9", "--batch", "4",
                     "--format", "nc3", "--out", out, "--device", "cpu",
                     *extra]) == 0
    return decodes[0] - before


def test_cli_takes_the_raw_path_once_a_chunk(tmp_path, monkeypatch,
                                             decodes):
    """``keff`` on a two-lead-dim nc3 archive with a descending latitude
    decodes each of its 2 chunks once, and writes the file the host path
    writes, bit for bit."""
    path = _archive(tmp_path)
    raw_out, host_out = str(tmp_path / "raw.nc"), str(tmp_path / "host.nc")
    assert _keff(decodes, path, raw_out) == 2
    monkeypatch.setattr(cli._LazyField, "raw_planes", lambda self: None)
    assert _keff(decodes, path, host_out) == 0
    a, b = load_dataset(raw_out), load_dataset(host_out)
    assert sorted(a.variables) == sorted(b.variables)
    for k in a.variables:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fallback", ["nc4", "scale_var", "transfer_bf16",
                                      "mesh"])
def test_cli_fallbacks_take_the_host_path(tmp_path, fallback, decodes):
    """An nc4 input (h5py datasets), --scale-var, --transfer bf16 and a
    sharded run (which reads column blocks, here a mesh of one) read
    through ``field[rows]`` and launch no decode."""
    if fallback == "nc4":
        pytest.importorskip("h5py")
    path = _archive(tmp_path, nc4=fallback == "nc4")
    extra = {"nc4": (), "scale_var": ("--scale-var", "sigma"),
             "transfer_bf16": ("--transfer", "bf16"),
             "mesh": ("--mesh", "1")}[fallback]
    assert _keff(decodes, path, str(tmp_path / "out.nc"), extra) == 0


def test_run_batched_raw_path_with_mask_and_f64(tmp_path, decodes):
    """``run_batched`` given a masked, flipped big-endian field in float64
    hands the step the chunks ``field[rows]`` gives, and decodes once a
    chunk."""
    f = _field("isel", ">f4", np.float64, True, True, seed=3)
    seen = []

    def step(x):
        seen.append(x.numpy().copy())
        return {"s": x.sum((1, 2))}
    out = runner.run_batched(step, f, batch=2, device="cpu",
                             log=lambda s: None)
    assert decodes[0] == 3
    for k, got in enumerate(seen):
        np.testing.assert_array_equal(_bits(got), _bits(f[2 * k:2 * k + 2]))
    assert out["s"].shape == (5,)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """NaN at the same cells and every other cell bit for bit (a NaN's
    payload may differ: the card's float64-to-float32 cast makes its
    canonical NaN)."""
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (_bits(np.where(nan, 0, a)) == _bits(np.where(nan, 0, b)))
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("flip", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("run_dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("file_dtype", [">f4", "<f4", ">f8", "<f8"])
def test_kernel_matches_host_path_on_the_card(cuda, file_dtype, run_dtype,
                                              flip, masked):
    """The kernel on the card against ``field[rows]``: vectors at an ERA5
    row (Nx 1440), one cell a lane at an odd Nx and at an unaligned raw
    view."""
    for Ny, Nx, offset in ((13, 1440, 0), (7, 181, 0), (9, 24, 4)):
        rng = np.random.default_rng(Ny)
        src = rng.normal(size=(5, Ny, Nx)).astype(file_dtype)
        src.reshape(-1)[::11] = np.nan
        mask = ((rng.uniform(size=(Ny, Nx)) > 0.3).astype(run_dtype)
                if masked else None)
        f = cli._LazyField(src, ("time", "lat", "lon"), {}, None, (), mask,
                           run_dtype, flip_y=flip)
        planes = f.raw_planes()
        raw = torch.from_numpy(_raw(f, slice(0, 5)))
        dev = torch.zeros(raw.numel() + offset, dtype=torch.uint8,
                          device=cuda)[offset:].view(raw.shape)
        dev.copy_(raw)
        before = decode.KERNEL.launches
        got = decode.decode_planes(dev, planes, _mask(planes, cuda))
        assert decode.KERNEL.launches == before + 1
        assert _same_values(got.cpu().numpy(), f[0:5]), (Ny, Nx, offset)
