"""Minimal self-contained NetCDF I/O.

A copy of ``xcontour_tpu/utils/ncio.py`` (NumPy, with h5py and scipy
imported lazily inside the readers and writers that need them), but for one
change: :func:`load_dataset` reads a classic netCDF-3 file where h5py is not
installed (the JAX package's copy raises ``ModuleNotFoundError`` there).

The reference library leans on xarray for file handling; that dependency does
not exist in this environment, so this module provides the small surface the
framework needs:

* :func:`load_dataset` reads either netCDF-4 (HDF5, via h5py) or classic
  netCDF-3 (via scipy.io) files into a plain ``dict`` of numpy arrays plus a
  dims mapping — enough for every bundled / synthesized fixture.
* :func:`save_dataset` writes an HDF5/netCDF-4-flavoured file via h5py so
  pipeline outputs can round-trip.

No xarray semantics are emulated beyond named dimensions.
"""

from __future__ import annotations

import os
import sys
import warnings
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass
class Dataset:
    """A minimal named-array container: variables + per-variable dim names,
    1-D coordinate variables, and per-variable attributes — the labeled
    output shape the reference's xarray pipelines return
    (reference xcontour/core.py:251-266, 1017-1047).

    Under ``load_dataset(..., lazy=True)`` the variables are h5py datasets
    (or scipy memmaps) instead of in-memory arrays; ``_keepalive`` pins the
    open file(s) for their lifetime.  Slicing (``ds[name][lo:hi]``) then
    reads only the requested range — the contract the batch CLI uses to
    stream archives larger than host memory."""

    variables: Dict[str, np.ndarray] = field(default_factory=dict)
    dims: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    attrs: Dict[str, dict] = field(default_factory=dict)
    coords: Dict[str, np.ndarray] = field(default_factory=dict)
    _keepalive: list = field(default_factory=list, repr=False)

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self.variables:
            return self.variables[name]
        return self.coords[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables or name in self.coords

    def __iter__(self):
        return iter(self.variables)

    def keys(self):
        return self.variables.keys()

    def dims_of(self, name: str) -> Tuple[str, ...]:
        return self.dims[name]

    def to_nc3(self, path: str) -> None:
        """Write as classic netCDF-3 (the format the reference's scripts emit,
        tests/LWA.py:99-101)."""
        save_dataset_nc3(path, self.variables, self.dims, coords=self.coords,
                         attrs=self.attrs)

    def to_nc4(self, path: str) -> None:
        """Write as HDF5/netCDF-4 with dimension scales."""
        save_dataset(path, self.variables, self.dims, coords=self.coords,
                     attrs=self.attrs)


def _load_h5(path: str, lazy: bool = False) -> Dataset:
    import h5py
    from contextlib import nullcontext

    ds = Dataset()
    f = h5py.File(path, "r")
    try:
        with (nullcontext(f) if lazy else f):
            return _visit_h5(ds, f, lazy)
    except Exception:
        if lazy:
            f.close()  # don't leak the handle when visiting fails mid-file
        raise


def _visit_h5(ds, f, lazy):
    import h5py

    if lazy:
        ds._keepalive.append(f)

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            # netCDF-4 stores dim names in the DIMENSION_LIST/attached scale
            # metadata; fall back to phony names.
            dim_names = []
            for i, dim in enumerate(obj.dims):
                label = None
                if len(dim) > 0:
                    label = dim[0].name.rsplit("/", 1)[-1]
                elif dim.label:
                    label = dim.label
                dim_names.append(label or f"phony_dim_{i}")
            key = name.rsplit("/", 1)[-1]
            ds.variables[key] = obj if lazy else np.asarray(obj[()])
            ds.dims[key] = tuple(dim_names)
            ds.attrs[key] = {
                k: v for k, v in obj.attrs.items()
                if not k.startswith(("DIMENSION", "CLASS", "NAME",
                                     "REFERENCE"))
            }

    f.visititems(visit)
    return ds


class _Nc3Keepalive:
    """Close an mmap-backed scipy netcdf_file at GC without the RuntimeWarning
    it raises when (dying-together) views still reference the buffer — the
    mmap pages stay valid until every view is gone, so the warning is noise
    in this ownership scheme (the Dataset/_LazyField pins this object)."""

    def __init__(self, f):
        self.f = f

    def __del__(self):  # pragma: no cover — GC timing
        if sys.is_finalizing():
            # at interpreter exit the warnings machinery is half torn down:
            # an import fails (sys.meta_path is None), catch_warnings cannot
            # find its module and a filter no longer holds.  The OS unmaps
            # the file anyway; dropping netcdf_file's own reference to the
            # mapped buffer lets its finalizer close the file without the
            # warning about arrays that still refer to the buffer.
            self.f._mm_buf = None
            return
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            try:
                self.f.close()
            except Exception:
                pass


def _load_nc3(path: str, lazy: bool = False) -> Dataset:
    from scipy.io import netcdf_file

    ds = Dataset()
    f = netcdf_file(path, "r", mmap=lazy)
    try:
        if lazy:
            ds._keepalive.append(_Nc3Keepalive(f))
        for name, var in f.variables.items():
            ds.variables[name] = var.data if lazy else np.asarray(var[:])
            ds.dims[name] = tuple(var.dimensions)
            ds.attrs[name] = dict(var._attributes)
    finally:
        if not lazy:
            f.close()
    return ds


def load_dataset(path: str, lazy: bool = False) -> Dataset:
    """Read a netCDF file (HDF5-backed or classic) into a :class:`Dataset`.

    ``lazy=True`` defers variable reads: HDF5 variables stay h5py datasets,
    classic files are memory-mapped — slicing reads only the touched range,
    so archives larger than host memory can stream (the batch CLI's input
    mode).  The open file handle lives as long as the returned Dataset.

    A missing path raises plain :class:`FileNotFoundError` (the standard
    library contract); the combined two-reader :class:`ValueError` is
    reserved for files that EXIST but parse in neither format.  Without
    h5py, only the classic reader is tried."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"netCDF file not found: {path}")
    try:
        return _load_h5(path, lazy)
    except (OSError, ImportError) as e_h5:
        try:
            return _load_nc3(path, lazy)
        except Exception as e_nc3:  # noqa: BLE001 — scipy raises TypeError
            # on garbage; surface one clear error naming both readers
            # instead of scipy's bare "not a valid NetCDF 3 file"
            raise ValueError(
                f"{path} is not a readable netCDF file "
                f"(HDF5/netCDF-4 reader: {e_h5}; classic netCDF-3 reader: "
                f"{e_nc3})") from e_nc3


def save_dataset(path: str, variables: Dict[str, np.ndarray], dims: Dict[str, Tuple[str, ...]],
                 coords: Dict[str, np.ndarray] | None = None,
                 attrs: Dict[str, dict] | None = None) -> None:
    """Write variables to an HDF5 (netCDF-4 flavoured) file.

    ``coords`` are 1-D coordinate variables attached as HDF5 dimension scales
    so :func:`load_dataset` recovers dim names on read.  ``attrs`` maps
    variable names to attribute dicts (units, long_name, ...), round-tripped
    through HDF5 attributes.
    """
    import h5py

    coords = coords or {}
    attrs = attrs or {}
    with h5py.File(path, "w") as f:
        for cname, cvals in coords.items():
            d = f.create_dataset(cname, data=np.asarray(cvals))
            d.make_scale(cname)
            for k, val in attrs.get(cname, {}).items():
                d.attrs[k] = val
        for vname, vals in variables.items():
            if vname in coords:
                continue
            d = f.create_dataset(vname, data=np.asarray(vals))
            for axis, dname in enumerate(dims.get(vname, ())):
                if dname in coords:
                    d.dims[axis].attach_scale(f[dname])
                # label even scale-less dims so load_dataset recovers the
                # name (its reader falls back to dim.label)
                d.dims[axis].label = dname
            for k, val in attrs.get(vname, {}).items():
                d.attrs[k] = val


def save_dataset_nc3(path: str, variables: Dict[str, np.ndarray],
                     dims: Dict[str, Tuple[str, ...]],
                     coords: Dict[str, np.ndarray] | None = None,
                     attrs: Dict[str, dict] | None = None) -> None:
    """Write a classic netCDF-3 file (via scipy) — the format the reference's
    scripts emit with ``to_netcdf`` (tests/LWA.py:99-101).  ``attrs`` maps
    variable names to attribute dicts (units, long_name, ...)."""
    from scipy.io import netcdf_file

    def _nc3(a):
        # classic netCDF has no 64-bit ints / half floats
        a = np.asarray(a)
        if a.dtype == np.int64:
            return a.astype(np.int32)
        if a.dtype == np.float16:
            return a.astype(np.float32)
        return a

    coords = coords or {}
    attrs = attrs or {}
    with netcdf_file(path, "w") as f:
        for cname, cvals in coords.items():
            cvals = _nc3(cvals)
            f.createDimension(cname, cvals.shape[0])
        for cname, cvals in coords.items():
            cvals = _nc3(cvals)
            v = f.createVariable(cname, cvals.dtype.str[1:], (cname,))
            v[:] = cvals
            for k, val in attrs.get(cname, {}).items():
                setattr(v, k, val)
        for vname, vals in variables.items():
            if vname in coords:
                continue
            vals = _nc3(vals)
            vdims = dims.get(vname, ())
            for ax, dname in enumerate(vdims):
                if dname not in f.dimensions:
                    f.createDimension(dname, vals.shape[ax])
            v = f.createVariable(vname, vals.dtype.str[1:], vdims)
            v[:] = vals
            for k, val in attrs.get(vname, {}).items():
                setattr(v, k, val)
