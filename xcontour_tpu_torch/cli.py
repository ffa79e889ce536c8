"""Command-line batch tool: netCDF in -> pipeline step -> netCDF out.

Counterpart of ``xcontour_tpu/cli.py``.  The reference ships its production
workloads as hand-edited scripts (its tests/LWA.py, test_Keff_atmos.py): a
Python double loop per archive, no resume, outputs assembled at the end.
This module packages the same workloads as a deployable command:

    python -m xcontour_tpu_torch keff         input.nc --var pv -N 251 --out k.nc
    python -m xcontour_tpu_torch lwa          input.nc --var pv --scale-var sigma
    python -m xcontour_tpu_torch keff-lwa     input.nc --var pv --interp-eq
    python -m xcontour_tpu_torch clength      input.nc --var tracer
    python -m xcontour_tpu_torch fractal      input.nc --var tracer --strides 1,2
    python -m xcontour_tpu_torch local-length input.nc --window 101 --stride 10
    python -m xcontour_tpu_torch info         input.nc

Steps run on the card (``--device cuda``, the default; there is no
fall-back) or on the CPU (``--device cpu``).  Everything between file reads
is the port's machinery: dim autodetect (the reference's name lists,
utils.py:34-39), ``from_latlon`` metrics, the pipeline step streamed in
chunks through ``runner.run_batched`` (pinned, overlapped copies; per-chunk
retry / resume via ``--stem``), and coordinate-labelled output through
``pipeline.as_dataset`` -> netCDF-3/4.  Lead dims of the input variable are
flattened into one batch axis for streaming and restored (with their names)
on output.

``--mesh N|BxX`` shards each chunk over a ('batch', 'x') mesh of ranks,
one process a rank (one card a rank), as the JAX CLI's ``--mesh`` shards
it over devices:

    torchrun --standalone --nproc-per-node 4 -m xcontour_tpu_torch \
        keff-lwa input.nc --var pv --mesh 2x2 --batch 32

Each rank joins the group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), reads its block of each chunk and runs the sharded
step (``parallel.pipeline``); rank 0 gathers and writes.  Outside
torchrun ``--mesh 1`` (or ``1x1``) runs in this process as a group of one.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from . import pipeline, runner
from .grid import from_latlon, to_numpy
from .kernels import decode
from .utils.ncio import Dataset, load_dataset
from .utils import prof
from .xcontour import dimXList, dimYList


def _parse_kv(items: Optional[List[str]], what: str) -> dict:
    out = {}
    for item in items or []:
        for part in item.split(","):
            if "=" not in part:
                raise SystemExit(f"bad {what} {part!r}: expected name=value")
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _detect_dims(ds: Dataset, user: dict) -> tuple:
    """Resolve (lon, lat) dim names: user overrides (validated against the
    file) fill their axis, autodetection (the reference name lists,
    utils.py:34-39) fills the rest."""
    for axis, name in user.items():
        if axis == "Z":
            raise SystemExit(
                "--dims Z= has no effect here: every lead dim is batched; "
                "use --isel to select vertical levels")
        if axis not in ("X", "Y"):
            raise SystemExit(f"--dims axis {axis!r}: expected X= or Y=")
        if name not in ds:
            raise SystemExit(f"--dims {axis}={name}: {name!r} not in file; "
                             f"have: {sorted(set(ds.variables))}")
    names = set(ds.variables) | set(ds.coords)
    lon_n = user.get("X") or next((d for d in dimXList if d in names), None)
    lat_n = user.get("Y") or next((d for d in dimYList if d in names), None)
    if lon_n is None or lat_n is None:
        raise SystemExit(
            "could not autodetect lat/lon dims; pass --dims X=...,Y=... "
            f"(known names: {dimYList} / {dimXList})")
    return lon_n, lat_n


def _pick_var(ds: Dataset, var: Optional[str], lat_n: str, lon_n: str) -> str:
    if var is not None:
        if var not in ds.variables:
            raise SystemExit(
                f"variable {var!r} not in file; have: "
                f"{sorted(ds.variables)}")
        return var
    plane = (lat_n, lon_n)
    cands = [k for k, d in ds.dims.items()
             if len(d) >= 2 and d[-2:] == plane and k not in (lat_n, lon_n)]
    if len(cands) == 1:
        return cands[0]
    raise SystemExit(
        f"--var required: {'no' if not cands else 'several'} variables end "
        f"in ({lat_n}, {lon_n})" + (f": {sorted(cands)}" if cands else ""))


class _LazyField:
    """(T, Ny, Nx) streaming view of a (lead..., Ny, Nx) file variable.

    Wraps a lazy source (h5py dataset / nc3 memmap / ndarray) and applies
    the per-chunk transforms -- --isel lead selection, --scale-var multiply,
    fluid-mask NaN'ing, dtype cast -- at slice time, so the CLI never
    materializes the archive: ``runner.run_batched`` accepts any sliceable
    (T, ...) source, and this is what makes inputs larger than host memory
    stream.  ``field[rows]`` gives native-order chunks of the run's dtype
    (the cast brings a classic netCDF file's big-endian memmap to native
    byte order).

    Where the source is a C-contiguous numpy buffer (the nc3 memmap or an
    ndarray) of big- or little-endian float32 or float64 and no --scale-var
    applies, the field also offers its raw planes (:meth:`raw_planes`,
    :meth:`raw_into`): the runner then copies the file's bytes unchanged and
    the card does the byte order, flip, cast and mask
    (``kernels.decode``)."""

    def __init__(self, src, vdims, isel, scale_src, sdims, mask, dtype,
                 keepalive=(), flip_y=False):
        self.src = src
        self._keepalive = list(keepalive)  # open file handles must outlive
        #                                    the views this field slices
        self._flip_y = flip_y              # descending-latitude files are
        #                                    normalized to ascending rows
        self._vdims = list(vdims)             # original axis names
        self._isel = dict(isel)               # name -> normalized index
        self._scale = scale_src               # lazy too; None when unused
        self._sdims = list(sdims or ())
        self._mask = mask                     # (Ny, Nx) fluid mask or None
        self._lead_names = [d for d in self._vdims[:-2] if d not in isel]
        self.lead_shape = tuple(
            src.shape[self._vdims.index(d)] for d in self._lead_names)
        T = int(np.prod(self.lead_shape)) if self.lead_shape else 1
        self.shape = (T,) + tuple(src.shape[-2:])
        self.ndim = 3
        self.dtype = np.dtype(dtype)

    def set_mask(self, mask):
        self._mask = mask

    def _lead_index(self, t):
        if not self.lead_shape:
            return {}
        pos = np.unravel_index(t, self.lead_shape)
        return dict(zip(self._lead_names, (int(p) for p in pos)))

    def _sel(self, d, lead, cols):
        """The index of axis ``d``: the lead selection, all of Ny, or the
        columns ``cols`` of Nx."""
        if d == self._vdims[-1]:
            return cols
        if d == self._vdims[-2]:
            return slice(None)
        return self._isel.get(d, lead.get(d))

    def _finish(self, block, lead, cols):
        """Scale, flip, cast and mask a (..., Ny, Nx_cols) read."""
        if self._scale is not None:
            plane = self._vdims[-2:]
            sval = np.asarray(self._scale[tuple(
                self._sel(d, lead, cols) for d in self._sdims)])
            # align the surviving (plane) dims: each missing plane dim
            # broadcasts as length 1
            shp = tuple(block.shape[block.ndim - 2 + k]
                        if plane[k] in self._sdims else 1 for k in range(2))
            lead_len = block.shape[:block.ndim - 2]
            if lead_len:   # a hyperslab: its lead dim, where scale has it
                d0 = self._lead_names[0]
                shp = (lead_len[0] if d0 in self._sdims else 1,) + shp
            block = block * sval.reshape(shp)
        if self._flip_y:
            block = block[..., ::-1, :]
        block = block.astype(self.dtype, copy=False)
        if self._mask is not None:
            block = np.where(self._mask[:, cols] != 0, block, np.nan)
        return block

    def _read(self, t, cols):
        lead = self._lead_index(t)
        snap = np.asarray(self.src[tuple(
            self._sel(d, lead, cols) for d in self._vdims)])
        return self._finish(snap, lead, cols)

    def _read_contiguous(self, lo, hi, cols):
        """Fast path for the common layout (exactly one lead dim): one
        hyperslab read instead of per-snapshot calls -- chunked/compressed
        HDF5 layouts spanning several records would otherwise be re-read
        and re-decompressed once per snapshot."""
        lead = {self._lead_names[0]: slice(lo, hi)}
        block = np.asarray(self.src[tuple(
            self._sel(d, lead, cols) for d in self._vdims)])
        return self._finish(block, lead, cols)               # (hi-lo, Ny, nc)

    def raw_planes(self) -> Optional[decode.Planes]:
        """How :meth:`raw_into`'s bytes decode into ``field[rows]``, or None
        where the source offers no raw planes: not a C-contiguous numpy
        buffer, a dtype the decode does not take, or a --scale-var."""
        src = self.src
        if (self._scale is not None or not isinstance(src, np.ndarray)
                or not src.flags.c_contiguous
                or src.dtype not in decode.FILE_DTYPES):
            return None
        mask = None if self._mask is None else self._mask != 0
        return decode.Planes(src.dtype, self._flip_y, mask, self.dtype)

    def raw_into(self, rows: slice, out: np.ndarray) -> None:
        """Copy the file bytes of the snapshots ``rows`` unchanged into
        ``out`` ((n, Ny, Nx * itemsize) uint8), one copy a run of planes
        that lie one after another in the file: a whole chunk is one run
        unless --isel splits it."""
        src = self.src
        planes = src.reshape((-1,) + src.shape[-2:]).view(np.uint8)
        ts = np.arange(*rows.indices(self.shape[0]))
        pos = dict(zip(self._lead_names,
                       np.unravel_index(ts, self.lead_shape)
                       if self.lead_shape else ()))
        lead = src.shape[:-2]
        plane = np.ravel_multi_index(
            [pos[d] if d in pos else np.full(len(ts), self._isel[d])
             for d in self._vdims[:-2]], lead) if lead else \
            np.zeros(len(ts), np.int64)
        cuts = np.flatnonzero(np.diff(plane) != 1) + 1
        for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(ts)]):
            np.copyto(out[a:b], planes[plane[a]:plane[a] + b - a])

    def __getitem__(self, key):
        """``field[rows]`` or ``field[rows, :, cols]`` (slices): the
        snapshots ``rows``, only the columns ``cols`` read from the file."""
        cols = slice(None)
        if isinstance(key, tuple):
            if len(key) != 3 or key[1] != slice(None):
                raise TypeError("_LazyField takes field[rows] or "
                                "field[rows, :, cols]")
            key, _, cols = key
        if not (isinstance(key, slice) and isinstance(cols, slice)):
            raise TypeError("_LazyField supports slice indexing only")
        idxs = range(*key.indices(self.shape[0]))
        if len(self._lead_names) == 1 and idxs.step == 1:
            return self._read_contiguous(idxs.start, idxs.stop, cols)
        nc = len(range(*cols.indices(self.shape[2])))
        out = np.empty((len(idxs), self.shape[1], nc), self.dtype)
        for i, t in enumerate(idxs):
            out[i] = self._read(t, cols)
        return out


def _load_field(args):
    """Shared input stage: open lazily, detect dims, build grid, shape the
    batch.

    Returns (tracer -- a (T, Ny, Nx) streaming view, grid (on
    ``args.device``), lead dim names, lead shape, lead coords dict).  Only
    coordinates, masks and scale metadata are read eagerly; snapshot data
    is read per chunk."""
    if args.batch < 1:
        raise SystemExit(f"--batch must be >= 1, got {args.batch}")
    try:
        ds = load_dataset(args.input, lazy=True)
    except (ValueError, FileNotFoundError, OSError) as e:
        raise SystemExit(f"cannot open {args.input}: {e}") from None
    lon_n, lat_n = _detect_dims(ds, _parse_kv(args.dims, "--dims"))
    var = _pick_var(ds, args.var, lat_n, lon_n)
    vdims = list(ds.dims_of(var))
    if len(vdims) < 2 or tuple(vdims[-2:]) != (lat_n, lon_n):
        raise SystemExit(
            f"variable {var!r} has dims {tuple(vdims)}; the last two must "
            f"be ({lat_n}, {lon_n})")
    src = ds[var]

    scale_src, sdims = None, ()
    if args.scale_var:
        sv = args.scale_var
        if sv not in ds.variables:
            raise SystemExit(f"--scale-var {sv!r} not in file; have: "
                             f"{sorted(ds.variables)}")
        sdims = list(ds.dims_of(sv))
        extra = [d for d in sdims if d not in vdims]
        if extra:
            raise SystemExit(f"--scale-var {sv!r} dims {extra} are not dims "
                             f"of {var!r} {tuple(vdims)}")
        order = [vdims.index(d) for d in sdims]
        if order != sorted(order):
            raise SystemExit(f"--scale-var {sv!r} dims {tuple(sdims)} are "
                             f"ordered differently than {var!r}'s "
                             f"{tuple(vdims)}")
        scale_src = ds[sv]
        for d in sdims:
            want = src.shape[vdims.index(d)]
            got = scale_src.shape[sdims.index(d)]
            if want != got:
                raise SystemExit(f"--scale-var {sv!r}: dim {d!r} has length "
                                 f"{got}, but {var!r} has {want}")

    # integer selections on lead dims (e.g. --isel lev=3)
    isel = {}
    for name, idx in _parse_kv(args.isel, "--isel").items():
        if name not in vdims[:-2]:
            raise SystemExit(f"--isel dim {name!r} not a lead dim of "
                             f"{var!r} {tuple(vdims)}")
        try:
            idx = int(idx)
        except ValueError:
            raise SystemExit(f"--isel {name}={idx}: index must be an "
                             "integer") from None
        size = src.shape[vdims.index(name)]
        if not -size <= idx < size:
            raise SystemExit(f"--isel {name}={idx}: out of range for size "
                             f"{size}")
        isel[name] = idx % size

    dtype = np.float64 if args.f64 else np.float32
    lat = np.asarray(ds[lat_n], np.float64)
    lon = np.asarray(ds[lon_n], np.float64)
    # the contour-space chain assumes the equivalent coordinate ascends
    # (the reference's users sortby('latitude') first; its eq-latitude
    # formula accumulates area from the south pole) -- normalize the ERA5
    # 90..-90 storage convention here and label outputs with ascending lat
    flip_y = lat.size > 1 and lat[0] > lat[-1]
    if flip_y:
        lat = lat[::-1].copy()
        print(f"[cli] {lat_n} is stored descending; rows normalized to "
              "ascending (outputs are labeled with the ascending "
              "coordinate)")
    tracer = _LazyField(src, vdims, isel, scale_src, sdims, None, dtype,
                        keepalive=ds._keepalive, flip_y=flip_y)

    lead_names = tuple(tracer._lead_names) or ("time",)
    lead_shape = tracer.lead_shape or (1,)
    lead_coords = {}
    for n in tracer._lead_names:
        if n in ds:
            v = np.asarray(ds[n])  # read the (small) coordinate once
            if v.ndim == 1 and len(v) == src.shape[vdims.index(n)]:
                lead_coords[n] = v

    if args.mask_var and args.mask_from_nan:
        raise SystemExit("--mask-var and --mask-from-nan are exclusive")
    mask = None
    if args.mask_var:
        mv = args.mask_var
        if mv not in ds.variables:
            raise SystemExit(f"--mask-var {mv!r} not in file; have: "
                             f"{sorted(ds.variables)}")
        m = np.asarray(ds[mv])
        if tuple(ds.dims_of(mv)) != (lat_n, lon_n):
            raise SystemExit(f"--mask-var {mv!r} dims {ds.dims_of(mv)} must "
                             f"be exactly ({lat_n}, {lon_n})")
        if flip_y:
            m = m[::-1]
        mask = ((m != 0) & np.isfinite(m)).astype(dtype)
    elif args.mask_from_nan:
        # one streaming pass: fluid = finite in EVERY snapshot
        fin = np.ones(tracer.shape[1:], bool)
        for lo in range(0, tracer.shape[0], args.batch):
            fin &= np.isfinite(
                tracer[lo:lo + args.batch]).all(axis=0)
        mask = fin.astype(dtype)
    if mask is not None:
        # the reference's ocean scripts mask the TRACER too
        # (tracer.where(maskC), tests/test_Keff_ocean.py) -- NaN cells are
        # what the length/LWA/local-window kernels exclude; the grid mask
        # alone only reaches the A(Yeq) table and numeric Lmin
        tracer.set_mask(mask)

    grid = from_latlon(lat, lon, mask=mask, dim_names=(lat_n, lon_n),
                       dtype=torch.float64 if args.f64 else torch.float32,
                       device=args.device)
    return tracer, grid, lead_names, lead_shape, lead_coords

_FP_EXCLUDE = frozenset({"out", "format", "fields", "stem", "retries",
                         "on_error"})  # output-shaping only -- no effect on
#                                        the per-chunk arrays themselves


def _fingerprint(args, tracer) -> dict:
    """Every compute-relevant argument (N, flags, lmin, lwa-method,
    scale-var, window, f64, device, ...) plus the resolved input and T;
    anything not in _FP_EXCLUDE changing between runs must invalidate the
    stem."""
    fp = {k: v for k, v in sorted(vars(args).items())
          if k not in _FP_EXCLUDE}
    # canonicalize the repeatable kv options so respelling/reordering an
    # identical selection still resumes; store as LISTS of lists -- the JSON
    # sidecar round-trips tuples as lists, and tuple != list would refuse
    # every rerun that uses --isel/--dims
    fp["isel"] = [[k, v] for k, v in
                  sorted(_parse_kv(args.isel, "--isel").items())]
    fp["dims"] = [[k, v] for k, v in
                  sorted(_parse_kv(args.dims, "--dims").items())]
    fp["input"] = os.path.abspath(args.input)
    fp["T"] = int(tracer.shape[0])
    return fp


def _check_stem(args, tracer) -> None:
    """Guard --stem resume: a sidecar fingerprint pins the checkpoint set to
    one (input, variable, parameters) combination, so a rerun with changed
    -N/--var/--batch/... errors out instead of silently reassembling stale
    chunks (chunk files encode none of these)."""
    meta_path = args.stem + ".meta.json"
    fp = _fingerprint(args, tracer)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f)
        stale = {k for k in fp if old.get(k) != fp[k]}
        if stale:
            raise SystemExit(
                f"--stem {args.stem} holds checkpoints from a different "
                f"run (changed: {sorted(stale)}; recorded {meta_path}); "
                "use a fresh stem or delete the old chunks")
    else:
        os.makedirs(os.path.dirname(meta_path) or ".", exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(fp, f)


def _check_stem_on(args, tracer, sharding) -> None:
    """:func:`_check_stem` on rank 0 of a mesh, its verdict on every rank
    (a rank that exits alone would leave the others in a collective)."""
    if sharding is None:
        return _check_stem(args, tracer)
    import torch.distributed as dist
    msg = [None]
    if dist.get_rank() == 0:
        try:
            _check_stem(args, tracer)
        except SystemExit as e:
            msg[0] = str(e)
    dist.broadcast_object_list(msg, src=0)
    if msg[0]:
        raise SystemExit(msg[0])


def _run(args, step, grid, tracer, lead_names, lead_shape, lead_coords,
         pre_y=None, extra_coords=None, dim_hints=None, sharding=None,
         x_keys=()):
    """Shared output stage: stream, unflatten lead dims, label, write.  On
    a mesh, rank 0 labels and writes; the other ranks return after the
    stream."""

    def chunk_step(chunk):
        flat = pipeline.flatten_output(step(chunk))
        # the A(Yeq) table is built from the grid mask -- batch-independent,
        # so it must not ride the chunked batch axis (run_batched slices
        # and concatenates axis 0 of every output)
        flat.pop("table", None)
        bad = [k for k, v in flat.items()
               if v.ndim == 0 or v.shape[0] != chunk.shape[0]]
        if bad:  # internal invariant, not user error
            raise RuntimeError(f"pipeline outputs {bad} are not batched "
                               "along axis 0; cannot stream them")
        return flat

    validate = None
    if args.validate == "finite":
        def validate(out_np):
            dead = [k for k, v in out_np.items()
                    if v.size and not np.isfinite(v).any()]
            if dead:
                raise ValueError(f"chunk outputs {dead} entirely non-finite")

    tdt = {"f32": None, "f16": torch.float16,
           "bf16": torch.bfloat16}[getattr(args, "transfer", "f32")]
    kw = dict(batch=args.batch, retries=args.retries, on_error=args.on_error,
              validate=validate, device=args.device, transfer_dtype=tdt,
              sharding=sharding, x_keys=x_keys)
    lead = sharding is None or torch.distributed.get_rank() == 0
    with prof.span("cli.stream"):
        if args.stem:
            _check_stem_on(args, tracer, sharding)
            runner.run_batched(chunk_step, tracer, out_stem=args.stem,
                               resume=True, **kw)
            if not lead:
                return 0
            out = runner.load_chunks(args.stem, allow_failed=True,
                                     expect_chunks=-(-tracer.shape[0]
                                                     // args.batch))
        else:
            out = runner.run_batched(chunk_step, tracer, **kw)
            if not lead:
                return 0

    with prof.span("cli.label"):
        out = {k: np.asarray(v).reshape(lead_shape + np.asarray(v).shape[1:])
               for k, v in out.items()}
        labeled = pipeline.as_dataset(out, grid, pre_y=pre_y,
                                      batch_dims=lead_names,
                                      extra_coords={**lead_coords,
                                                    **(extra_coords or {})},
                                      dim_hints=dim_hints)
    if args.fields:
        # subset AFTER labeling so dim inference (contour count, plane
        # detection) still sees the full output
        keep = {f.strip() for item in args.fields for f in item.split(",")}
        missing = keep - set(labeled.variables)
        if missing:
            raise SystemExit(f"--fields {sorted(missing)} not among outputs "
                             f"{sorted(labeled.variables)}")
        for name in list(labeled.variables):
            if name not in keep:
                del labeled.variables[name], labeled.dims[name]
                labeled.attrs.pop(name, None)
    path = args.out or f"{os.path.splitext(args.input)[0]}_{args.cmd}.nc"
    with prof.span("cli.write"):
        if args.format == "nc3":
            labeled.to_nc3(path)
        else:
            labeled.to_nc4(path)
    nvar = len(labeled.variables)
    print(f"[cli] wrote {path}: {nvar} variables, "
          f"batch {lead_shape} x grid {grid.shape}")
    return 0


def _add_common(p: argparse.ArgumentParser, contours: bool = True):
    p.add_argument("input", help="input netCDF (classic or HDF5-backed)")
    p.add_argument("--var", help="tracer variable (default: the unique "
                   "variable on the detected (lat, lon) plane)")
    p.add_argument("--dims", action="append", metavar="X=lon,Y=lat",
                   help="override dim autodetect (reference utils.py:34-39)")
    p.add_argument("--isel", action="append", metavar="dim=index",
                   help="integer-select lead dims before processing")
    p.add_argument("--scale-var", metavar="NAME",
                   help="multiply the tracer by this file variable "
                        "(dims broadcast by name) before processing — e.g. "
                        "the sigma of the reference's sigma*q production "
                        "LWA (tests/LWA.py:59-69)")
    p.add_argument("--mask-var", metavar="NAME",
                   help="fluid mask from this (lat, lon) file variable "
                        "(nonzero = fluid), like the ocean script's maskC "
                        "(tests/test_Keff_ocean.py)")
    p.add_argument("--mask-from-nan", action="store_true",
                   help="fluid mask = cells finite in EVERY snapshot "
                        "(topography marked by NaN)")
    if contours:
        p.add_argument("-N", "--contours", type=int, default=121, dest="N",
                       help="number of contour levels (default 121)")
        p.add_argument("--decrease", action="store_true",
                       help="tracer decreases with the equivalent "
                            "coordinate (default: increases)")
        p.add_argument("--gt", action="store_true",
                       help="integrate where tracer > level (default: <)")
    p.add_argument("--batch", type=int, default=32,
                   help="chunk size streamed per step (default 32)")
    p.add_argument("--transfer", choices=("f32", "f16", "bf16"),
                   default="f32",
                   help="host->device wire format for streamed chunks: "
                        "'f16'/'bf16' halve the transfer and upcast on "
                        "device (compute precision unchanged, INPUT rounded "
                        "to ~5e-4 / ~4e-3 relative) — for when the link, "
                        "not the card, is the bottleneck")
    p.add_argument("--mesh", metavar="N|BxX",
                   help="shard each chunk over an N-rank ('batch','x') mesh, "
                        "one process a rank under torchrun (one card a rank; "
                        "gloo with --device cpu); BxX pins the split, e.g. "
                        "2x2 = 2-way batch x 2-way spatial, N alone takes "
                        "x = 2 when N is even.  Outside torchrun only "
                        "--mesh 1 runs, in process")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the steps run (default cuda: the card, with "
                        "no fall-back to the CPU)")
    p.add_argument("--stem", help="per-chunk .npz checkpoint stem: chunks "
                   "are written as <stem>_ck{k}.npz and reruns resume")
    p.add_argument("--retries", type=int, default=0,
                   help="per-chunk retries before failing (default 0)")
    p.add_argument("--on-error", choices=("raise", "skip"), default="raise",
                   help="'skip' records failed chunks and NaN-fills them")
    p.add_argument("--validate", choices=("none", "finite"), default="none",
                   help="'finite' rejects a chunk when any output variable "
                        "is entirely non-finite (triggers --retries, then "
                        "--on-error)")
    p.add_argument("--fields", action="append", metavar="a,b",
                   help="write only these output variables")
    p.add_argument("--out", help="output netCDF path "
                   "(default <input>_<cmd>.nc)")
    p.add_argument("--format", choices=("nc4", "nc3"), default="nc4",
                   help="output flavor: HDF5/netCDF-4 (needs h5py) or "
                        "classic netCDF-3")
    p.add_argument("--f64", action="store_true",
                   help="compute in float64 (--device cpu only: the "
                        "kernels take float32)")


def _check_run_options(args) -> None:
    """Refuse, before any chunk runs, what this machine or device cannot
    do -- never a silent change of device, precision or format."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the steps run on the card by "
                         "default; pass --device cpu to run on the CPU")
    if args.f64 and args.device == "cuda":
        raise SystemExit("--f64 computes in float64, and the kernels take "
                         "float32 only: pass --device cpu with --f64")
    if args.format == "nc4" and importlib.util.find_spec("h5py") is None:
        raise SystemExit("--format nc4 (the default) writes through h5py, "
                         "which is not installed: pass --format nc3")


_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# how long a rank waits in a collective before the group gives up on a
# rank that failed or hung
_GROUP_TIMEOUT_S = 600


def _parse_mesh(args):
    """(ranks, x shards, under torchrun) of ``--mesh N|BxX``, refused with
    the JAX CLI's messages.  Under torchrun the mesh must span WORLD_SIZE
    and, on the card, each of a node's ranks needs a card of its own;
    outside torchrun only a mesh of one runs (in this process)."""
    spec = args.mesh.lower()
    try:
        if "x" in spec:
            b, x = (int(v) for v in spec.split("x"))
            n = b * x
        else:
            n, x = int(spec), None
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: expected a device count N "
                         "or BxX (batch x spatial)") from None
    if n < 1 or (x is not None and x < 1):
        raise SystemExit(f"--mesh {args.mesh!r}: counts must be >= 1")
    torchrun = all(k in os.environ for k in _TORCHRUN)
    if torchrun:
        world = int(os.environ["WORLD_SIZE"])
        if n != world:
            raise SystemExit(f"--mesh {args.mesh}: {n} devices requested, "
                             f"{world} available (torchrun's WORLD_SIZE)")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if args.device == "cuda" and local > cards:
            raise SystemExit(f"--mesh {args.mesh}: {n} devices requested, "
                             f"{cards} available ({local} ranks on this "
                             "node, one card a rank)")
    elif n > 1:
        raise SystemExit(
            f"--mesh {args.mesh}: {n} devices requested, 1 available: a "
            f"mesh of {n} ranks runs under torchrun, one process a rank "
            f"(torchrun --standalone --nproc-per-node {n} -m "
            "xcontour_tpu_torch ...)")
    if x is None:
        x = 2 if n % 2 == 0 and n >= 2 else 1
    return n, x, torchrun


def _join_mesh(args, n: int, x: int, torchrun: bool, Nx: int):
    """(the mesh, its chunks' block spec, a cleanup leaving the group):
    refuses a batch or grid the mesh does not divide, then joins the
    process group (NCCL on the card, gloo on the CPU; outside torchrun a
    group of one through a file store in a temporary directory)."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from .parallel import make_mesh, shard_batch_spec

    bsz = n // x
    if args.batch % bsz:
        raise SystemExit(f"--mesh {args.mesh}: --batch {args.batch} not "
                         f"divisible by the {bsz}-way batch axis")
    if Nx % x:
        raise SystemExit(f"--mesh {args.mesh}: grid Nx {Nx} not "
                         f"divisible by the {x}-way spatial axis")
    backend = "nccl" if args.device == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=_GROUP_TIMEOUT_S)
    tmp = None
    if torchrun:
        dist.init_process_group(backend, timeout=timeout)
    else:
        tmp = tempfile.TemporaryDirectory()
        store = dist.FileStore(os.path.join(tmp.name, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                timeout=timeout)

    def cleanup():
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()
    try:
        mesh = make_mesh(n, x_size=x)
    except BaseException:
        cleanup()
        raise
    return mesh, shard_batch_spec(mesh, 3), cleanup


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="xcontour_tpu_torch",
        description="contour-space diagnostics (Keff, LWA, lengths, fractal "
                    "dimension) over netCDF snapshot archives, on the card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="list variables, dims, and shapes")
    pi.add_argument("input")

    pk = sub.add_parser("keff", help="effective-diffusivity chain "
                        "(reference tests/test_Keff_atmos.py)")
    _add_common(pk)
    pk.add_argument("--lmin", choices=("analytic", "dxF", "frac"),
                    default="analytic", help="minimum-length convention")
    pk.add_argument("--interp-eq", action="store_true",
                    help="also interpolate outputs onto the grid's "
                         "equivalent coordinate (the *_at variables)")
    pk.add_argument("--no-hist", action="store_true",
                    help="use the broadcast-comparison conditional "
                         "integrals instead of the weighted-histogram CDF")

    pl = sub.add_parser("lwa", help="local finite-amplitude wave activity "
                        "(reference tests/LWA.py)")
    _add_common(pl)
    pl.add_argument("--part", default="all",
                    choices=("all", "cyclone", "anticyclone", "upper",
                             "lower", "split"),
                    help="W+/W- region selection (Huang-Nakamura 2016): "
                         "'cyclone' = the reference's 'upper' (W+), "
                         "'anticyclone' = 'lower' (W-) — these aliases "
                         "assume the NH / PV-like sign convention (tracer "
                         "increasing poleward); for SH relative vorticity "
                         "or reversed conventions the physical labels swap, "
                         "so prefer the exact 'upper'/'lower' names, which "
                         "are accepted verbatim; 'split' writes both halves "
                         "(lwa_upper, lwa_lower, lwa2_upper, lwa2_lower) "
                         "from one pass")
    pl.add_argument("--lwa-method", choices=("auto", "lin", "dense", "fast"),
                    default="auto", help="execution path (docs/API.md)")
    pl.add_argument("--metric", choices=("dA", "dy"), default="dA",
                    help="'dA' = reference area weights, 'dy' = physical "
                         "m/s column metric")

    pb = sub.add_parser("keff-lwa", help="combined Keff + LWA from one "
                        "shared sorted state (the flagship fused step)")
    _add_common(pb)
    pb.add_argument("--lmin", choices=("analytic", "dxF", "frac"),
                    default="analytic")
    pb.add_argument("--lwa-method", choices=("auto", "lin", "dense", "fast"),
                    default="auto")
    pb.add_argument("--interp-eq", action="store_true")
    pb.add_argument("--with-lwa2", action="store_true",
                    help="also compute the impulse-Casimir LWA variant")
    pb.add_argument("--metric", choices=("dA", "dy"), default="dA",
                    help="'dA' = reference area weights, 'dy' = physical "
                         "m/s column metric")

    pc = sub.add_parser("clength", help="contour perimeter lengths + "
                        "Cauchy-Schwarz contour means")
    _add_common(pc)

    pw = sub.add_parser("local-length", help="windowed local contour length "
                        "at the window-mean level (wave-activity density "
                        "proxy)")
    _add_common(pw, contours=False)  # window-mean levels -- no -N/flags
    pw.add_argument("--window", type=int, default=101,
                    help="square window size in cells (default 101)")
    pw.add_argument("--stride", type=int, default=10,
                    help="window stride in cells (default 10)")
    pw.add_argument("--min-count", type=int, default=1,
                    help="minimum finite cells for a window to count")

    pf = sub.add_parser("fractal", help="fractal dimension by coarsening "
                        "ladder (+ box counting); on a mesh with an x axis "
                        "over 1 the x slabs are gathered in the x group and "
                        "the step runs whole on each x rank (as GSPMD "
                        "replicates it)")
    _add_common(pf)
    pf.add_argument("--strides", default="1,2,4,8,16,32",
                    help="coarsening strides; each must divide Ny and Nx")
    pf.add_argument("--no-box-counting", action="store_true")

    args = ap.parse_args(argv)

    # canonicalize the physical W+/W- names onto the reference's part flags
    # (reference core.py:709-712: 'upper' = W+ = cyclonic intrusions) BEFORE
    # the stem fingerprint, so respelling an identical selection still
    # resumes
    if getattr(args, "part", None):
        args.part = {"cyclone": "upper",
                     "anticyclone": "lower"}.get(args.part, args.part)
        if args.part != "all" and getattr(args, "lwa_method", "auto") == "lin":
            raise SystemExit(
                "--lwa-method lin computes only part='all' (the linearized "
                "kernel telescopes the combined W+ + W- sum; the split "
                "needs the pairwise path) — use --lwa-method dense or "
                "auto with --part " + args.part)

    if args.cmd == "info":
        try:
            ds = load_dataset(args.input, lazy=True)  # shapes only, no reads
        except (ValueError, FileNotFoundError, OSError) as e:
            raise SystemExit(f"cannot open {args.input}: {e}") from None
        for name in sorted(ds.variables):
            a = ds.variables[name]
            print(f"{name}  dims={ds.dims_of(name)}  shape={a.shape}  "
                  f"dtype={a.dtype}")
        return 0

    _check_run_options(args)
    mesh_req = _parse_mesh(args) if args.mesh else None
    if mesh_req and mesh_req[2] and args.device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    with prof.span("cli.open"):
        tracer, grid, lead_names, lead_shape, lead_coords = _load_field(args)
    if mesh_req is None:
        return _steps(args, tracer, grid, lead_names, lead_shape,
                      lead_coords)
    mesh, sharding, cleanup = _join_mesh(args, *mesh_req, grid.shape[-1])
    try:
        return _steps(args, tracer, grid, lead_names, lead_shape,
                      lead_coords, mesh, sharding)
    finally:
        cleanup()


def _steps(args, tracer, grid, lead_names, lead_shape, lead_coords,
           mesh=None, sharding=None) -> int:
    """Build the subcommand's step (its sharded step on a mesh) and run
    it through :func:`_run`."""
    if mesh is None:
        keff, lwa = pipeline.keff_pipeline, pipeline.lwa_pipeline
        keff_lwa, clength = pipeline.keff_lwa_pipeline, \
            pipeline.clength_pipeline
        x_keys = ()
    else:
        from .parallel import pipeline as sp
        keff = functools.partial(sp.sharded_keff_pipeline, mesh=mesh)
        lwa = functools.partial(sp.sharded_lwa_pipeline, mesh=mesh)
        keff_lwa = functools.partial(sp.sharded_keff_lwa_pipeline, mesh=mesh)
        clength = functools.partial(sp.sharded_clength_pipeline, mesh=mesh)
        x_keys = sp.X_SHARDED
    streamed = dict(sharding=sharding, x_keys=x_keys)
    inc = not getattr(args, "decrease", False)
    lt = not getattr(args, "gt", False)
    pre_y = (to_numpy(grid.ydef)
             if getattr(args, "interp_eq", False) else None)
    pre_y_t = None if pre_y is None else grid.ydef

    if args.cmd == "keff":
        def step(t):
            return keff(t, grid, pre_y=pre_y_t, N=args.N,
                                          increase=inc, lt=lt,
                                          hist=not args.no_hist,
                                          lmin=args.lmin)
    elif args.cmd == "lwa":
        def step(t):
            return lwa(t, grid, N=args.N, increase=inc,
                                         lt=lt, part=args.part,
                                         metric=args.metric,
                                         lwa_method=args.lwa_method)
    elif args.cmd == "keff-lwa":
        def step(t):
            return keff_lwa(t, grid, pre_y=pre_y_t,
                                              N=args.N, increase=inc, lt=lt,
                                              lmin=args.lmin,
                                              with_lwa2=args.with_lwa2,
                                              metric=args.metric,
                                              lwa_method=args.lwa_method)
    elif args.cmd == "clength":
        def step(t):
            return clength(t, grid, N=args.N, increase=inc, lt=lt)
    elif args.cmd == "local-length":
        from .diagnostics.local_length import _window_centers
        from .parallel.local_length import sharded_local_lengths

        Ny, Nx = grid.shape
        if not 2 <= args.window <= min(Ny, Nx):
            raise SystemExit(f"--window {args.window} must be in "
                             f"[2, min(Ny, Nx) = {min(Ny, Nx)}]")
        if args.stride < 1:
            raise SystemExit(f"--stride must be >= 1, got {args.stride}")

        kw = dict(window=args.window, stride=args.stride,
                  min_count=args.min_count)

        def step(t):
            if mesh is None:  # one rolling mean and one K8 launch a chunk
                return {"llen": pipeline.local_length_pipeline(
                    t, grid, **kw)["llen"]}
            # the sharded windows, K8 once a snapshot
            return {"llen": torch.stack([sharded_local_lengths(
                s, grid.ydef, grid.xdef, mesh, latlon=grid.latlon,
                **kw)[0] for s in t])}

        # window-center coordinates depend only on grid + window/stride
        # (the kernel's own _window_centers formula -- no probe run needed)
        oy = np.arange(0, Ny - args.window + 1, args.stride)
        ox = np.arange(0, Nx - args.window + 1, args.stride)
        wy, wx = _window_centers(to_numpy(grid.ydef), to_numpy(grid.xdef),
                                 oy, ox, args.window)
        return _run(args, step, grid, tracer, lead_names, lead_shape,
                    lead_coords,
                    extra_coords={"y_window": wy, "x_window": wx},
                    dim_hints={"llen": ("y_window", "x_window")},
                    sharding=sharding)
    elif args.cmd == "fractal":
        strides = tuple(int(s) for s in args.strides.split(","))
        Ny, Nx = grid.shape
        bad = [s for s in strides if Ny % s or Nx % s]
        if bad:
            raise SystemExit(f"--strides {bad} do not divide the grid "
                             f"{(Ny, Nx)}")

        def step(t):
            if mesh is not None and mesh.shape[1] > 1:
                # the step whole on every x rank, as GSPMD replicates it
                from .parallel import _comm
                t = _comm.all_gather(t, mesh.get_group("x"), dim=-1)
            return pipeline.fractal_pipeline(
                t, grid, N=args.N, strides=strides, increase=inc, lt=lt,
                box_counting=not args.no_box_counting)
    else:  # pragma: no cover -- argparse enforces choices
        raise SystemExit(f"unknown command {args.cmd!r}")

    return _run(args, step, grid, tracer, lead_names, lead_shape,
                lead_coords, pre_y=pre_y, **streamed)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
