"""Batch runner: stream large snapshot archives through a pipeline step.

Counterpart of ``xcontour_tpu/runner.py``.  The reference's production
script (tests/LWA.py) is a Python double loop over time and level, writing
one NetCDF at the end: no overlap, no resume, and one bad snapshot kills
the whole archive.  This runner provides:

* batching in chunks of ``batch`` snapshots (the tail chunk runs at its own
  size: eager PyTorch compiles no program that a padded chunk would reuse,
  and every pipeline output is per snapshot);
* a two-stage prefetch: the host read of chunk k+2 (own thread, into
  pinned host memory) overlaps the host-to-device copy of chunk k+1 (own
  thread, on a dedicated CUDA stream) overlaps the compute of chunk k on
  the calling thread's current stream; a source that offers its raw
  planes (the CLI's nc3 archives) crosses as the file's bytes and is
  decoded on the card, on the copy stream;
* idempotent per-chunk outputs: each chunk writes ``<stem>_ck{k:05d}.npz``
  and is skipped when the file already exists, giving snapshot-granular
  checkpoint/resume;
* failure isolation: per-chunk retry with backoff, then, under
  ``on_error='skip'``, a structured ``<stem>_ck{k:05d}.failed`` record
  (JSON: chunk, valid count, error text) instead of an aborted archive;
  in-memory runs fill the failed chunk with NaN so time indices stay
  aligned.  Guards raised by a ``validate`` hook (``utils.checks``) land in
  the record;
* structured per-chunk logging (snapshots and wall time).

The chunk files and ``.failed`` records are those of the JAX runner: a stem
written by either loads in either ``load_chunks``.

With ``sharding=`` (what ``parallel.shard_batch_spec`` returns) the runner
runs on every rank of a ('batch', 'x') mesh: each rank reads its own block
of each chunk, the step runs sharded, and rank 0 gathers the outputs
through the process group and writes or returns them.  A run on one
process goes through the same stages, each status its own.
"""

from __future__ import annotations

import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .kernels import decode
from .utils import prof


def _failed_path(out_stem: str, k: int) -> str:
    return f"{out_stem}_ck{k:05d}.failed"


def _read_marker(path: str) -> dict:
    """Read a .failed record; a damaged marker names itself and its repair
    instead of surfacing a bare JSONDecodeError."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"failure marker {path} is unreadable ({e!r}); delete it and "
            "re-run run_batched(..., resume=True)") from e


class WireRangeError(ValueError):
    """``transfer_dtype`` cannot represent the data: a CONFIGURATION error
    (mis-scaled variable), deterministic on every retry.  The runner always
    re-raises it immediately: burning the retry/backoff schedule cannot heal
    it, and ``on_error='skip'`` must not degrade a config error into
    silently NaN-filled/failed chunks."""


def _device(device) -> torch.device:
    """The runner's device: ``None`` means the card, and there is no silent
    fall-back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_batched streams to the card "
                           "by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    ('bfloat16', which numpy lacks, included)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_wire_range(arr: np.ndarray, wire: torch.dtype) -> None:
    """Guard a transfer_dtype cast against silent range failure: values past
    the wire dtype's max become inf, and a chunk whose whole magnitude sits
    below its smallest normal collapses into subnormals where the relative
    rounding is percent-level, not the documented mantissa bound (f16 ~5e-4).
    One cheap host-side abs-max per chunk; raises with the repair."""
    fi = torch.finfo(wire)
    with np.errstate(invalid="ignore"):
        m = float(np.max(np.abs(arr))) if arr.size else 0.0
    if not np.isfinite(m):  # input carries inf/NaN legitimately (masks);
        fin = arr[np.isfinite(arr)]  # judge only the finite values
        m = float(np.max(np.abs(fin))) if fin.size else 0.0
    name = _dtype_name(wire)
    if m > float(fi.max):
        raise WireRangeError(
            f"transfer_dtype {name} cannot carry this chunk: "
            f"|values| reach {m:.4g} > its max {float(fi.max):.4g}, the "
            "wire cast would overflow to inf — rescale the variable "
            "(CLI: --scale-var) or drop the transfer compression")
    if 0.0 < m < float(fi.tiny):
        raise WireRangeError(
            f"transfer_dtype {name} cannot carry this chunk: "
            f"|values| peak at {m:.4g} < its smallest normal "
            f"{float(fi.tiny):.4g}, so the whole chunk lands in subnormals "
            "where relative rounding far exceeds the documented bound — "
            "rescale the variable (CLI: --scale-var) or drop the transfer "
            "compression")


def _to_wire(arr: np.ndarray, wire: torch.dtype, out: torch.Tensor) -> None:
    """Round ``arr`` to ``wire`` on the host, into ``out`` (int16, the
    narrowed bits), to nearest even as numpy's float16 and ml_dtypes'
    bfloat16 do, bit for bit: a NaN becomes the quiet NaN of its sign
    (torch's vectorized bfloat16 cast writes 0xffff for every NaN)."""
    if wire == torch.float16:
        np.copyto(out.numpy().view(np.float16), arr, casting="same_kind")
        return
    src = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    bits = out.view(torch.bfloat16)
    bits.copy_(src)
    nan = torch.isnan(src)
    if bool(nan.any()):
        quiet = torch.where(torch.signbit(src[nan]), -64, 0x7FC0)
        out[nan] = quiet.to(torch.int16)   # 0xFFC0 is int16 -64


def _fetch(out: Dict[str, object], dev: torch.device) -> Dict[str, np.ndarray]:
    """The step's outputs on the host.  From the card: each tensor copied
    into pinned host memory on the current stream without blocking, then
    one synchronize for the chunk (values identical to a per-key
    ``.cpu()``, which would synchronize once per output)."""
    res: Dict[str, np.ndarray] = {}
    host: Dict[str, torch.Tensor] = {}
    for k, v in out.items():
        if not isinstance(v, torch.Tensor):
            res[k] = np.asarray(v)
        elif v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v.detach(), non_blocking=True)
            host[k] = h
        else:
            res[k] = v.detach().numpy()
    if host:
        torch.cuda.current_stream(dev).synchronize()
        res.update({k: h.numpy() for k, h in host.items()})
    return {k: res[k] for k in out}


_OK, _FAIL, _WIRE = 0, 1, 2


def _silent(msg: str) -> None:
    pass


class _Solo:
    """A run on one process: its chunk is the whole chunk, and every status
    it agrees on is its own."""

    lead = True

    def __init__(self, batch: int):
        self.batch = batch

    def read(self, src, lo: int, T: int) -> np.ndarray:
        return np.asarray(src[lo:min(lo + self.batch, T)])

    def agree(self, code: int) -> int:
        return code

    def agree_done(self, flags) -> list:
        return list(flags)

    def errors(self, err):
        return err

    def gather(self, out, x_keys):
        return out


class _Sharded:
    """A rank's part in a sharded :func:`run_batched`: its block of each
    chunk and the agreements over the process group."""

    def __init__(self, spec, batch: int, shape, dev: torch.device):
        import torch.distributed as dist
        from .parallel import _comm
        self.dist, self.comm, self.spec = dist, _comm, spec
        (nb, nx), (ib, ix) = spec.sizes, spec.coords
        if batch % nb:
            raise ValueError(f"batch {batch} not divisible by the {nb}-way "
                             "batch axis")
        Nx = shape[-1]
        if Nx % nx:
            raise ValueError(f"grid Nx {Nx} not divisible by the {nx}-way "
                             "spatial axis")
        self.rows = batch // nb
        self.r0 = ib * self.rows
        self.cols = slice(ix * (Nx // nx), (ix + 1) * (Nx // nx))
        self.x0 = ix == 0
        self.lead = (ib, ix) == (0, 0)   # rank 0 of a mesh from make_mesh
        # NCCL reduces CUDA tensors only; gloo takes the CPU's
        self.flag_dev = dev if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def read(self, src, lo: int, T: int) -> np.ndarray:
        """This rank's block of the chunk from snapshot ``lo``: its rows
        (past the archive's end, its last snapshot again) and columns, the
        only part of the chunk it reads."""
        a = min(lo + self.r0, T - 1)
        b = max(a + 1, min(lo + self.r0 + self.rows, T))
        arr = np.asarray(src[a:b, :, self.cols])
        if arr.shape[0] < self.rows:
            arr = np.concatenate(
                [arr, np.repeat(arr[-1:], self.rows - arr.shape[0], 0)])
        return np.ascontiguousarray(arr)

    def _max(self, values):
        t = torch.tensor(values, dtype=torch.int32, device=self.flag_dev)
        return self.comm.max_(t, self.dist.group.WORLD).tolist()

    def agree(self, code: int) -> int:
        """The worst status over the group."""
        return self._max([code])[0]

    def agree_done(self, flags) -> list:
        """The lead's ``flags`` on every rank."""
        if not flags:
            return []
        return [bool(v) for v in
                self._max([int(f) if self.lead else 0 for f in flags])]

    def errors(self, err) -> RuntimeError:
        """One error naming each rank's failure (every rank calls it)."""
        msgs = [None] * self.dist.get_world_size()
        self.dist.all_gather_object(msgs, None if err is None else repr(err))
        return RuntimeError("; ".join(f"rank {r}: {m}"
                                      for r, m in enumerate(msgs) if m))

    def gather(self, out: Dict[str, torch.Tensor], x_keys):
        """The whole outputs on the lead, None elsewhere: each x-sharded
        key's blocks gathered from every rank, each replicated key's from
        the ranks of x index 0 only."""
        rows = self.spec.mesh.mesh.tolist()       # global ranks, (nb, nx)
        world = self.dist.group.WORLD
        whole = {}
        for k, v in out.items():
            if k in x_keys:
                parts = self.comm.gather(v, world, rows[0][0])
                if parts is not None:
                    whole[k] = torch.cat([torch.cat([parts[r] for r in row],
                                                    dim=-1) for row in rows])
            elif self.x0:
                parts = self.comm.gather(
                    v, self.spec.mesh.get_group("batch"), rows[0][0])
                if parts is not None:
                    whole[k] = torch.cat(parts)
        return whole if self.lead else None


def run_batched(step: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                snapshots, batch: int = 32,
                out_stem: Optional[str] = None,
                resume: bool = True, log: Callable[[str], None] = print,
                retries: int = 0, on_error: str = "raise",
                retry_wait: float = 0.25,
                validate: Optional[Callable[[Dict[str, np.ndarray]], None]]
                = None, device=None,
                transfer_dtype=None, sharding=None,
                x_keys=()) -> Optional[Dict[str, np.ndarray]]:
    """Run ``step`` over ``snapshots`` (T, Ny, Nx) in chunks of ``batch``.

    With ``out_stem`` set, results are written per chunk and already-written
    chunks are skipped (resume); returns None.  Without it, results are
    concatenated in memory and returned as numpy arrays.

    ``snapshots`` may be any sliceable (T, ...) source in native byte order
    -- an ndarray, a ``np.memmap``, or an object with ``shape`` and
    ``__getitem__`` (lazy loaders) -- so archives larger than host or
    device memory stream through.  A classic netCDF file's raw memmap is
    big-endian and is refused here: pass it through the CLI's
    ``_LazyField``, which decodes it.

    A source that offers its raw planes (``raw_planes()`` returning a
    ``kernels.decode.Planes``, and ``raw_into(rows, out)``; the CLI's
    ``_LazyField`` over an nc3 memmap or an ndarray) takes the raw path
    when neither ``transfer_dtype`` nor ``sharding`` is given: the read
    thread copies each chunk's file bytes unchanged into the pinned block,
    and the copy thread, after the host-to-device copy, decodes them on the
    copy stream (``kernels.decode.decode_planes``: byte order, latitude
    flip, cast and fluid mask, the mask uploaded once), so the card, not
    the host, brings an archive's big-endian planes to the run's dtype.

    ``device``: where ``step`` runs; ``None`` is the card (and raises
    without one), ``'cpu'`` the CPU.  On the card each chunk is read into
    pinned host memory, copied on a dedicated stream, and ``step`` is
    called on this thread's current stream once the copy has landed; so
    the kernels the step launches run here, on that stream.  Its stages
    are spans (``utils.prof.span``): ``runner.read`` (the read of the
    chunk; on the raw path the copy of its bytes into the pinned block)
    and ``runner.pin`` (the pinned block and the copy or wire cast into it;
    on the raw path the taking of the block alone) on the read thread;
    ``runner.wait`` (for the chunk's copy), ``runner.step``,
    ``runner.fetch`` and ``runner.write`` on this one.

    ``sharding`` (a ``parallel.mesh.BlockSpec``, from
    ``parallel.shard_batch_spec(mesh, 3)``) runs the chunks over a mesh.
    Every rank of the process group calls ``run_batched`` with the same
    arguments, on its own ``device``: it reads only its (batch, x) block
    of each chunk (``snapshots[rows, :, cols]``, which an ndarray, a
    memmap, an h5py dataset and the CLI's ``_LazyField`` take) into pinned
    memory and copies it on the copy stream, and ``step`` gets that block
    and returns the rank's blocks of its outputs: the keys in ``x_keys``
    sharded over 'x' along their last axis, every other key replicated
    over 'x'.  The tail chunk is padded to ``batch`` with its last
    snapshot (as the JAX runner pads every tail), so each batch rank holds
    ``batch / batch shards`` snapshots.  The lead (rank 0, at the mesh's
    (0, 0)) gathers the outputs through the group (an x-sharded key from
    every rank, a replicated key from the ranks of x index 0), fetches,
    validates and writes or returns them; the other ranks return None.
    Resume (the lead's chunk files), retries, ``on_error`` and
    ``validate`` reach the same decision on every rank: each stage's
    status is all-reduced over the group before anyone writes, retries or
    skips, and a failure's text names the rank it came from.  A rank that
    raises inside a collective of the step leaves the others waiting there
    until the group's timeout (give ``init_process_group`` one).

    ``transfer_dtype`` (``torch.float16``, ``torch.bfloat16``, or a numpy
    ``float16``) narrows the host-to-device payload: chunks are rounded on
    the host (to nearest even, bit for bit as the JAX runner's numpy and
    ml_dtypes casts), travel as an int16 view, and are upcast back to the
    source dtype on the device before ``step`` runs -- compute precision is
    unchanged, only the INPUT is rounded (f16: 11 significand bits, ~5e-4
    relative; bf16: 8 bits, ~4e-3).  A chunk the wire dtype cannot carry
    raises :class:`WireRangeError` at once.

    Failure handling: each chunk is attempted ``retries + 1`` times (with
    ``retry_wait * 2**attempt`` backoff).  ``validate(out_np)`` runs after
    each fetch and may raise to reject the chunk (e.g. NaN guards or a
    ``utils.checks`` ``err.throw()``).  When attempts are exhausted,
    ``on_error='raise'`` re-raises; ``on_error='skip'`` records the failure
    and continues with the remaining chunks.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    dev = _device(device)
    cuda = dev.type == "cuda"
    src_dtype = np.dtype(getattr(snapshots, "dtype", np.float32))
    if not src_dtype.isnative:
        raise TypeError(
            f"snapshots are {src_dtype.str} (non-native byte order, e.g. a "
            "classic netCDF memmap); convert each chunk to native order "
            "first (astype(float32), as the CLI's _LazyField does)")
    full = _torch_dtype(src_dtype)
    wire = None
    if transfer_dtype is not None:
        wire = _torch_dtype(transfer_dtype)
        if wire.itemsize >= full.itemsize:
            raise ValueError(
                f"transfer_dtype {_dtype_name(wire)} is not narrower than "
                f"the source dtype {src_dtype}; compression would be a "
                "no-op")
        if wire not in (torch.float16, torch.bfloat16):
            raise ValueError(f"transfer_dtype {_dtype_name(wire)}: expected "
                             "float16 or bfloat16")
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    T = snapshots.shape[0]
    planes = None
    if wire is None and sharding is None:
        offer = getattr(snapshots, "raw_planes", None)
        planes = offer() if offer is not None else None
    if planes is not None:
        raw_row = snapshots.shape[1:-1] + (
            snapshots.shape[-1] * planes.file_dtype.itemsize,)
        mask = None if planes.mask is None else \
            torch.from_numpy(np.ascontiguousarray(planes.mask)).to(dev)
    nchunk = -(-T // batch)
    collected: List[Optional[Dict[str, np.ndarray]]] = []
    nvalids: List[int] = []
    failures: List[int] = []
    mesh = _Solo(batch) if sharding is None else \
        _Sharded(sharding, batch, snapshots.shape, dev)
    if not mesh.lead:
        log = _silent  # the lead logs for the mesh

    # two-stage prefetch pipeline (read || copy || compute): the host read
    # (+ wire cast) of chunk k+2 runs on its own thread WHILE the copy of
    # chunk k+1 is in flight and chunk k computes
    def read_chunk(k):
        """Stage 1 (read thread): slice, optional wire narrowing, and the
        copy into a (pinned) host tensor -- ALL host-side work.  Pinned
        blocks come from torch's caching host allocator, which reuses one
        only after the copy that read it has completed.  On the raw path
        the block holds the chunk's file bytes."""
        if planes is not None:
            lo, hi = k * batch, min((k + 1) * batch, T)
            with prof.span("runner.pin"):
                host = torch.empty((hi - lo,) + raw_row, dtype=torch.uint8,
                                   pin_memory=cuda)
            with prof.span("runner.read"):
                snapshots.raw_into(slice(lo, hi), host.numpy())
            return host
        with prof.span("runner.read"):
            arr = mesh.read(snapshots, k * batch, T)
        with prof.span("runner.pin"):
            if wire is not None:
                _check_wire_range(arr, wire)
                host = torch.empty(arr.shape, dtype=torch.int16,
                                   pin_memory=cuda)
                _to_wire(arr, wire, host)
            else:
                host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype),
                                   pin_memory=cuda)
                np.copyto(host.numpy(), arr)
        return host

    def ship(read_fut):
        """Stage 2 (copy thread): host to device on the copy stream, and on
        the raw path the decode after it; returns the device tensor and the
        event recorded after both."""
        host = read_fut.result()
        if not cuda:
            if planes is not None:
                host = decode.decode_planes(host, planes, mask)
            return host, None
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            x = host.to(dev, non_blocking=True)
            if planes is not None:
                x = decode.decode_planes(x, planes, mask)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return x, ev

    def chunk_array(k):
        """Composed read+ship, for the retry re-read path (runs on the copy
        thread; the read still routes through the read thread so the source
        is only ever touched by one thread)."""
        return ship(read_pool.submit(read_chunk, k))

    def land(shipped):
        """On this thread: wait (on the device) for the chunk's copy, keep
        its memory from reuse until this stream is done with it, and undo
        the wire narrowing."""
        x, ev = shipped
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            x.record_stream(cur)
        if wire is not None:
            x = x.view(wire).to(full)
        return x

    def compute(x):
        """The step on the chunk (a rank's block of it), its outputs
        checked for a snapshot axis."""
        with prof.span("runner.step"):
            out = step(x)
        bad = [key for key, v in out.items() if getattr(v, "ndim", 1) == 0]
        if bad:
            raise ValueError(
                f"step outputs must keep a leading snapshot axis; 0-d "
                f"outputs {bad} cannot be trimmed to the valid tail-chunk "
                "snapshots -- return per-snapshot values and reduce after "
                "load")
        return out

    def finish(whole, nvalid):
        """On the lead: the outputs on the host, trimmed to the valid
        snapshots, validated."""
        out_np = {key: v[:nvalid] for key, v in _fetch(whole, dev).items()}
        if validate is not None:
            validate(out_np)
        return out_np

    def nvalid_of(k):
        return min((k + 1) * batch, T) - k * batch

    def exists(k):
        return (out_stem is not None and resume
                and os.path.exists(f"{out_stem}_ck{k:05d}.npz"))

    # the lead's chunk files decide for every rank
    done = mesh.agree_done([exists(k) for k in range(nchunk)])

    # a resumed archive must not be re-read/re-copied just to skip:
    # prefetch targets the NEXT chunk that will actually compute
    def next_todo(k0):
        for k in range(k0, nchunk):
            if not done[k]:
                return k
        return None

    def run_chunk(k, shipped, wire_err):
        """(ok, outputs on the lead, error) of chunk k: each stage's status
        is agreed over the mesh before any rank goes on, so all ranks
        retry, skip or raise together."""
        nvalid, last_err = nvalid_of(k), None
        for a in range(retries + 1):
            err, code, out_np = wire_err, _WIRE if wire_err else _OK, None
            wire_err = None
            if code == _OK:
                try:
                    if shipped is None:  # prefetch (or a prior re-read)
                        # failed; go through the pools: the source must
                        # only ever be touched by one thread
                        shipped = ship_pool.submit(chunk_array, k).result()
                    x = land(shipped)
                except Exception as e:  # noqa: BLE001 -- agreed below
                    err = e
                    code = _WIRE if isinstance(e, WireRangeError) else _FAIL
                    shipped = None
            code = mesh.agree(code)
            if code == _OK:
                try:
                    out = compute(x)
                except Exception as e:  # noqa: BLE001 -- agreed below
                    err, code = e, _FAIL
                code = mesh.agree(code)
            if code == _OK:
                with prof.span("runner.fetch"):
                    whole = mesh.gather(out, x_keys)
                    if mesh.lead:
                        try:
                            out_np = finish(whole, nvalid)
                        except Exception as e:  # noqa: BLE001
                            err, code = e, _FAIL
                code = mesh.agree(code)
            if code == _OK:
                return True, out_np, None
            last_err = mesh.errors(err)
            if code == _WIRE:
                # a config error: retrying or skipping cannot heal it
                if isinstance(last_err, WireRangeError):
                    raise last_err
                raise WireRangeError(str(last_err))
            if a < retries:
                wait = retry_wait * (2 ** a)
                log(f"[runner] chunk {k + 1}/{nchunk}: attempt {a + 1} "
                    f"failed ({last_err}); retrying in {wait:.2f}s")
                time.sleep(wait)
        return False, None, last_err

    # one single-worker pool per pipeline stage: each source/resource is
    # only ever touched by ONE thread (h5py is not thread-safe for
    # concurrent access; copies serialize on the link anyway), and the
    # stages overlap -- read(k+2) || copy(k+1) || compute(k)
    read_pool = ThreadPoolExecutor(max_workers=1)
    ship_pool = ThreadPoolExecutor(max_workers=1)

    try:
        k1 = next_todo(0)
        k2 = next_todo(k1 + 1) if k1 is not None else None
        # submit read(k1) from HERE, before read(k2), so the single read
        # worker reads k1 first
        rf1 = read_pool.submit(read_chunk, k1) if k1 is not None else None
        pending_ship = (k1, ship_pool.submit(ship, rf1)) \
            if k1 is not None else (None, None)
        pending_read = (k2, read_pool.submit(read_chunk, k2)) \
            if k2 is not None else (None, None)
        for k in range(nchunk):
            nvalids.append(nvalid_of(k))
            path = f"{out_stem}_ck{k:05d}.npz" if out_stem else None
            if pending_ship[0] != k:
                log(f"[runner] chunk {k + 1}/{nchunk}: exists, skipped")
                continue
            # a prefetch-thread read failure (transient disk/HDF5 error on
            # lazy inputs) flows through the SAME retries + on_error
            # machinery as a compute failure
            shipped, wire_err = None, None
            try:
                with prof.span("runner.wait"):
                    shipped = pending_ship[1].result()
            except WireRangeError as e:
                wire_err = e  # every rank hears of it before it raises
            except Exception as e:  # noqa: BLE001 -- re-read under retries
                log(f"[runner] chunk {k + 1}/{nchunk}: prefetch read "
                    f"failed ({e}); re-reading under the retry policy")
            # promote the read chunk to the copy stage and start the read
            # after it -- the two stages advance independently
            if pending_read[0] is not None:
                rk, rf = pending_read
                pending_ship = (rk, ship_pool.submit(ship, rf))
                nxt = next_todo(rk + 1)
                pending_read = (nxt, read_pool.submit(read_chunk, nxt)) \
                    if nxt is not None else (None, None)
            else:
                pending_ship = (None, None)

            t0 = time.perf_counter()
            nvalid = nvalid_of(k)
            ok, out_np, last_err = run_chunk(k, shipped, wire_err)

            if not ok:
                if on_error == "raise":
                    raise last_err
                failures.append(k)
                log(f"[runner] chunk {k + 1}/{nchunk}: FAILED after "
                    f"{retries + 1} attempts: {last_err}")
                if not mesh.lead:
                    continue
                if path:
                    rec = {"chunk": k, "nvalid": nvalid,
                           "error": repr(last_err)}
                    tmp = _failed_path(out_stem, k) + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(rec, f)
                    os.replace(tmp, _failed_path(out_stem, k))
                else:
                    collected.append(None)
                continue

            if not mesh.lead:
                continue
            dt = time.perf_counter() - t0
            log(f"[runner] chunk {k + 1}/{nchunk}: {nvalid} snapshots "
                f"in {dt:.3f}s ({nvalid / dt:.1f}/s)")

            if path:
                with prof.span("runner.write"):
                    tmp = path + ".tmp.npz"
                    np.savez(tmp, **out_np)
                    os.replace(tmp, path)  # atomic: complete or absent
                failed = _failed_path(out_stem, k)
                if os.path.exists(failed):  # a retry succeeded on resume
                    os.remove(failed)
            else:
                # copied out of the fetch's pinned blocks, which the next
                # chunk's fetch then reuses: only the chunks in flight stay
                # page-locked, however long the archive
                collected.append({key: np.array(v)
                                  for key, v in out_np.items()})
    finally:
        ship_pool.shutdown(wait=True)
        read_pool.shutdown(wait=True)

    if failures:
        log(f"[runner] {len(failures)}/{nchunk} chunks failed: {failures}")
    if out_stem or not mesh.lead:
        return None
    good = next((c for c in collected if c is not None), None)
    if good is None:
        raise RuntimeError("all chunks failed; nothing to return") from None
    return _assemble(collected, nvalids, good)


def _assemble(chunks, nvalids, good) -> Dict[str, np.ndarray]:
    """Concatenate chunk outputs along the snapshot axis, a failed chunk
    (None) NaN-filled so time indices stay aligned with the archive."""
    parts: Dict[str, List[np.ndarray]] = {}
    for c, nv in zip(chunks, nvalids):
        for key in good:
            if c is not None:
                parts.setdefault(key, []).append(c[key])
            else:
                shape = (nv,) + good[key].shape[1:]
                parts.setdefault(key, []).append(
                    np.full(shape, np.nan, dtype=good[key].dtype))
    return {k: np.concatenate(v, axis=0) for k, v in parts.items()}


def load_chunks(out_stem: str, allow_failed: bool = False,
                expect_chunks: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Reassemble results written by :func:`run_batched` (this runner's or
    the JAX package's: the files are the same).

    Chunks recorded as failed (``*.failed`` markers) raise unless
    ``allow_failed=True``, in which case they are NaN-filled using the shape
    of the surviving chunks so the time axis stays aligned.

    ``expect_chunks`` (when the caller knows ``ceil(T / batch)``) extends the
    gap guard to MISSING TRAILING chunks -- without it only interior holes
    are detectable, and a lost last chunk file would silently truncate the
    reassembled time axis.
    """
    # a process killed mid-write leaves `*_ck*.npz.tmp.npz` (os.replace makes
    # the real chunk atomic) -- in-flight litter, not data
    files = sorted(f for f in glob.glob(f"{out_stem}_ck*.npz")
                   if not f.endswith(".tmp.npz"))
    markers = sorted(glob.glob(f"{out_stem}_ck*.failed"))
    if not files and not markers:
        raise FileNotFoundError(f"no chunks matching {out_stem}_ck*.npz")
    if markers and not allow_failed:
        detail = [_read_marker(m) for m in markers]
        raise RuntimeError(
            f"{len(markers)} failed chunk(s) under {out_stem}: {detail}; "
            "re-run run_batched(..., resume=True) to retry them or pass "
            "allow_failed=True to NaN-fill")

    def _index(path: str) -> int:
        stem = os.path.basename(path)
        return int(stem.rsplit("_ck", 1)[1].split(".")[0])

    chunks: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
    nvalid: Dict[int, int] = {}
    # a corrupt/truncated chunk file must not surface as a zipfile/pickle
    # traceback: name the file and the repair (.npz writes are atomic via
    # os.replace, so this only happens to externally damaged files)
    for f in files:
        try:
            with np.load(f) as z:
                chunks[_index(f)] = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 -- any unreadable chunk
            raise RuntimeError(
                f"checkpoint chunk {f} is corrupt or unreadable ({e!r}); "
                "delete it and re-run run_batched(..., resume=True) to "
                "regenerate it") from e
    for m in markers:
        rec = _read_marker(m)
        if rec["chunk"] not in chunks:
            chunks[rec["chunk"]] = None
            nvalid[rec["chunk"]] = rec["nvalid"]

    good = next((c for c in chunks.values() if c is not None), None)
    if good is None:
        raise RuntimeError(
            f"all {len(markers)} chunk(s) under {out_stem} failed; nothing "
            "to assemble — fix the step and re-run run_batched(..., "
            "resume=True)")
    # a hole in the index sequence (e.g. a manually deleted chunk file with
    # no .failed marker) would silently misalign the reassembled time axis;
    # expect_chunks additionally catches missing TRAILING chunks
    top = max(max(chunks) + 1, expect_chunks or 0)
    missing = sorted(set(range(top)) - set(chunks))
    if missing:
        raise RuntimeError(
            f"chunk index gap under {out_stem}: missing {missing} of "
            f"0..{top - 1}; re-run run_batched(..., resume=True) to "
            "regenerate them")
    order = sorted(chunks)
    return _assemble([chunks[k] for k in order],
                     [nvalid.get(k, 0) for k in order], good)
