"""ctypes loader for the native marching-squares traversal
(``xcontour_tpu_torch/csrc/marching.cpp``).

Counterpart of ``xcontour_tpu/host/native.py``.  At first use ``g++ -O3
-shared -fPIC -std=c++17`` compiles the source into
``build/xcontour_tpu_torch/libmarching_<hash>.so`` beside the package (the
hash covers the source and flags, as ``kernels/_build.py`` names the CUDA
library), never inside the package.  Where no compiler or no source is
found, :func:`find_contours` takes the NumPy traversal
:func:`find_contours_numpy`, which has the same per-cell rules and
assembly: the JAX package's documented behaviour for a machine without a
compiler.  :func:`_load` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from ..kernels._build import BUILD_DIR, CSRC_DIR

_SRC = CSRC_DIR / "marching.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _library_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libmarching_{h.hexdigest()[:16]}.so"


def _build() -> Optional[str]:
    """The library's path, compiled first if this source has not been
    built; None where there is no source or the compiler fails."""
    if not _SRC.exists():
        return None
    out = _library_path()
    if out.exists():
        return str(out)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
            tmp = os.path.join(td, out.name)
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError):
        return None
    return str(out)


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded on the first call; None when
    it cannot be (then the NumPy traversal runs)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.xc_find_contours.restype = ctypes.c_longlong
    lib.xc_find_contours.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    _LIB = lib
    return _LIB


def find_contours_native(data: np.ndarray, level: float) -> Optional[List[np.ndarray]]:
    """Native traversal; returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    d = np.ascontiguousarray(data, np.float64)
    ny, nx = d.shape
    cap = max(4 * ny * nx, 1024)
    for _ in range(3):  # grow on overflow
        verts = np.empty((cap, 2), np.float64)
        seg_lens = np.empty(cap, np.int64)
        n_segs = ctypes.c_longlong(0)
        n = lib.xc_find_contours(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ny, nx,
            float(level), verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap, seg_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            cap, ctypes.byref(n_segs))
        if n >= 0:
            out = []
            off = 0
            for k in range(n_segs.value):
                ln = int(seg_lens[k])
                out.append(verts[off:off + ln].copy())
                off += ln
            return out
        cap *= 4
    raise RuntimeError("marching-squares output exceeded capacity")


def find_contours_numpy(data: np.ndarray, level: float) -> List[np.ndarray]:
    """Pure-NumPy traversal with identical per-cell rules and assembly."""
    d = np.asarray(data, np.float64)
    ny, nx = d.shape
    v00, v01 = d[:-1, :-1], d[:-1, 1:]
    v10, v11 = d[1:, :-1], d[1:, 1:]
    ok = ~(np.isnan(v00) | np.isnan(v01) | np.isnan(v10) | np.isnan(v11))
    a00, a01 = (v00 > level) & ok, (v01 > level) & ok
    a10, a11 = (v10 > level) & ok, (v11 > level) & ok

    def frac(a, b):
        dd = b - a
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (level - a) / np.where(dd == 0, 1.0, dd)
        return np.where(dd == 0, 0.0, f)

    rr, cc = np.meshgrid(np.arange(ny - 1, dtype=float),
                         np.arange(nx - 1, dtype=float), indexing="ij")
    top = np.stack([rr, cc + frac(v00, v01)], -1)
    bot = np.stack([rr + 1, cc + frac(v10, v11)], -1)
    lef = np.stack([rr + frac(v00, v10), cc], -1)
    rig = np.stack([rr + frac(v01, v11), cc + 1], -1)

    segs = []

    def emit(maskc, p, q):
        for r, c in zip(*np.nonzero(maskc)):
            a = tuple(p[r, c]); b = tuple(q[r, c])
            if a != b:
                segs.append((a, b))

    iso00 = ok & (a00 != a01) & (a00 != a10) & (a01 == a11)
    iso01 = ok & (a01 != a00) & (a01 != a11) & (a00 == a10)
    iso10 = ok & (a10 != a00) & (a10 != a11) & (a00 == a01)
    iso11 = ok & (a11 != a01) & (a11 != a10) & (a01 == a00)
    horiz = ok & (a00 == a01) & (a10 == a11) & (a00 != a10)
    verti = ok & (a00 == a10) & (a01 == a11) & (a00 != a01)
    sadm = a00 & a11 & ~a01 & ~a10
    sada = a01 & a10 & ~a00 & ~a11
    emit(iso00, top, lef); emit(iso01, top, rig)
    emit(iso10, bot, lef); emit(iso11, bot, rig)
    emit(horiz, lef, rig); emit(verti, top, bot)
    emit(sadm, top, lef); emit(sadm, bot, rig)
    emit(sada, top, rig); emit(sada, bot, lef)

    # assemble chains
    adj = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    used = set()
    out = []

    def walk(start):
        line = [start]
        used.add(start)
        prev, cur = None, start
        while True:
            nxt = next((nb for nb in adj[cur]
                        if nb != prev and nb not in used), None)
            if nxt is None:
                # end of an open chain — or a ring, which closes back onto
                # its (already-used) start
                if len(line) > 2 and start in adj[cur]:
                    line.append(start)
                break
            prev, cur = cur, nxt
            used.add(cur)
            line.append(cur)
        if len(line) >= 2:
            out.append(np.asarray(line))

    # open chains first (walk outward from degree-1 endpoints), then any
    # remaining closed rings
    for p, nbrs in adj.items():
        if len(nbrs) == 1 and p not in used:
            walk(p)
    for p in adj:
        if p not in used:
            walk(p)
    return out


def find_contours(data: np.ndarray, level: float) -> List[np.ndarray]:
    """Marching-squares polylines of ``data`` at ``level``: the native
    traversal where it loads, the NumPy one else."""
    res = find_contours_native(data, level)
    if res is None:
        res = find_contours_numpy(data, level)
    return res
