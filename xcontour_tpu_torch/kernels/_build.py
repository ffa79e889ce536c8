"""Build the CUDA sources into one shared library and bind it with ctypes.

At first use, one ``nvcc`` per ``xcontour_tpu_torch/csrc/*.cu``, all started
together, compiles the sources, and a last one links them into
``build/xcontour_tpu_torch/libxcontour_<hash>.so`` beside the package (the
hash covers the sources, the ``*.cuh`` headers they share with the probes
of ``probes.cu``, and the flags, so an edit rebuilds).  The library has a
plain C interface: pointers and the stream are ``void*``, sizes ``int``,
and every entry point returns the launch's ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "xcontour_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I = ctypes.c_void_p, ctypes.c_int

# C entry points: name -> argtypes (restype is int, a cudaError_t)
SIGNATURES = {
    # q, rdx, rdy, out, B, Ny, Nx, periodic_x, bc_y, stream
    "xc_squared_gradient": [P, P, P, P, I, I, I, I, I, P],
    # values, edges, weights, partial, out, B, G, N, C, nrange, nblk,
    # wchunk, ncopy, stream
    "xc_weighted_cdf": [P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # q, W, Q, c0, E, tot, out, B, Ny, Nx, increase, stream
    "xc_lwa_lin": [P, P, P, P, P, P, P, I, I, I, I, P],
    # q, Wz, Q, out, out2 (part 3, split: the lower half), B, Ny, Nx,
    # increase, part, variant2, stream
    "xc_lwa_dense": [P, P, P, P, P, I, I, I, I, I, I, P],
    # q, Q, W, c0, E, out, B, Ny, Nx, increase, stream
    "xc_lwa_lin2": [P, P, P, P, P, P, I, I, I, I, P],
    # data, levels, order, y, x, acc, out, B, Ny, Nx, N, n_rb, n_cb,
    # y_batched, x_batched, latlon, stream
    "xc_contour_lengths": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P],
    # data, levels, y, x, acc, out, B, Ny, Nx, Wy, Wx, window, stride, nby,
    # nbx, nbw, latlon, stream
    "xc_local_lengths": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I,
                         P],
    # raw, mask, out, B, Ny, Nx, in_bytes, out_bytes, swap, flip, stream
    "xc_decode_planes": [P, P, P, I, I, I, I, I, I, I, P],
    # data, area, levels, partial, count, out, B, Ny, W, N, S, quirks,
    # table (host), blocks, stream
    "xc_box_counts": [P, P, P, P, P, P, I, I, I, I, I, I, P, I, P],
    # data, fill, out, B, Ny, Nx, Wy, Wx, window, stride, min_count,
    # itemsize, TX, TY, ntx, nty, threads, cols, nch_max, stream
    "xc_window_means": [P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                        I, P],
    # the structure probes (csrc/probes.cu)
    # q, W, Q, out, B, Ny, Nx, stream
    "xc_lwa_structure": [P, P, P, P, I, I, I, P],
    # values, edges, weights, partial, out, B, G, N, nblk, wchunk, stream
    "xc_hist_structure": [P, P, P, P, P, I, I, I, I, I, P],
    # data, levels, y, x, partial, out, B, Ny, Nx, N, n_rb, n_cb,
    # y_batched, x_batched, stream
    "xc_length_structure": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # q, out, B, Ny, Nx, stream
    "xc_scaled_copy": [P, P, I, I, I, P],
}

_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """The library the current sources, headers and flags build to."""
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    return BUILD_DIR / f"libxcontour_{_digest(srcs)}.so"


def build() -> Path:
    """Compile the library if this exact source set has not been built;
    return its path.  The compilers' output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it, see
    :func:`build_log`."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = Path(tmp) / out.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)
    return out


def build_log() -> str:
    """The compiler's output for the current library (building it first)."""
    return build().with_suffix(".log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the runner's copy
    thread and the caller's may both make the first)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB
