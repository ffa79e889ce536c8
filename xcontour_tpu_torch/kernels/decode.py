"""The archive decode: raw file planes into snapshots (CUDA:
``csrc/decode.cu``).

``runner.run_batched`` reads a source that offers its raw planes (the
CLI's ``_LazyField`` over a classic netCDF memmap or an ndarray) as the
file stores them: the read thread copies the bytes unchanged into pinned
memory, and the copy thread, after the host-to-device copy, launches
:func:`decode_planes` on the copy stream.  One launch a chunk does what the
host did before: the byte order (big- or little-endian float32 or
float64), the flip of a descending latitude, the cast to the run's dtype
and the fluid mask (NaN where it is 0).  The JAX package has no such
kernel: its CLI decodes on the host (``xcontour_tpu/cli.py:133``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import Kernel, check_status, stream_handle

KERNEL = Kernel("decode_planes", "xcontour_tpu_torch/csrc/decode.cu",
                "xcontour_tpu/cli.py:133 (a host read; no TPU kernel)")

# the file dtypes the decode takes
FILE_DTYPES = frozenset(np.dtype(s) for s in (">f4", "<f4", ">f8", "<f8"))


@dataclasses.dataclass(frozen=True)
class Planes:
    """How a source's raw planes become its snapshots: the file's dtype
    (one of :data:`FILE_DTYPES`), whether rows are flipped (output row r is
    file row Ny - 1 - r), the fluid mask ((Ny, Nx) bool in output rows,
    False where a cell is NaN'd; None keeps every cell: the runner uploads
    it once and hands it to :func:`decode_planes`) and the run's dtype."""

    file_dtype: np.dtype
    flip: bool
    mask: Optional[np.ndarray]
    dtype: np.dtype


def decode_planes_plain(raw: torch.Tensor, planes: Planes,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """raw (B, Ny, Nx * itemsize) uint8 -> (B, Ny, Nx) of ``planes.dtype``;
    ``mask`` (Ny, Nx) bool on raw's device, or None."""
    size = planes.file_dtype.itemsize
    B, Ny, nb = raw.shape
    cells = raw.reshape(B, Ny, nb // size, size)
    if not planes.file_dtype.isnative:
        cells = cells.flip(-1)
    native = torch.float32 if size == 4 else torch.float64
    v = cells.contiguous().view(native).reshape(B, Ny, nb // size)
    if planes.flip:
        v = v.flip(-2)
    v = v.to(_torch_dtype(planes.dtype))
    if mask is not None:
        v = torch.where(mask, v, float("nan"))
    return v.contiguous()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def decode_planes(raw: torch.Tensor, planes: Planes,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The snapshots (B, Ny, Nx) of a chunk's raw planes ``raw`` (B, Ny,
    Nx * itemsize) uint8, decoded as ``planes`` says: ``planes``' byte
    order, flip and dtype, and ``mask`` ((Ny, Nx) bool on raw's device,
    False where a cell is NaN'd; None keeps every cell).  CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    (the card's byte order is the host's, little-endian, so a non-native
    file dtype is swapped)."""
    if planes.file_dtype not in FILE_DTYPES:
        raise TypeError(f"{KERNEL.name}: file dtype {planes.file_dtype.str} "
                        f"is not one of {sorted(d.str for d in FILE_DTYPES)}")
    if np.dtype(planes.dtype) not in (np.float32, np.float64):
        raise TypeError(f"{KERNEL.name}: output dtype {planes.dtype} is not "
                        "float32 or float64")
    if raw.dtype != torch.uint8 or raw.dim() != 3 \
            or raw.shape[2] % planes.file_dtype.itemsize:
        raise ValueError(f"{KERNEL.name}: raw must be (B, Ny, Nx * "
                         f"{planes.file_dtype.itemsize}) uint8, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    B, Ny, nb = raw.shape
    Nx = nb // planes.file_dtype.itemsize
    if mask is not None and (mask.shape != (Ny, Nx)
                             or mask.dtype != torch.bool
                             or mask.device != raw.device):
        raise ValueError(f"{KERNEL.name}: mask must be an ({Ny}, {Nx}) "
                         f"bool tensor on {raw.device}")
    if raw.device.type == "cpu":
        return decode_planes_plain(raw, planes, mask)
    if raw.device.type != "cuda":
        raise ValueError(f"{KERNEL.name}: raw is on {raw.device}")
    if not raw.is_contiguous() or (mask is not None
                                   and not mask.is_contiguous()):
        raise ValueError(f"{KERNEL.name}: raw and mask must be contiguous")
    if raw.data_ptr() % 4:
        raise ValueError(f"{KERNEL.name}: raw must be 4-byte aligned")
    if B * Ny * Nx >= 2 ** 31 - 2 ** 12:
        raise ValueError(f"{KERNEL.name}: more than 2^31 cells")
    from ._build import library
    out = torch.empty((B, Ny, Nx), dtype=_torch_dtype(planes.dtype),
                      device=raw.device)
    status = library().xc_decode_planes(
        raw.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, Ny, Nx, planes.file_dtype.itemsize,
        out.element_size(), int(not planes.file_dtype.isnative),
        int(planes.flip), stream_handle())
    check_status(KERNEL.name, status)
    KERNEL.count()
    return out

