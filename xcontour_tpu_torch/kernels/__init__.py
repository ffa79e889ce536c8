"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel module pairs a CUDA C++ kernel (``xcontour_tpu_torch/csrc``,
built by :mod:`._build`) with a plain PyTorch function of the same
semantics.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — there is no fallback.

Each kernel has a :class:`Kernel` record whose ``launches`` count goes up by
one per kernel launch, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper launched it."""

    name: str
    source: str      # CUDA source, relative to the repository root
    replaces: str    # file:line of the TPU (Pallas) kernel body
    launches: int = 0


def check_cuda_inputs(name: str, **tensors: torch.Tensor) -> None:
    """The wrappers' launch preconditions: float32, contiguous, on one CUDA
    device, and not requiring grad (the kernels have no backward yet)."""
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad; the CUDA kernel has no "
                "backward yet (see ROADMAP Queue 1 item 9)")


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
