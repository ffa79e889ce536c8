"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel module pairs a CUDA C++ kernel (``xcontour_tpu_torch/csrc``,
built by :mod:`._build`) with a plain PyTorch function of the same
semantics.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — there is no fallback.

Each kernel has a :class:`Kernel` record whose ``launches`` count goes up by
one per kernel launch, so a run can show that its main path went through
the kernels.  A launch made while its thread captures a CUDA graph
(:func:`capturing`) runs nothing, so it goes to the capture's tally
instead; each replay of the graph adds the tally back.

Gradients: the modules that call a wrapper wrap it in a
``torch.autograd.Function`` (the JAX package's custom VJPs), whose forward
is the wrapper on detached tensors and whose backward is plain PyTorch:
:func:`vjp` recomputes the plain version piece by piece.  A call where no
input needs a gradient (:func:`needs_grad`) calls the wrapper directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch


# the tally of the CUDA graph this thread is capturing, if any
_capture = threading.local()


@dataclasses.dataclass(eq=False)
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper launched it."""

    name: str
    source: str      # CUDA source, relative to the repository root
    replaces: str    # file:line of the TPU (Pallas) kernel body
    launches: int = 0

    def count(self) -> None:
        """One launch by a wrapper: onto ``launches``, or onto the tally of
        the graph this thread is capturing."""
        tally = getattr(_capture, "tally", None)
        if tally is None:
            self.launches += 1
        else:
            tally[self] = tally.get(self, 0) + 1


@contextlib.contextmanager
def capturing():
    """Inside the block, this thread's launches go to the dict it yields,
    ``{Kernel: launches}``, and not to ``Kernel.launches``: a graph's
    capture launches nothing on the card."""
    tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


@functools.lru_cache(maxsize=None)
def device_constant(value, dtype, device) -> torch.Tensor:
    """``value``, a tuple of numbers or a float's name ('inf', 'nan'), as a
    tensor on ``device``, made once and kept: a CUDA graph's capture
    cannot copy from the host (the eager call before it makes the
    constant), and a graph reads the tensor where it lies.  Read only."""
    if isinstance(value, str):
        value = float(value)
    return torch.as_tensor(value, dtype=dtype, device=device)


def check_cuda_inputs(name: str, **tensors: torch.Tensor) -> None:
    """The wrappers' launch preconditions: float32, contiguous, on one CUDA
    device, and not requiring grad: a wrapper records no graph.  Gradients
    go through the entry points (the ops, diagnostics and pipelines), whose
    autograd Functions pass the wrappers detached tensors."""
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
                f"{name}: {arg} requires grad; a kernel wrapper records no "
                "graph: differentiate through the entry points "
                "(squared_gradient, weighted_cdf*, local_wave_activity*, "
                "contour_lengths, local_contour_lengths, the pipelines)")


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call must go through its autograd Function: grad mode is
    on and some input requires grad.  Otherwise the caller calls the
    wrapper directly, with no autograd bookkeeping."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


Piece = Tuple[Callable[[Sequence[torch.Tensor]], torch.Tensor], torch.Tensor]


def vjp(pieces: Iterable[Piece], inputs: Sequence[torch.Tensor],
        needs: Sequence[bool],
        prep: Optional[Callable[..., Sequence[torch.Tensor]]] = None
        ) -> list:
    """The cotangents of ``inputs`` for an output made of pieces, by
    recomputing each piece under autograd.

    ``parts = prep(*inputs)`` (the inputs themselves without ``prep``);
    each piece is ``(fn, cotangent)`` with ``fn(parts)`` that piece of the
    output.  A piece is recomputed and differentiated against the parts
    alone, so memory holds one piece's temporaries; the parts' summed
    cotangents then go back through ``prep`` once.  Returns one cotangent
    per input, None where ``needs`` is False or the input is unused.

    The backward of a Function runs with grad mode on when a graph of the
    gradient is asked for (``create_graph``); the recomputation is then
    recorded on the saved inputs themselves, so the gradient can be
    differentiated again."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = [x if create else x.detach().requires_grad_(n)
              for x, n in zip(inputs, needs)]
        parts = list(xs if prep is None else prep(*xs))
        hold = parts if create or prep is None else \
            [p.detach().requires_grad_(p.requires_grad) for p in parts]
        live = [i for i, h in enumerate(hold) if h.requires_grad]
        acc = [None] * len(hold)
        for fn, g in pieces:
            out = fn(hold)
            if not out.requires_grad:
                continue
            grads = torch.autograd.grad(out, [hold[i] for i in live], g,
                                        create_graph=create,
                                        retain_graph=create, allow_unused=True)
            for i, gi in zip(live, grads):
                if gi is not None:
                    acc[i] = gi if acc[i] is None else acc[i] + gi
        if prep is None:
            return [a if n else None for a, n in zip(acc, needs)]
        out = [None] * len(inputs)
        back = []
        for p, a in zip(parts, acc):
            if a is None:
                continue
            # a part that is an input passes its cotangent on as it is
            same = [i for i, x in enumerate(xs) if p is x]
            if same:
                i = same[0]
                out[i] = a if out[i] is None else out[i] + a
            else:
                back.append((p, a))
        want = [i for i, n in enumerate(needs) if n]
        if back and want:
            grads = torch.autograd.grad([p for p, _ in back],
                                        [xs[i] for i in want],
                                        [a for _, a in back],
                                        create_graph=create, allow_unused=True)
            for i, gi in zip(want, grads):
                if gi is not None:
                    out[i] = gi if out[i] is None else out[i] + gi
        return [o if n else None for o, n in zip(out, needs)]
