"""Validity checks on tensors.

Counterpart of ``xcontour_tpu/utils/checks.py``, whose guards are
``jax.experimental.checkify`` checks that run inside ``jit``.  Here they are
explicit eager checks: each reads one boolean back from the tensor's device
(so ``Contour2D`` runs them only with ``check_mono=True``) and raises
``ValueError`` with the JAX package's message.  Inside a function wrapped by
:func:`checked` they record their failure instead and the function runs to
its end; the caller raises the first failure with ``err.throw()``:

    err, out = checked(fn)(x)
    err.throw()
"""

from __future__ import annotations

import contextvars
from typing import List, Optional

import numpy as np
import torch

from ..grid import to_numpy

# the error record of the innermost checked() call running in this context
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("checked",
                                                        default=None)


class CheckError:
    """The failed checks of one :func:`checked` call, in the order they
    failed (checkify's ``Error``: :meth:`get` and :meth:`throw`)."""

    def __init__(self):
        self.messages: List[str] = []

    def get(self) -> Optional[str]:
        """The first failure's message, or None if every check passed."""
        return self.messages[0] if self.messages else None

    def throw(self) -> None:
        """Raise ``ValueError`` with the first failure's message, if any."""
        if self.messages:
            raise ValueError(self.messages[0])


def _check(ok: torch.Tensor, msg: str) -> None:
    """Record (inside :func:`checked`) or raise ``msg`` unless ``ok``."""
    if bool(ok):
        return
    err = _ACTIVE.get()
    if err is None:
        raise ValueError(msg)
    err.messages.append(msg)


def check_monotonic(var: torch.Tensor, axis: int = -1,
                    name: str = "var") -> None:
    """No zero difference along ``axis`` (the reference's monotonicity
    guard, core.py:1343-1355)."""
    d = torch.diff(torch.as_tensor(var), dim=axis)
    _check(torch.all(d != 0), f"{name} not strictly monotonic along "
           f"axis {axis} (zero difference found)")


def check_uniform_direction(var: torch.Tensor, axis: int = -1,
                            name: str = "var") -> None:
    """Every batch element runs the same monotonic direction along
    ``axis``: the reference's table-direction error ("not every time or
    level is increasing/decreasing", core.py:1122-1134)."""
    v = torch.movedim(torch.as_tensor(var), axis, -1)
    v = v.reshape(-1, v.shape[-1])
    inc = v[:, -1] > v[:, 0]
    _check(torch.all(inc == inc[0]),
           f"{name}: not every batch element is "
           f"increasing/decreasing along axis {axis} "
           "(mixed-direction batch)")


def check_finite(var: torch.Tensor, name: str = "var",
                 allow_nan_frac: float = 0.0) -> None:
    """The non-finite fraction of ``var`` stays within ``allow_nan_frac``."""
    bad = ~torch.isfinite(torch.as_tensor(var))
    frac = bad.to(torch.float32).mean()
    _check(frac <= allow_nan_frac,
           f"{name}: non-finite fraction exceeds {allow_nan_frac}")


def checked(fn):
    """Wrap ``fn`` so the checks it runs are recorded, not raised:

        err, out = checked(fn)(x); err.throw()

    ``fn`` runs to its end; ``err`` holds every failure in order."""

    def wrapped(*args, **kwargs):
        err = CheckError()
        token = _ACTIVE.set(err)
        try:
            out = fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)
        return err, out
    return wrapped


def assert_monotonic_host(var, axis: int = -1, name: str = "var") -> None:
    """Eager host-side version, raising with the first offending index."""
    arr = to_numpy(var)
    d = np.diff(arr, axis=axis)
    if np.any(d == 0):
        idx = np.argwhere(d == 0)[0]
        raise ValueError(f"{name} not strictly monotonic along axis {axis}; "
                         f"first zero difference at index {tuple(idx)}")
