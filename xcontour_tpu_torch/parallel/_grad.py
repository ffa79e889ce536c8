"""The sharded functions run forward only."""

from __future__ import annotations

import torch


def no_grad_inputs(name: str, *tensors) -> None:
    """Refuse inputs that need a gradient: gradients through the sharded
    functions (differentiable collectives, a loss counting a replicated
    output once per mesh) are not built."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: gradients through the sharded functions are not "
            "supported; differentiate the unsharded pipelines")
