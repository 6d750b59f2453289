"""What the kernel wrappers do about gradients.

A wrapper fills its outputs through ``ctypes``, outside the autograd graph,
so a gradient asked of them would silently lack the kernel's part. A kernel
with a backward is wrapped in a ``torch.autograd.Function`` (the star and tree
likelihoods, ``interp_nd`` for its points); every other wrapper calls
:func:`refuse_grad` first and raises where autograd would record its launch.
"""

from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` if gradients are enabled and any of ``tensors``
    (``None`` and non-tensors are skipped) requires one: ``name`` has no
    backward kernel."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: a gradient through its outputs would drop the kernel's part. "
            f"Call it under torch.no_grad() or on detached tensors.")
