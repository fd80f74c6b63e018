"""impl= dispatch helper shared by the ops that hold a CUDA kernel."""

from __future__ import annotations

import torch

__all__ = ["resolve_impl"]


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    """Resolve ``impl`` for an op whose input is ``tensor``.

    ``"auto"`` gives ``"cuda"`` (the hand-written kernel) for a CUDA
    tensor and ``"torch"`` (the plain version) for a CPU tensor.
    ``"cuda"`` on a CPU tensor raises.  ``"torch"`` is allowed on either
    device, but only when a caller names it (tests and the chip smoke
    compare the kernel against it); the main path passes ``"auto"``.
    """
    if impl == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if impl == "cuda":
        if not tensor.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors, got a tensor "
                             f"on {tensor.device}")
        return impl
    if impl == "torch":
        return impl
    raise ValueError(f"unknown impl {impl!r}")
