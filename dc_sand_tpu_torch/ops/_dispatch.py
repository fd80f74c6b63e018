"""impl= dispatch helper shared by the ops that hold a CUDA kernel, and the
default device of the entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_impl", "default_device"]


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


def default_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the current CUDA
    device.  Without a card, ``None`` raises: the entry points run on the
    card, and the CPU only when a caller passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
