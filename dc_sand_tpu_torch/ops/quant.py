"""Per-channel gain + 8-bit requantisation (C6), and dequantisation.

Golden semantics: :func:`dc_sand_tpu.golden.chain.requantize` — complex
gain multiply, round-half-even, saturate to [-127, 127] (never -128: the
X-engine negates int8 values).  Plain versions of
:mod:`dc_sand_tpu.ops.quant`.
"""

from __future__ import annotations

import torch

__all__ = ["requantize", "dequantize"]


def requantize(spectra: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """complex64 ``(..., k)`` * complex gains -> int8 ``(..., k, 2)``.

    ``torch.round`` rounds half to even, as the golden model does.
    """
    scaled = spectra * gains.to(torch.complex64)
    re = torch.clamp(torch.round(scaled.real), -127, 127).to(torch.int8)
    im = torch.clamp(torch.round(scaled.imag), -127, 127).to(torch.int8)
    return torch.stack([re, im], dim=-1)


def dequantize(q: torch.Tensor) -> torch.Tensor:
    """int8 ``(..., 2)`` -> complex64 ``(...)``."""
    f = q.to(torch.float32)
    return torch.complex(f[..., 0], f[..., 1])
