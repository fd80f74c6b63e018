"""Complex <-> stacked-real (re, im) conversion helpers.

The wire format for complex data is a trailing axis of length 2 holding
(re, im): int8 ``(..., 2)`` for quantised spectra, float32 ``(..., 2)``
for unquantised spectra and gains (as in :mod:`dc_sand_tpu.utils.cplx`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["c2ri", "ri2c", "np_ri2c", "np_c2ri"]


def c2ri(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """complex (...,) -> real (..., 2)."""
    return torch.stack([x.real, x.imag], dim=-1).to(dtype)


def ri2c(x: torch.Tensor) -> torch.Tensor:
    """real (..., 2) -> complex64 (...)."""
    f = x.to(torch.float32)
    return torch.complex(f[..., 0], f[..., 1])


def np_ri2c(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]


def np_c2ri(x, dtype=np.float32) -> np.ndarray:
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(dtype)
