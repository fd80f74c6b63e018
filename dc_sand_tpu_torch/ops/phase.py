"""Fine delay + fringe rotation (C5): per-channel phase ramp.

Golden semantics: :func:`dc_sand_tpu.golden.chain.fine_delay_fringe`.
The plain version of :func:`dc_sand_tpu.ops.phase.fine_delay_fringe`,
with the same float32 order of operations:
``theta = (-(2 pi / M) * k) * d - p``, the constant rounded to float32.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fine_delay_fringe"]


def fine_delay_fringe(spectra: torch.Tensor, frac_delay,
                      phase) -> torch.Tensor:
    """``out[..., b, k] = s * exp(-j*(2 pi k d/M + p))``, complex64.

    ``frac_delay`` (samples) and ``phase`` (radians) broadcast over
    ``spectra.shape[:-1]`` — i.e. per stream, per spectrum.
    """
    dev = spectra.device
    n_chans = spectra.shape[-1]
    m = 2 * n_chans
    k = torch.arange(n_chans, dtype=torch.float32, device=dev)
    d = torch.as_tensor(frac_delay, dtype=torch.float32, device=dev)[..., None]
    p = torch.as_tensor(phase, dtype=torch.float32, device=dev)[..., None]
    theta = -(2.0 * math.pi / m) * k * d - p
    rot = torch.complex(torch.cos(theta), torch.sin(theta))
    return spectra.to(torch.complex64) * rot
