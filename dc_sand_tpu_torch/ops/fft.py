"""Real->complex channelizer FFT (C4).

Golden semantics: :func:`dc_sand_tpu.golden.chain.channelize`.  The
plain version of :func:`dc_sand_tpu.ops.fft.channelize`; on the fx path
the FFT runs inside the fused F-engine kernel.
"""

from __future__ import annotations

import torch

__all__ = ["channelize"]


def channelize(fir_out: torch.Tensor, n_chans: int) -> torch.Tensor:
    """rfft over the last axis (length 2*n_chans), keep bins [0, n_chans)
    (the Nyquist bin is dropped).  float32 in -> complex64 out."""
    spec = torch.fft.rfft(fir_out.to(torch.float32), dim=-1)
    return spec[..., :n_chans]
