"""PFB-FIR: the windowed overlap-add front half of the channelizer (C3).

Golden semantics: :func:`dc_sand_tpu.golden.chain.pfb_fir`:

    ``y[s, b, n] = sum_t w[t*M + n] * x[s, (b+t)*M + n]``

The plain PyTorch version of :func:`dc_sand_tpu.ops.pfb.pfb_fir`'s jnp
arm.  On the fx path the FIR runs inside the fused F-engine kernel
(:mod:`dc_sand_tpu_torch.ops.fengine_fused`); the standalone FIR kernel
of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["pfb_fir", "pfb_fir_frames"]


def pfb_fir(x: torch.Tensor, window, taps: int,
            fft_size: int) -> torch.Tensor:
    """Apply the polyphase FIR.  ``x: (..., T)`` int8/float, ``T % M == 0``;
    returns float32 ``(..., B, M)`` with ``B = T//M - (taps-1)``."""
    m = fft_size
    t_len = x.shape[-1]
    if t_len % m:
        raise ValueError(f"input length {t_len} not a multiple of M={m}")
    frames = x.reshape(x.shape[:-1] + (t_len // m, m))
    return pfb_fir_frames(frames, window, taps)


def pfb_fir_frames(frames: torch.Tensor, window, taps: int) -> torch.Tensor:
    """The FIR on frames ``(..., F, M)``; returns float32
    ``(..., F - (taps-1), M)``.  Taps are summed in order t = 0..taps-1
    in float32, as the JAX package's jnp arm sums them."""
    m = frames.shape[-1]
    b_out = frames.shape[-2] - (taps - 1)
    if b_out <= 0:
        raise ValueError("input shorter than the FIR window")
    w = torch.as_tensor(window, dtype=torch.float32,
                        device=frames.device).reshape(taps, m)
    f32 = frames.to(torch.float32)
    out = torch.zeros(frames.shape[:-2] + (b_out, m), dtype=torch.float32,
                      device=frames.device)
    for t in range(taps):
        out = out + w[t] * f32[..., t:t + b_out, :]
    return out
