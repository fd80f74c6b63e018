"""PFB-FIR: the windowed overlap-add front half of the channelizer (C3).

Golden semantics: :func:`dc_sand_tpu_torch.golden.chain.pfb_fir`:

    ``y[s, b, n] = sum_t w[t*M + n] * x[s, (b+t)*M + n]``

:func:`pfb_fir` launches the CUDA kernel ``csrc/pfb.cu`` (K6), which
replaces the TPU kernel ``dc_sand_tpu/ops/pfb.py:_pfb_kernel``, on a CUDA
tensor, and runs :func:`pfb_fir_frames`, the plain version (the JAX
package's jnp arm), on a CPU tensor.  The unfused F-engine
(``models/fengine.py``, ``fused=False``) calls it; on the fused path the
FIR runs inside the F-engine kernel (``ops/fengine_fused.py``).

Input conventions, shared with the fused F-engine:

* split I/O (``history`` given, the streaming path): ``x`` is the new
  chunk as frames ``(..., B, M)`` and ``history`` the carried overlap-save
  tail ``(..., taps_pad, M)``, ``taps_pad = roundup(taps, 8)``, of which
  the last ``taps-1`` frames are read.  Output spectrum j reads frames
  ``j + pad0 .. j + pad0 + taps - 1`` of ``[history | x]`` with
  ``pad0 = taps_pad - taps + 1``;
* one stream (``history`` None): ``x (..., T)``, ``B = T/M - (taps-1)``.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["pfb_fir", "pfb_fir_frames", "frames_of", "taps_pad_for",
           "MAX_TAPS"]

MAX_TAPS = 16   # the kernel keeps a column's taps weights in registers


def taps_pad_for(taps: int) -> int:
    """Frames of carried history: ``taps`` rounded up to a multiple of 8."""
    return -(-taps // 8) * 8


def frames_of(x, history, taps, m):
    """``(lead, frames_a, frames_b, pad0, b_out)`` of either input
    convention, the leading dims flattened to one stream axis
    (``frames_b`` is None for one stream)."""
    if history is None:
        t_len = x.shape[-1]
        if t_len % m:
            raise ValueError(f"input length {t_len} not a multiple of M={m}")
        lead = x.shape[:-1]
        fa = x.reshape(-1, t_len // m, m)
        b_out = fa.shape[1] - (taps - 1)
        if b_out <= 0:
            raise ValueError("input shorter than the FIR window")
        return lead, fa, None, 0, b_out
    taps_pad = taps_pad_for(taps)
    if x.shape[-1] != m or history.shape[-1] != m:
        raise ValueError(f"frames must be M={m} wide, got chunk "
                         f"{tuple(x.shape)} / history {tuple(history.shape)}")
    if history.shape[-2] != taps_pad or history.shape[:-2] != x.shape[:-2]:
        raise ValueError(
            f"history must be (..., {taps_pad}, {m}) matching chunk lead "
            f"dims, got {tuple(history.shape)} vs chunk {tuple(x.shape)}")
    lead = x.shape[:-2]
    b_out = x.shape[-2]
    return (lead, history.reshape(-1, taps_pad, m), x.reshape(-1, b_out, m),
            taps_pad - taps + 1, b_out)


def pfb_fir(x: torch.Tensor, window, taps: int, fft_size: int, *,
            history: torch.Tensor = None, impl: str = "auto") -> torch.Tensor:
    """Apply the polyphase FIR; see the module docstring for the input
    conventions.  Returns float32 ``(..., B, M)``.

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch adds one to ``pfb_fir.launches``.
    """
    m = fft_size
    lead, fa, fb, pad0, b_out = frames_of(x, history, taps, m)
    if resolve_impl(impl, x) == "torch":
        frames = fa if fb is None else torch.cat([fa[:, pad0:], fb], dim=1)
        out = pfb_fir_frames(frames, window, taps)
        return out.reshape(tuple(lead) + (b_out, m))
    dev = x.device
    if not 1 <= taps <= MAX_TAPS:
        raise ValueError(f"the PFB kernel takes 1..{MAX_TAPS} taps, "
                         f"got {taps}")
    for name, t in (("frames", fa), ("history", history)):
        if t is None:
            continue
        if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int8 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    s = fa.shape[0]
    if not 1 <= s <= 65535:
        raise ValueError(f"the PFB kernel takes 1..65535 streams, got {s}")
    w = torch.as_tensor(window, dtype=torch.float32, device=dev)
    if w.numel() != taps * m:
        raise ValueError(f"window must hold taps*M = {taps * m} values")
    w = w.reshape(taps, m).contiguous()
    out = torch.empty((s, b_out, m), dtype=torch.float32, device=dev)
    # the kernel's word path: 4-byte frame words, 16-byte weight and
    # output rows; otherwise it reads and writes element by element
    vec = int(m % 4 == 0 and all(t.data_ptr() % 4 == 0 for t in (fa, fb)
                                 if t is not None)
              and w.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_pfb(
            fa.data_ptr(), (fb if fb is not None else fa).data_ptr(),
            w.data_ptr(), out.data_ptr(), s, fa.shape[1],
            0 if fb is None else fb.shape[1], b_out, m, taps, pad0, vec,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_pfb")
    pfb_fir.launches += 1
    return out.reshape(tuple(lead) + (b_out, m))


pfb_fir.launches = 0


def pfb_fir_frames(frames: torch.Tensor, window, taps: int) -> torch.Tensor:
    """The plain FIR on frames ``(..., F, M)``; returns float32
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
