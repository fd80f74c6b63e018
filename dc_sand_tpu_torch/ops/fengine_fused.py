"""Fused F-engine (kernel K1): FIR + FFT + phase + requant in one launch.

The CUDA kernel ``csrc/fengine.cu`` replaces the TPU kernel
``dc_sand_tpu/ops/fengine_fused.py:_kernel``.  Its plain PyTorch version,
:func:`fengine_fused_torch`, composes the per-stage ops
(``pfb_fir -> channelize -> fine_delay_fringe -> requantize``) in
float32; the CPU tests hold it to the JAX package's jnp arm, and the chip
smoke holds the kernel to it.

Input conventions, as in :func:`dc_sand_tpu.ops.fengine_fused.fengine_fused`:

* split I/O (``history`` given, the streaming fast path): ``x`` is the new
  chunk as frames ``(..., B, M)`` and ``history`` the carried overlap-save
  tail ``(..., taps_pad, M)``, ``taps_pad = roundup(taps, 8)``, of which
  the last ``taps-1`` frames are read.  Output spectrum j reads frames
  ``j + pad0 .. j + pad0 + taps - 1`` of ``[history | x]`` with
  ``pad0 = taps_pad - taps + 1``;
* one stream (``history`` None): ``x (..., T)``, ``B = T/M - (taps-1)``.

Output: the wire format ``(..., B, K, 2)`` int8 in natural channel order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.ops.fft import channelize
from dc_sand_tpu_torch.ops.pfb import pfb_fir_frames
from dc_sand_tpu_torch.ops.phase import fine_delay_fringe
from dc_sand_tpu_torch.ops.quant import requantize
from dc_sand_tpu_torch.utils.cplx import c2ri, ri2c

__all__ = ["fengine_fused", "fengine_fused_torch", "taps_pad_for",
           "MAX_FFT_SIZE"]

MAX_FFT_SIZE = 8192   # the kernel's shared-memory FFT holds M/2 <= 4096


def taps_pad_for(taps: int) -> int:
    """Frames of carried history: ``taps`` rounded up to a multiple of 8."""
    return -(-taps // 8) * 8


def _frames(x, history, taps, m):
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


def _per_spectrum(v, lead, b_out, device):
    """Per-spectrum parameter broadcast to ``lead + (B,)``, flattened to
    ``(S, B)`` float32."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.broadcast_to(t, tuple(lead) + (b_out,)).reshape(
        -1, b_out).contiguous()


def fengine_fused(x: torch.Tensor, window, taps: int, n_chans: int, *,
                  history: torch.Tensor = None, frac_delay=None, phase=None,
                  gains=None, impl: str = "auto") -> torch.Tensor:
    """Fused F-engine; see the module docstring for the conventions.

    ``frac_delay``/``phase``: per spectrum, broadcastable to ``(..., B)``
    (no rotation when both are None).  ``gains``: ``(K, 2)`` float32
    re/im.  Returns int8 ``(..., B, K, 2)``; the plain version returns
    float32 spectra when ``gains`` is None (the kernel always quantises).

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch adds one to
    ``fengine_fused.launches``.
    """
    if resolve_impl(impl, x) == "torch":
        return fengine_fused_torch(x, window, taps, n_chans, history=history,
                                   frac_delay=frac_delay, phase=phase,
                                   gains=gains)
    m = 2 * n_chans
    lead, fa, fb, pad0, b_out = _frames(x, history, taps, m)
    dev = x.device
    if gains is None:
        raise ValueError("the F-engine kernel quantises: gains are required "
                         "(float spectra run only on the plain version)")
    if m < 32 or m & (m - 1) or m > MAX_FFT_SIZE:
        raise ValueError(f"the F-engine kernel takes M = 2*n_chans a power "
                         f"of two in [32, {MAX_FFT_SIZE}], got {m}")
    for name, t in (("chunk", x), ("history", history)):
        if t is None:
            continue
        if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int8 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    s = fa.shape[0]
    if not 1 <= s <= 65535:
        raise ValueError(f"the kernel takes 1..65535 streams, got {s}")
    w = torch.as_tensor(window, dtype=torch.float32, device=dev)
    if w.numel() != taps * m:
        raise ValueError(f"window must hold taps*M = {taps * m} values")
    w = w.reshape(taps, m).contiguous()
    g = torch.as_tensor(gains, dtype=torch.float32, device=dev)
    if g.shape != (n_chans, 2):
        raise ValueError(f"gains must be ({n_chans}, 2), got {tuple(g.shape)}")
    g = g.contiguous()
    if frac_delay is None and phase is None:
        fd = ph = None
    else:
        fd = _per_spectrum(0.0 if frac_delay is None else frac_delay,
                           lead, b_out, dev)
        ph = _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev)
    out = torch.empty((s, b_out, n_chans, 2), dtype=torch.int8, device=dev)
    err = _build.library().dcs_fengine(
        fa.data_ptr(), (fb if fb is not None else fa).data_ptr(),
        w.data_ptr(), _twiddles(m, dev).data_ptr(),
        None if fd is None else fd.data_ptr(),
        None if ph is None else ph.data_ptr(),
        g.data_ptr(), out.data_ptr(), s, fa.shape[1],
        0 if fb is None else fb.shape[1], b_out, m, taps, pad0,
        -(2.0 * math.pi / m), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_fengine")
    fengine_fused.launches += 1
    return out.reshape(tuple(lead) + (b_out, n_chans, 2))


fengine_fused.launches = 0


@functools.lru_cache(maxsize=None)
def _twiddles(m: int, device: torch.device) -> torch.Tensor:
    """``exp(-2 pi i k / M)`` for ``k < M/2`` as float32 (re, im) pairs,
    computed in float64."""
    ang = -2.0 * np.pi * np.arange(m // 2, dtype=np.float64) / m
    tw = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def fengine_fused_torch(x: torch.Tensor, window, taps: int, n_chans: int, *,
                        history: torch.Tensor = None, frac_delay=None,
                        phase=None, gains=None) -> torch.Tensor:
    """Plain version of the fused F-engine: FIR, rfft, phasor and requant
    as separate float32 PyTorch ops, on the same conventions."""
    m = 2 * n_chans
    lead, fa, fb, pad0, b_out = _frames(x, history, taps, m)
    frames = fa if fb is None else torch.cat([fa[:, pad0:], fb], dim=1)
    fir = pfb_fir_frames(frames, window, taps)
    spec = channelize(fir, n_chans)
    if frac_delay is not None or phase is not None:
        dev = x.device
        spec = fine_delay_fringe(
            spec, _per_spectrum(0.0 if frac_delay is None else frac_delay,
                                lead, b_out, dev),
            _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev))
    if gains is None:
        res = c2ri(spec)
    else:
        g = torch.as_tensor(gains, dtype=torch.float32, device=x.device)
        res = requantize(spec, ri2c(g))
    return res.reshape(tuple(lead) + res.shape[1:])
