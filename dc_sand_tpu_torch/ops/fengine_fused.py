"""Fused F-engine (kernel K1): FIR + FFT + phase + requant in one launch.

The CUDA kernel ``csrc/fengine.cu`` replaces the TPU kernel
``dc_sand_tpu/ops/fengine_fused.py:_kernel``.  Its plain PyTorch version,
:func:`fengine_fused_torch`, composes the per-stage ops (the plain
:func:`~dc_sand_tpu_torch.ops.pfb.pfb_fir`, then :func:`fengine_tail`:
``channelize -> fine_delay_fringe -> requantize``) in float32; the CPU
tests hold it to the JAX package's jnp arm, and the chip smoke holds the
kernel to it.

Input conventions: those of :mod:`dc_sand_tpu_torch.ops.pfb` (split I/O
with ``history`` ``(..., taps_pad, M)`` and the chunk's frames ``(..., B,
M)``, or one stream ``(..., T)``).

Output: the wire format ``(..., B, K, 2)`` in natural channel order, int8
with ``gains`` and float32 without (the JAX package's float-output mode,
config ``pfb1k``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.ops.fft import channelize
from dc_sand_tpu_torch.ops.pfb import frames_of, pfb_fir
from dc_sand_tpu_torch.ops.phase import fine_delay_fringe
from dc_sand_tpu_torch.ops.quant import requantize
from dc_sand_tpu_torch.utils.cplx import c2ri, ri2c

__all__ = ["fengine_fused", "fengine_fused_torch", "fengine_tail",
           "MAX_FFT_SIZE"]

MAX_FFT_SIZE = 8192   # the kernel's shared-memory FFT holds M/2 <= 4096


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
    re/im.  Returns int8 ``(..., B, K, 2)`` with gains, float32 ``(...,
    B, K, 2)`` spectra without.

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch adds one to
    ``fengine_fused.launches`` (int8 output) or to
    ``fengine_fused.float_launches`` (float32 output).
    """
    if resolve_impl(impl, x) == "torch":
        return fengine_fused_torch(x, window, taps, n_chans, history=history,
                                   frac_delay=frac_delay, phase=phase,
                                   gains=gains)
    m = 2 * n_chans
    lead, fa, fb, pad0, b_out = frames_of(x, history, taps, m)
    dev = x.device
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
    g = None
    if gains is not None:
        g = torch.as_tensor(gains, dtype=torch.float32, device=dev)
        if g.shape != (n_chans, 2):
            raise ValueError(f"gains must be ({n_chans}, 2), got "
                             f"{tuple(g.shape)}")
        g = g.contiguous()
    if frac_delay is None and phase is None:
        fd = ph = None
    else:
        fd = _per_spectrum(0.0 if frac_delay is None else frac_delay,
                           lead, b_out, dev)
        ph = _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev)
    out = torch.empty((s, b_out, n_chans, 2), device=dev,
                      dtype=torch.float32 if g is None else torch.int8)
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_fengine(
            fa.data_ptr(), (fb if fb is not None else fa).data_ptr(),
            w.data_ptr(), _twiddles(m, dev).data_ptr(),
            None if fd is None else fd.data_ptr(),
            None if ph is None else ph.data_ptr(),
            None if g is None else g.data_ptr(), out.data_ptr(), s,
            fa.shape[1], 0 if fb is None else fb.shape[1], b_out, m, taps,
            pad0,
            -(2.0 * math.pi / m), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_fengine")
    if g is None:
        fengine_fused.float_launches += 1
    else:
        fengine_fused.launches += 1
    return out.reshape(tuple(lead) + (b_out, n_chans, 2))


fengine_fused.launches = 0
fengine_fused.float_launches = 0


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
    """Plain version of the fused F-engine: the plain FIR, then
    :func:`fengine_tail`, as separate float32 PyTorch ops on the same
    conventions."""
    fir = pfb_fir(x, window, taps, 2 * n_chans, history=history,
                  impl="torch")
    return fengine_tail(fir, n_chans, frac_delay=frac_delay, phase=phase,
                        gains=gains)


def fengine_tail(fir: torch.Tensor, n_chans: int, *, frac_delay=None,
                 phase=None, gains=None) -> torch.Tensor:
    """The F-engine after the FIR, on FIR output ``(..., B, M)`` float32:
    rfft, the fine-delay/fringe phasor (when ``frac_delay`` or ``phase``
    is given, per spectrum, broadcastable to ``(..., B)``), then the gain
    and requantisation to int8 ``(..., B, K, 2)``, or float32 ``(..., B,
    K, 2)`` spectra when ``gains`` is None."""
    lead, b_out = fir.shape[:-2], fir.shape[-2]
    spec = channelize(fir.reshape(-1, b_out, fir.shape[-1]), n_chans)
    if frac_delay is not None or phase is not None:
        dev = fir.device
        spec = fine_delay_fringe(
            spec, _per_spectrum(0.0 if frac_delay is None else frac_delay,
                                lead, b_out, dev),
            _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev))
    if gains is None:
        res = c2ri(spec)
    else:
        g = torch.as_tensor(gains, dtype=torch.float32, device=fir.device)
        res = requantize(spec, ri2c(g))
    return res.reshape(tuple(lead) + res.shape[1:])
