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

Output layouts, channels in natural order in each:

* ``layout="wire"`` (the default): ``(..., B, K, 2)``, int8 with
  ``gains`` and float32 without (the JAX package's float-output mode,
  config ``pfb1k``).  Fengine mode, beam mode and the bench read it;
* ``layout="wire_flat"``: the same bytes viewed ``(..., B, 2K)``, re/im
  pairs channel-major (``dc_sand_tpu/ops/fengine_fused.py:754``);
* ``layout="operand"`` (int8 only): ``(K, 2, S, pitch)`` with ``out[k, c,
  s, b] = wire[s, b, k, c]`` for ``b < B`` and zeros past B (S the leading
  dims flattened; ``pitch`` >= B, default B), the X-engine's stacked
  operand ``a2 = [Ar; Ai]`` of :mod:`dc_sand_tpu_torch.ops.xcorr` viewed
  as ``(K, 2S, pitch)``.  The fx path asks for the CMAC's pitch
  (:func:`~dc_sand_tpu_torch.ops.xcorr.cmac_pitch`, B rounded up to 16)
  and feeds it to the CMAC as it is, or on a mesh to the corner-turn's
  all-to-all, with no permute or pad between: the counterpart of the JAX
  package's ``layout="native"``.  The plain version is the wire output
  through :func:`~dc_sand_tpu_torch.ops.xcorr.wire_to_operand`.

The kernel's FFT is a plan of Stockham passes (:func:`fft_plan`) whose
twiddle tables are made here in float64; :func:`fft_plan_torch` runs the
same plan (radix order, twiddle indices, Stockham addressing, the
in-register DFT's stages) in PyTorch, for the tests only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.ops.fft import channelize
from dc_sand_tpu_torch.ops.pfb import MAX_TAPS, frames_of, pfb_fir
from dc_sand_tpu_torch.ops.phase import fine_delay_fringe
from dc_sand_tpu_torch.ops.quant import requantize
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
from dc_sand_tpu_torch.utils.cplx import c2ri, ri2c

__all__ = ["fengine_fused", "fengine_fused_torch", "fengine_tail",
           "fft_plan", "fft_plan_torch", "MAX_FFT_SIZE", "LAYOUTS"]

MAX_FFT_SIZE = 8192   # the kernel holds its spectra's M/2 <= 4096 values
LAYOUTS = ("wire", "wire_flat", "operand")


def _per_spectrum(v, lead, b_out, device):
    """Per-spectrum parameter broadcast to ``lead + (B,)``, flattened to
    ``(S, B)`` float32."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.broadcast_to(t, tuple(lead) + (b_out,)).reshape(
        -1, b_out).contiguous()


def fengine_fused(x: torch.Tensor, window, taps: int, n_chans: int, *,
                  history: torch.Tensor = None, frac_delay=None, phase=None,
                  gains=None, layout: str = "wire", pitch: int = None,
                  impl: str = "auto") -> torch.Tensor:
    """Fused F-engine; see the module docstring for the conventions.

    ``frac_delay``/``phase``: per spectrum, broadcastable to ``(..., B)``
    (no rotation when both are None).  ``gains``: ``(K, 2)`` float32
    re/im.  Returns int8 ``(..., B, K, 2)`` with gains, float32 ``(...,
    B, K, 2)`` spectra without, ``(..., B, 2K)`` with
    ``layout="wire_flat"``, or with ``layout="operand"`` (gains needed)
    int8 ``(K, 2, S, pitch)``, zeros past B.

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch adds one to
    ``fengine_fused.launches`` (int8 output, either layout) or to
    ``fengine_fused.float_launches`` (float32 output).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "operand" and gains is None:
        raise ValueError("the operand layout is int8: it needs gains")
    if resolve_impl(impl, x) == "torch":
        return fengine_fused_torch(x, window, taps, n_chans, history=history,
                                   frac_delay=frac_delay, phase=phase,
                                   gains=gains, layout=layout, pitch=pitch)
    m = 2 * n_chans
    lead, fa, fb, pad0, b_out = frames_of(x, history, taps, m)
    pitch = _pitch(pitch, b_out, layout)
    dev = x.device
    if m < 32 or m & (m - 1) or m > MAX_FFT_SIZE:
        raise ValueError(f"the F-engine kernel takes M = 2*n_chans a power "
                         f"of two in [32, {MAX_FFT_SIZE}], got {m}")
    if not 1 <= taps <= MAX_TAPS:
        raise ValueError(f"the F-engine kernel takes 1..{MAX_TAPS} taps, "
                         f"got {taps}")
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
    operand = layout == "operand"
    shape = (n_chans, 2, s, pitch) if operand else (s, b_out, n_chans, 2)
    out = torch.empty(shape, device=dev,
                      dtype=torch.float32 if g is None else torch.int8)
    split_tw, pass_tw = _tables(m, dev)
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_fengine(
            fa.data_ptr(), (fb if fb is not None else fa).data_ptr(),
            w.data_ptr(), split_tw.data_ptr(), pass_tw.data_ptr(),
            None if fd is None else fd.data_ptr(),
            None if ph is None else ph.data_ptr(),
            None if g is None else g.data_ptr(), out.data_ptr(), s,
            fa.shape[1], 0 if fb is None else fb.shape[1], b_out, m, taps,
            pad0, int(operand), pitch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_fengine")
    if g is None:
        fengine_fused.float_launches += 1
    else:
        fengine_fused.launches += 1
    if operand:
        return out
    return _wire(out, lead, layout)


fengine_fused.launches = 0
fengine_fused.float_launches = 0


def _pitch(pitch, b_out: int, layout: str) -> int:
    """The operand layout's spectra a row (default ``b_out``)."""
    if pitch is None:
        return b_out
    if layout != "operand" or pitch < b_out:
        raise ValueError(f"pitch takes the operand layout and at least its "
                         f"{b_out} spectra, got {pitch} ({layout})")
    return int(pitch)


def _wire(res: torch.Tensor, lead, layout: str) -> torch.Tensor:
    """Wire spectra ``(S, B, K, 2)`` with the leading dims ``lead`` back,
    ``(..., B, K, 2)``, or viewed ``(..., B, 2K)`` for ``"wire_flat"``."""
    b, k = res.shape[-3], res.shape[-2]
    tail = (b, 2 * k) if layout == "wire_flat" else (b, k, 2)
    return res.reshape(tuple(lead) + tail)


def fft_plan(n: int) -> tuple:
    """The kernel's plan for its N-point complex FFT (N a power of two):
    one ``(R, Ns, offset)`` per Stockham pass, radix-16 passes then one of
    radix ``2**(log2 N mod 4)``.  ``Ns`` is the product of the earlier
    radices; a pass with ``Ns > 1`` reads its twiddle ``W_{Ns R}^{(j mod
    Ns) r}`` at ``offset + (r - 1) * Ns + j mod Ns`` of the pass table
    (``csrc/fengine.cu`` derives the same plan)."""
    plan, ns, off, left = [], 1, 0, int(n).bit_length() - 1
    while left > 0:
        r = 1 << min(left, 4)
        plan.append((r, ns, off))
        if ns > 1:
            off += (r - 1) * ns
        ns *= r
        left -= 4
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _tables_np(m: int) -> tuple:
    """``(split, passes)`` complex64, made in float64: ``W_M^k`` for ``k <
    M/2`` (the real FFT's split) and the Stockham pass twiddles of
    :func:`fft_plan` (at least one value, so the pointer is never null)."""
    n = m // 2
    split = np.exp(-2j * np.pi * np.arange(n) / m)
    parts = [np.ones(1)]
    for r, ns, _ in fft_plan(n):
        if ns > 1:
            rr, jm = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
            parts.append(np.exp(-2j * np.pi * (jm * rr) / (ns * r)).ravel())
    passes = np.concatenate(parts[1:]) if len(parts) > 1 else parts[0]
    return split.astype(np.complex64), passes.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _tables(m: int, device: torch.device) -> tuple:
    """:func:`_tables_np` as float32 (re, im) pairs on ``device``."""
    return tuple(torch.from_numpy(np.stack([t.real, t.imag], -1)).to(device)
                 for t in _tables_np(m))


def _dft_regs(v: torch.Tensor) -> torch.Tensor:
    """The kernel's in-register R-point DFT over the last axis: radix-2
    decimation-in-frequency stages, then the bit reversal."""
    r = v.shape[-1]
    x = list(v.unbind(-1))
    span = r // 2
    while span >= 1:
        for i0 in range(0, r, 2 * span):
            for k in range(span):
                a, b = x[i0 + k], x[i0 + k + span]
                x[i0 + k] = a + b
                x[i0 + k + span] = (a - b) * np.exp(-2j * np.pi * k / (2 * span))
        span //= 2
    bits = r.bit_length() - 1
    rev = [int(f"{k:0{bits}b}"[::-1], 2) if bits else 0 for k in range(r)]
    return torch.stack([x[i] for i in rev], -1)


def fft_plan_torch(y: torch.Tensor) -> torch.Tensor:
    """The kernel's real FFT of ``y (..., M)`` float64 as PyTorch ops, in
    complex128 with its float32 twiddle tables: the packed complex FFT of
    :func:`fft_plan`'s Stockham passes, then the split.  Returns the first
    M/2 bins (``torch.fft.rfft`` without the Nyquist bin).  For tests."""
    m = y.shape[-1]
    n = m // 2
    split, passes = (torch.from_numpy(t.astype(np.complex128))
                     for t in _tables_np(m))
    z = torch.complex(y[..., 0::2], y[..., 1::2])
    for r, ns, off in fft_plan(n):
        per = n // r
        j = torch.arange(per)
        jm = j % ns
        rr = torch.arange(r)
        v = z[..., j[:, None] + rr[None, :] * per]            # (..., per, R)
        if ns > 1:
            idx = off + (rr[None, 1:] - 1) * ns + jm[:, None]
            tw = torch.cat([torch.ones(per, 1, dtype=torch.complex128),
                            passes[idx]], 1)
            v = v * tw
        out = torch.empty_like(z)
        out[..., ((j - jm) * r + jm)[:, None] + rr[None, :] * ns] = _dft_regs(v)
        z = out
    k = torch.arange(n)
    b = z[..., (n - k) % n].conj()
    e, o = (z + b) / 2, -1j * (z - b) / 2
    return e + split * o


def fengine_fused_torch(x: torch.Tensor, window, taps: int, n_chans: int, *,
                        history: torch.Tensor = None, frac_delay=None,
                        phase=None, gains=None, layout: str = "wire",
                        pitch: int = None) -> torch.Tensor:
    """Plain version of the fused F-engine: the plain FIR, then
    :func:`fengine_tail`, as separate float32 PyTorch ops on the same
    conventions; ``layout="operand"`` permutes the wire result into rows of
    ``pitch`` spectra, zeros past B."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    fir = pfb_fir(x, window, taps, 2 * n_chans, history=history,
                  impl="torch")
    res = fengine_tail(fir, n_chans, frac_delay=frac_delay, phase=phase,
                       gains=gains)
    pitch = _pitch(pitch, res.shape[-3], layout)
    if layout == "operand":
        return wire_to_operand(res, pitch)
    return _wire(res, res.shape[:-3], layout)


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
