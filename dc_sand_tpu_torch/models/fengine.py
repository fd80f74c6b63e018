"""The F-engine: coarse delay -> PFB -> fine delay/fringe -> requantise.

PyTorch counterpart of :func:`dc_sand_tpu.models.fengine.f_engine`
(golden semantics: :func:`dc_sand_tpu_torch.golden.chain.f_engine`).  Two
paths run the chain after the coarse delay:

* fused (the default): the fused F-engine
  (:mod:`dc_sand_tpu_torch.ops.fengine_fused`), one CUDA kernel launch
  (K1) on a CUDA tensor;
* unfused (``fused=False``), the counterpart of the JAX package's
  ``impl="pallas"`` path: the standalone FIR kernel (K6,
  :func:`dc_sand_tpu_torch.ops.pfb.pfb_fir`) reading history and chunk
  separately, then ``torch.fft.rfft``, the phasor and the requantisation
  as PyTorch ops (the JAX package runs those outside any Pallas kernel
  too).

On a CPU tensor both paths run the plain per-stage ops.  Both return the
wire layout, ``layout="wire_flat"`` its ``(..., B, 2K)`` view, or with
``layout="operand"`` the X-engine's operand layout ``(K, 2, S, pitch)``
(see :mod:`dc_sand_tpu_torch.ops.fengine_fused`): the fused kernel writes
it itself, the unfused path permutes its wire spectra
(:func:`~dc_sand_tpu_torch.ops.xcorr.wire_to_operand`).
"""

from __future__ import annotations

from typing import Optional

import torch

from dc_sand_tpu_torch.ops.coarse import coarse_gather
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused, fengine_tail
from dc_sand_tpu_torch.ops.pfb import pfb_fir
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand

__all__ = ["f_engine", "coarse_delay"]


def coarse_delay(x: torch.Tensor, delays, max_delay: int) -> torch.Tensor:
    """Integer-sample delay via read-pointer offset (C2).

    ``x: (..., T)`` with ``max_delay`` lead-in samples; ``delays``
    broadcastable over the leading axes.  Output length ``T - max_delay``;
    a stream delayed by d reads from ``max_delay - d``.  Out-of-range
    delays CLAMP to ``[0, max_delay]``, as the JAX version's
    ``dynamic_slice`` does (the golden model raises instead).  One gather
    (:func:`~dc_sand_tpu_torch.ops.coarse.coarse_gather`): the kernel on a
    CUDA tensor, one slice a stream on the CPU.
    """
    lead = tuple(x.shape[:-1])
    t_len = x.shape[-1]
    rows = x.reshape(-1, t_len)
    ds = torch.as_tensor(delays, device=x.device).to(torch.int32)
    ds = torch.broadcast_to(ds, lead).reshape(-1).contiguous()
    out = torch.empty(lead + (t_len - max_delay,), dtype=x.dtype,
                      device=x.device)
    coarse_gather(rows[:, :max_delay], rows[:, max_delay:], ds, max_delay,
                  out=out)
    return out


def f_engine(x: torch.Tensor, window, taps: int, n_chans: int, *,
             history: Optional[torch.Tensor] = None,
             coarse_delays=None, max_delay: int = 0,
             frac_delay=None, phase=None, gains=None, layout: str = "wire",
             pitch: Optional[int] = None, impl: str = "auto",
             fused: bool = True) -> torch.Tensor:
    """Full F-engine on ``x: (..., t)`` int8 real streams.

    ``history`` (streaming split-I/O mode): ``x`` is the new chunk as
    frames ``(..., B, M)`` and ``history`` the carried overlap-save tail
    ``(..., taps_pad, M)``; coarse delay then rides the host feed
    (``coarse_delays`` must be None).

    Returns the wire format: int8 ``(..., b, k, 2)`` with ``gains``
    (``(k, 2)`` float32 re/im), float32 ``(..., b, k, 2)`` without; with
    ``layout="operand"`` (gains needed) int8 ``(k, 2, S, pitch)``, zeros
    past b (``pitch`` default b).  ``fused``
    picks the path (module docstring); ``impl`` goes to the kernel's
    wrapper (K1, or K6 when unfused).
    """
    if history is not None and coarse_delays is not None:
        raise ValueError("split-I/O mode keeps coarse delay on the "
                         "host/ingest path (coarse_delays must be None)")
    if coarse_delays is not None:
        x = coarse_delay(x, coarse_delays, max_delay)
    if fused:
        return fengine_fused(x, window, taps, n_chans, history=history,
                             frac_delay=frac_delay, phase=phase, gains=gains,
                             layout=layout, pitch=pitch, impl=impl)
    fir = pfb_fir(x, window, taps, 2 * n_chans, history=history, impl=impl)
    wire = fengine_tail(fir, n_chans, frac_delay=frac_delay, phase=phase,
                        gains=gains)
    if layout == "operand":
        return wire_to_operand(wire, pitch)
    if layout == "wire_flat":
        return wire.reshape(wire.shape[:-2] + (2 * n_chans,))
    return wire
