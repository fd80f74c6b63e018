"""Coarse delay as one gather into frame form (C2).

Integer-sample delay is a read-pointer offset.  Per stream row s the
delayed stream is read from the virtual row ``[lead_s | chunk_s]`` at
offset ``max_delay - clamp(d_s, 0, max_delay)``: ``L - max_delay + C``
samples, ``L`` the lead's length and ``C`` the chunk's.
:func:`coarse_gather` writes them straight into the frame form the
F-engine's split I/O reads: the first ``L - max_delay`` into the last
frames of a history ``(S, taps_pad, M)`` (behind the frames the F-engine
skips), the other ``C`` into the chunk's frames ``(S, B, M)``.  One
function serves both coarse modes:

* the device mode (``make_step(..., coarse_on_host=False)``): the lead is
  the carried lead-in history, ``L = max_delay + (taps-1)*M``, so the FIR
  overlap is gathered again with the current chunk's delay, as the JAX
  package's ``coarse_delay([history | chunk])`` does;
* the host mode (the runner's feed): the lead is the previous chunk's
  tail, ``L = max_delay``, and there is no history output.

On a CUDA tensor it launches ``csrc/coarse.cu`` (``dcs_coarse_gather``),
one launch for all the rows.  That kernel is the port's own: the JAX
package gathers outside any Pallas kernel, with a vmapped
``dynamic_slice`` (``dc_sand_tpu/models/fengine.py:21-46``), so it ports
no TPU kernel.  No one PyTorch call gathers a different offset a row into
frame form (``torch.gather`` would need an int64 index as large as the
chunk).  :func:`coarse_gather_torch` is the plain version, one slice a
stream; a CPU tensor takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["coarse_gather", "coarse_gather_torch", "carry_lead"]


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as rows ``(S, n)``: its leading dims flattened, the last one
    contiguous (rows may be any stride apart)."""
    if x.dim() == 1:
        raise ValueError(f"{name} needs a leading stream axis")
    x2 = x.reshape(-1, x.shape[-1]) if x.dim() > 2 else x
    if x2.shape[-1] > 1 and x2.stride(-1) != 1:
        raise ValueError(f"{name}'s samples must be contiguous")
    return x2


def _check(lead, chunk, max_delay, hist, out):
    """``(n_h, hist frames (S, taps_pad*M) or None, out rows (S, C))``."""
    s, n_c = chunk.shape
    if not out.is_contiguous() or (hist is not None
                                   and not hist.is_contiguous()):
        raise ValueError("out and hist must be contiguous")
    if lead.shape[0] != s:
        raise ValueError(f"lead has {lead.shape[0]} rows, chunk {s}")
    n_h = lead.shape[1] - max_delay
    if max_delay < 0 or n_h < 0:
        raise ValueError(f"a lead of {lead.shape[1]} samples cannot hold "
                         f"max_delay {max_delay}")
    out_rows = out.reshape(s, -1)
    if out_rows.shape[1] != n_c:
        raise ValueError(f"out holds {out_rows.shape[1]} samples a row, the "
                         f"chunk {n_c}")
    if n_h == 0:
        return 0, None, out_rows
    if hist is None:
        raise ValueError(f"a lead of {lead.shape[1]} samples past max_delay "
                         f"{max_delay} needs a history output")
    if hist.dim() != 3 or hist.shape[0] != s:
        raise ValueError(f"hist must be frames (S={s}, taps_pad, M), got "
                         f"{tuple(hist.shape)}")
    m = hist.shape[2]
    if n_h % m or n_h // m > hist.shape[1]:
        raise ValueError(f"{n_h} history samples are not at most "
                         f"{hist.shape[1]} frames of {m}")
    return n_h, hist.reshape(s, -1), out_rows


def coarse_gather(lead: torch.Tensor, chunk: torch.Tensor, coarse,
                  max_delay: int, *, out: torch.Tensor, hist=None,
                  impl: str = "auto"):
    """Write the delayed stream of ``[lead | chunk]`` into ``hist`` and
    ``out``; returns ``(hist, out)``.

    ``lead (..., L)`` int8 streams (the leading dims flattened to S rows,
    each row's samples contiguous) and ``chunk`` the same S rows of ``C``
    samples (``(S, C)``, or any shape of those bytes such as frames ``(S,
    B, M)`` or ``(A, P, C)``); ``coarse``:
    ``S`` integer delays, clamped to ``[0, max_delay]`` (an int32 tensor
    on the chunk's device for the kernel); ``out``: ``C`` samples a row
    (e.g. frames ``(S, B, M)``), contiguous; ``hist``: frames ``(S,
    taps_pad, M)`` whose last ``(L - max_delay) / M`` frames receive the
    first ``L - max_delay`` samples (None when ``L == max_delay``).

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch adds one to
    ``coarse_gather.launches``.
    """
    lead = _rows(lead, "lead")
    if chunk.dim() != 2:
        chunk = chunk.reshape(lead.shape[0], -1)
    chunk = _rows(chunk, "chunk")
    n_h, hist_rows, out_rows = _check(lead, chunk, max_delay, hist, out)
    if resolve_impl(impl, chunk) == "torch":
        coarse_gather_torch(lead, chunk, coarse, max_delay, hist_rows,
                            out_rows)
        return hist, out
    dev = chunk.device
    s = chunk.shape[0]
    for name, t in (("lead", lead), ("out", out), ("hist", hist)):
        if t is not None and (t.dtype != torch.int8 or t.device != dev):
            raise ValueError(f"{name} must be int8 on {dev}, got {t.dtype} "
                             f"on {t.device}")
    if not isinstance(coarse, torch.Tensor) or coarse.dtype != torch.int32 \
            or coarse.device != dev or coarse.numel() != s \
            or not coarse.is_contiguous():
        raise ValueError(f"coarse must be {s} contiguous int32 on {dev}")
    if not 1 <= s <= 65535:
        raise ValueError(f"the gather takes 1..65535 streams, got {s}")
    m_bytes = hist.shape[1] * hist.shape[2] if hist is not None else 0
    hist_ptr = (hist.data_ptr() + m_bytes - n_h) if n_h else 0
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_coarse_gather(
            lead.data_ptr(), lead.stride(0), lead.shape[1],
            chunk.data_ptr(), chunk.stride(0), chunk.shape[1],
            coarse.data_ptr(), max_delay, hist_ptr, m_bytes,
            out.data_ptr(), out_rows.shape[1], s,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_coarse_gather")
    coarse_gather.launches += 1
    return hist, out


coarse_gather.launches = 0


def coarse_gather_torch(lead, chunk, coarse, max_delay: int, hist_rows,
                        out_rows) -> None:
    """The plain gather on rows: ``lead (S, L)``, ``chunk (S, C)``,
    ``hist_rows (S, taps_pad*M)`` (its last ``L - max_delay`` samples
    written) or None, ``out_rows (S, C)``; one slice a stream, as the
    port's coarse delay always sliced."""
    s, n_c = chunk.shape
    n_h = lead.shape[1] - max_delay
    ds = np.broadcast_to(np.asarray(
        coarse.cpu() if isinstance(coarse, torch.Tensor) else coarse,
        np.int64).reshape(-1), (s,))
    buf = torch.cat([lead, chunk], dim=-1)
    for i in range(s):
        off = max_delay - int(np.clip(ds[i], 0, max_delay))
        if n_h:
            hist_rows[i, hist_rows.shape[1] - n_h:] = buf[i, off:off + n_h]
        out_rows[i] = buf[i, off + n_h:off + n_h + n_c]


def carry_lead(lead: torch.Tensor, chunk: torch.Tensor) -> None:
    """The next lead in place: the last ``L`` samples of ``[lead | chunk]``
    (``(..., L)`` and ``(..., C)``, rows alike).  Called after the gather
    has read the old lead, in stream order: one copy."""
    n = lead.shape[-1]
    if n == 0:
        return
    c = chunk.numel() // (lead.numel() // n)
    chunk = chunk.reshape(lead.shape[:-1] + (c,))
    if c >= n:
        lead.copy_(chunk[..., c - n:])
    else:
        lead.copy_(torch.cat([lead[..., c:], chunk], dim=-1))
