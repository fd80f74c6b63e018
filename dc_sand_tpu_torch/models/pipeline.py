"""The streaming step: F-engine alone, or -> X-engine integration, or ->
B-engine.

PyTorch counterpart of :func:`dc_sand_tpu.models.pipeline.make_step` on
one device, in fengine, fx and beam mode.  The step takes its streaming
I/O in FRAME form (the JAX package's frames-I/O fast path): history
``(A*P, taps_pad, M)`` and chunk ``(A*P, B, M)`` int8, coarse delay
applied on the host feed.

    step(history, acc, chunk, frac, phase, gains, weights, reset) -> dict

(the JAX step's argument order without ``coarse``) updates ``history``
and ``acc`` IN PLACE, which takes the place of the JAX step's donated
carry, and returns the chunk's outputs.  Per chunk the F-engine writes
wire spectra ``(A*P, B, K, 2)``, int8, or float32 when the config does
not requantise (fengine mode only): the fused kernel K1, or with
``fused=False`` the standalone FIR kernel K6 and PyTorch ops (the JAX
package's ``impl="pallas"`` path).  Then

* fengine mode: returns ``{"spectra": (A, P, B, K, 2)}`` (a free view),
  ``acc`` is a rank-1 dummy, as in the JAX package;
* fx mode: the corner-turn as PyTorch glue (one ``permute().contiguous()``,
  :func:`dc_sand_tpu_torch.ops.xcorr.wire_to_a2`; on one device the
  corner-turn's all-to-all is an identity) and the packed CMAC (K2/K3)
  into ``acc``; returns ``{}``;
* beam mode: the beam kernel (K4/K4p/K5) reads the wire spectra, viewed
  for free as ``(A, P, B, K, 2)``, and returns ``{"beams": (nb, P, B, K,
  2)}`` (float32, or int8 when ``cfg.beam_quant_scale > 0``) and, when
  ``cfg.incoherent_beam``, ``"incoherent": (P, B, K)`` float32.  ``acc``
  is a rank-1 dummy, as in the JAX package.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops.beamform import beamform
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import (acc_shape, wire_to_a2,
                                         xcorr_accumulate_a2)

__all__ = ["make_step", "mode_for", "check_mode", "zero_vis_acc",
           "history_shape", "chunk_shape"]


def mode_for(cfg: ChainConfig) -> str:
    if cfg.n_beams > 0:
        return "beam"
    if cfg.run_xengine:
        return "fx"
    return "fengine"


def history_shape(cfg: ChainConfig) -> tuple:
    """Carried FIR history in frame form: ``(A*P, taps_pad, M)``."""
    return (cfg.n_ants * cfg.n_pols, taps_pad_for(cfg.n_taps), cfg.fft_size)


def chunk_shape(cfg: ChainConfig) -> tuple:
    """A chunk in frame form: ``(A*P, B, M)`` — the same bytes as the
    ``(A, P, chunk_samples)`` sample stream, row-major."""
    return (cfg.n_ants * cfg.n_pols, cfg.spectra_per_chunk, cfg.fft_size)


def zero_vis_acc(cfg: ChainConfig, device) -> torch.Tensor:
    """Zeroed integration carry: the packed ``(K, ap, ap)`` int32 plane in
    fx mode, a rank-1 dummy in the other modes (as the JAX package's)."""
    shape = (acc_shape(cfg.n_ants, cfg.n_pols, cfg.n_chans)
             if mode_for(cfg) == "fx" else (1,))
    return torch.zeros(shape, dtype=torch.int32, device=device)


def check_mode(cfg: ChainConfig) -> None:
    """Raise for configurations this port does not run yet."""
    mode = mode_for(cfg)
    if cfg.beam_stokes:
        raise NotImplementedError("Stokes beam detection is not ported")
    if cfg.beam_parallel:
        raise NotImplementedError("the beam-parallel (multi-device) B-engine "
                                  "is not ported")
    if cfg.time_shards != 1:
        raise NotImplementedError("time-sharded (SP) mode is not ported")
    if not cfg.apply_requant and mode != "fengine":
        raise NotImplementedError(f"{mode} mode without requantisation is "
                                  "not ported")


def make_step(cfg: ChainConfig, window, *, device, fused: bool = True):
    """Build the streaming step for ``cfg`` on ``device``: it launches the
    CUDA kernels on a CUDA device and runs their plain versions on the
    CPU.  ``fused`` picks the F-engine path (see
    :func:`dc_sand_tpu_torch.models.fengine.f_engine`)."""
    check_mode(cfg)
    mode = mode_for(cfg)
    device = torch.device(device)
    taps, n_chans = cfg.n_taps, cfg.n_chans
    w = torch.as_tensor(window, dtype=torch.float32, device=device).reshape(
        taps, cfg.fft_size).contiguous()

    def step(history, acc, chunk, frac, phase, gains, weights,
             reset) -> dict:
        s_l, b_l = chunk.shape[0], chunk.shape[1]
        q = f_engine(chunk, w, taps, n_chans, history=history,
                     frac_delay=frac.reshape(s_l, b_l)
                     if cfg.apply_delay else None,
                     phase=phase.reshape(s_l, b_l)
                     if cfg.apply_delay else None,
                     gains=gains if cfg.apply_requant else None,
                     fused=fused)                          # (S, B, K, 2)
        # the next chunk's history: the stream's last taps_pad frames
        tp = history.shape[1]
        if b_l >= tp:
            history.copy_(chunk[:, b_l - tp:])
        else:
            history.copy_(torch.cat([history, chunk], dim=1)[:, -tp:])
        if mode == "fengine":
            return {"spectra": q.reshape(cfg.n_ants, cfg.n_pols, b_l,
                                         n_chans, 2)}
        if mode == "fx":
            xcorr_accumulate_a2(acc, wire_to_a2(q), keep=0 if reset else 1)
            return {}
        beams, inc = beamform(
            q.reshape(cfg.n_ants, cfg.n_pols, b_l, n_chans, 2), weights,
            quant_scale=cfg.beam_quant_scale,
            incoherent=cfg.incoherent_beam)
        return ({"beams": beams} if inc is None
                else {"beams": beams, "incoherent": inc})

    return step
