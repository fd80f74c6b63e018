"""The streaming fx step: F-engine -> corner-turn -> X-engine integration.

PyTorch counterpart of :func:`dc_sand_tpu.models.pipeline.make_step` in
fx mode on one device.  The step takes its streaming I/O in FRAME form
(the JAX package's frames-I/O fast path): history ``(A*P, taps_pad, M)``
and chunk ``(A*P, B, M)`` int8, coarse delay applied on the host feed.

    step(history, acc, chunk, frac, phase, gains, reset) -> None

updates ``history`` and ``acc`` IN PLACE, which takes the place of the
JAX step's donated carry.  Per chunk it runs two kernels on the card —
the fused F-engine (K1) and the packed CMAC (K2/K3) — with the
corner-turn between them as PyTorch glue (one ``permute().contiguous()``,
:func:`dc_sand_tpu_torch.ops.xcorr.wire_to_a2`; on one device the
corner-turn's all-to-all is an identity).
"""

from __future__ import annotations

import torch

from dc_sand_tpu.config import ChainConfig
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops.fengine_fused import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import (acc_shape, wire_to_a2,
                                         xcorr_accumulate_a2)

__all__ = ["make_step", "mode_for", "zero_vis_acc", "history_shape",
           "chunk_shape"]


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
    """Zeroed packed ``(K, ap, ap)`` int32 integration carry."""
    return torch.zeros(acc_shape(cfg.n_ants, cfg.n_pols, cfg.n_chans),
                       dtype=torch.int32, device=device)


def check_fx(cfg: ChainConfig) -> None:
    """Raise for configurations this port does not run yet."""
    if mode_for(cfg) != "fx":
        raise NotImplementedError(
            f"only fx mode is ported (config {cfg.name!r} is "
            f"{mode_for(cfg)} mode)")
    if cfg.time_shards != 1:
        raise NotImplementedError("time-sharded (SP) mode is not ported")
    if not cfg.apply_requant:
        raise NotImplementedError("fx mode without requantisation is not "
                                  "ported")


def make_step(cfg: ChainConfig, window, *, device):
    """Build the fx streaming step for ``cfg`` on ``device``: it launches
    the CUDA kernels on a CUDA device and runs their plain versions on the
    CPU."""
    check_fx(cfg)
    device = torch.device(device)
    taps, n_chans = cfg.n_taps, cfg.n_chans
    w = torch.as_tensor(window, dtype=torch.float32, device=device).reshape(
        taps, cfg.fft_size).contiguous()

    def step(history, acc, chunk, frac, phase, gains, reset) -> None:
        s_l, b_l = chunk.shape[0], chunk.shape[1]
        q = f_engine(chunk, w, taps, n_chans, history=history,
                     frac_delay=frac.reshape(s_l, b_l)
                     if cfg.apply_delay else None,
                     phase=phase.reshape(s_l, b_l)
                     if cfg.apply_delay else None,
                     gains=gains)                          # (S, B, K, 2)
        # the next chunk's history: the stream's last taps_pad frames
        tp = history.shape[1]
        if b_l >= tp:
            history.copy_(chunk[:, b_l - tp:])
        else:
            history.copy_(torch.cat([history, chunk], dim=1)[:, -tp:])
        xcorr_accumulate_a2(acc, wire_to_a2(q), keep=0 if reset else 1)

    return step
