"""Carry a JAX run's streaming state over into the port.

:func:`load_jax_checkpoint` reads the single-process ``.npz`` that
:func:`dc_sand_tpu.runtime.checkpoint.save_state` writes (plain numpy, so
no jax is needed) into a :class:`~dc_sand_tpu_torch.runtime.runner.FXRunner`,
which then continues the stream where the JAX run stopped.  A JAX run on
a mesh saves global arrays, which are cut to the port runner's shards;
an SP run's history holds one block per time shard and its accumulator a
leading time axis, one partial per time shard.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import acc_shape
from dc_sand_tpu_torch.parallel import FX_AXIS

__all__ = ["load_jax_checkpoint", "window_and_gains_from_numpy"]


def _frames_history(hist: np.ndarray, cfg, want: tuple) -> np.ndarray:
    """The JAX carry in the port's frame form ``(A*P, taps_pad, M)``.

    A frames-I/O run (the fused TPU path) saved it in that form already.
    A sample-axis run saved ``(A, P, (taps-1)*M)``: the stream's last
    taps-1 frames, which become the last taps-1 of the taps_pad frames
    (the first ``pad0`` frames are never read)."""
    if hist.shape == want:
        return hist
    m, taps = cfg.fft_size, cfg.n_taps
    if hist.shape == (cfg.n_ants, cfg.n_pols, (taps - 1) * m):
        out = np.zeros(want, np.int8)
        pad0 = taps_pad_for(taps) - taps + 1
        out[:, pad0:] = hist.reshape(cfg.n_ants * cfg.n_pols, taps - 1, m)
        return out
    raise ValueError(
        f"checkpoint history shape {hist.shape} is neither the frame form "
        f"{want} nor the sample-axis form "
        f"{(cfg.n_ants, cfg.n_pols, (taps - 1) * m)} (a device coarse-delay "
        "lead-in is not supported)")


def load_jax_checkpoint(runner, path: str, channel_perm=None) -> None:
    """Restore ``runner``'s carry in place from a JAX ``save_state`` file.

    The config hash must match (the port runs the same ``ChainConfig``).
    ``channel_perm``: when the JAX run used the fused native fx path, its
    accumulator's channel axis is in native (k2-major) order; pass
    ``dc_sand_tpu.ops.fengine_fused.native_channel_perm(n_chans)`` to put
    it back in natural order (``acc_natural = acc_native[perm]``).  The
    beam weights are restored too; in fengine and beam mode the
    accumulator is the rank-1 dummy that both packages carry.  A runner
    on a mesh takes a checkpoint of the same ``cfg`` (``time_shards``
    included) from a JAX run on any mesh of one process.
    """
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"      # np.savez appended the suffix at save time
    z = np.load(path, allow_pickle=False)
    if "process_shape" in z.files:
        raise ValueError("multi-process checkpoints are not supported")
    cfg = runner.cfg
    saved_hash = str(z["config_hash"])
    if saved_hash != cfg.config_hash():
        raise ValueError(f"checkpoint config hash {saved_hash} != runner "
                         f"config {cfg.config_hash()}")
    # an older file may lack the delay / gain / counter block (then the
    # runner keeps its own), as the JAX loader allows
    has_delay = "delay_d0" in z.files
    if has_delay and int(z["delay_max"]) != runner.max_delay:
        raise ValueError(
            f"checkpoint delay max_delay {int(z['delay_max'])} != runner's "
            f"{runner.max_delay}; build the resuming runner with a "
            "DelayModel of the same max_delay")
    n_t = cfg.time_shards
    want = (cfg.n_ants * cfg.n_pols, taps_pad_for(cfg.n_taps), cfg.fft_size)
    # one history block per time shard (only shard 0's is live)
    hists = [_frames_history(h, cfg, want)
             for h in np.split(z["history"], n_t, axis=-1)]
    acc = z["vis_acc"]
    acc_want = (1,)
    if runner.mode == "fx":
        acc_want = ((n_t,) if n_t > 1 else ()) + acc_shape(
            cfg.n_ants, cfg.n_pols, cfg.n_chans)
    if acc.shape != acc_want:
        raise ValueError(f"checkpoint accumulator shape {acc.shape} != "
                         f"{acc_want}")
    if channel_perm is not None:
        acc = np.take(acc, np.asarray(channel_perm), axis=-3)
    weights = z["weights"]
    if weights.shape != tuple(runner.weights.shape):
        raise ValueError(f"checkpoint weights shape {weights.shape} != "
                         f"{tuple(runner.weights.shape)}")
    runner.weights = weights
    _restore_carry(runner, hists, acc)
    runner.t0 = int(z["t0"])
    runner.chunk_idx = int(z["chunk_idx"])
    runner._acc_spectra = int(z["acc_spectra"])
    runner._acc_integrated = int(z["acc_integrated"])
    if "acc_first_chunk" in z.files:
        runner._acc_first_chunk = int(z["acc_first_chunk"])
    if "host_tail" in z.files and z["host_tail"].size:
        runner._tail = torch.as_tensor(z["host_tail"], device=runner.device)
    if not has_delay:
        return
    dm = runner.delay_model
    dm.d0 = z["delay_d0"].copy()
    dm.d1 = z["delay_d1"].copy()
    dm.p0 = z["delay_p0"].copy()
    dm.p1 = z["delay_p1"].copy()
    if "delay_d2" in z.files:
        dm.d2 = z["delay_d2"].copy()
        dm.p2 = z["delay_p2"].copy()
        dm.t_ref = int(z["delay_t_ref"])
    else:                         # a file of the linear model, epoch 0
        dm.d2 = np.zeros_like(dm.d0)
        dm.p2 = np.zeros_like(dm.p0)
        dm.t_ref = 0
    runner.gains = torch.as_tensor(z["gains"], dtype=torch.float32,
                                   device=runner.device).contiguous()
    c = z["counters"]
    runner.counters = dataclasses.replace(
        runner.counters, chunks_in=int(c[0]), chunks_dropped=int(c[1]),
        samples_in=int(c[2]), spectra_out=int(c[3]), dumps=int(c[4]))


def _restore_carry(runner, hists: list, acc: np.ndarray) -> None:
    """Cut the global carry to the shards of the runner's mesh: antenna
    rows and time block for the history, channel block and time partial
    for the accumulator."""
    def put(dst, src):
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))

    mesh = runner.mesh
    n_f = mesh.shape[FX_AXIS]
    parts = acc if runner.cfg.time_shards > 1 else acc[None]
    s_l = hists[0].shape[0] // n_f
    k_l = acc.shape[-3] // n_f if runner.mode == "fx" else None
    for d, (h, a) in enumerate(zip(runner.history, runner.vis_acc)):
        t, f = mesh.coords(d)
        put(h, hists[t][f * s_l:(f + 1) * s_l])
        put(a, acc if k_l is None else parts[t][f * k_l:(f + 1) * k_l])


def window_and_gains_from_numpy(window, gains, taps: int, device):
    """The numpy parameters as device tensors: the prototype window
    ``(taps, M)`` float32 and the gains ``(K, 2)`` float32 re/im (a
    complex ``(K,)`` array is split into re/im)."""
    w = np.asarray(window, np.float32)
    g = np.asarray(gains)
    if np.iscomplexobj(g):
        g = np.stack([g.real, g.imag], -1)
    return (torch.as_tensor(w.reshape(taps, -1), device=device),
            torch.as_tensor(g.astype(np.float32), device=device).contiguous())
