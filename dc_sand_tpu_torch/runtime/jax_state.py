"""Carry a JAX run's streaming state over into the port.

:func:`load_jax_checkpoint` reads the single-process ``.npz`` that
:func:`dc_sand_tpu.runtime.checkpoint.save_state` writes (plain numpy, so
no jax is needed) into a :class:`~dc_sand_tpu_torch.runtime.runner.FXRunner`,
which then continues the stream where the JAX run stopped.  A JAX run on
a mesh saves global arrays, which are cut to the port runner's shards;
an SP run's history holds one block per time shard and its accumulator a
leading time axis, one partial per time shard.

A runner on a mesh over several processes reads its own rank's file
``{path}.proc{i}of{n}.npz``, which a JAX multi-process run (or the
port's :func:`~dc_sand_tpu_torch.runtime.checkpoint.save_state` on such
a mesh) writes: ``process_shape`` ``[i, n]``, and for each carry one
``{name}_shard{j}`` with its global index box ``{name}_idx{j}`` (start
and stop a dimension) per addressable shard.  Each of the rank's shards
takes the entry whose box is its own, so the process count and the mesh
layout must be the save's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import acc_shape
from dc_sand_tpu_torch.parallel import FX_AXIS, TIME_AXIS

__all__ = ["load_jax_checkpoint", "window_and_gains_from_numpy",
           "process_path", "shard_boxes"]


def process_path(path: str, mesh) -> str:
    """This rank's file of a multi-process checkpoint ``path`` (with its
    ``.npz``): ``{stem}.proc{i}of{n}.npz``."""
    return path[:-len(".npz")] + f".proc{mesh.rank}of{mesh.process_count}.npz"


def shard_boxes(runner, d: int) -> dict:
    """The global index boxes ``((start, stop), ...)`` of shard ``d``'s
    carries, by key, in the forms of the JAX multi-process file: the
    history in the sample-axis form ``(A, P, n_t*(taps-1)*M)`` cut by
    antennas and time block, the fx accumulator ``(K, ap, ap)`` (with a
    leading time axis in SP mode) by channels and time, the weights
    ``(nb, A, K, 2)`` by antennas.  In fengine and beam mode the dummy
    accumulator is one unsharded array (shard 0's box only)."""
    cfg, mesh = runner.cfg, runner.mesh
    n_t, n_f = mesh.shape[TIME_AXIS], mesh.shape[FX_AXIS]
    t, f = mesh.coords(d)
    a_l, p, k = cfg.n_ants // n_f, cfg.n_pols, cfg.n_chans
    span = (runner.history[0].shape[-1] if runner._lead
            else (cfg.n_taps - 1) * cfg.fft_size)
    boxes = {"history": ((f * a_l, (f + 1) * a_l), (0, p),
                         (t * span, (t + 1) * span)),
             "weights": ((0, runner.weights.shape[0]),
                         (f * a_l, (f + 1) * a_l), (0, k), (0, 2))}
    if runner.mode == "fx":
        ap, k_l = cfg.n_ants * p, k // n_f
        acc = ((f * k_l, (f + 1) * k_l), (0, ap), (0, ap))
        boxes["vis_acc"] = ((t, t + 1),) + acc if n_t > 1 else acc
    elif d == mesh.local_shards[0]:
        boxes["vis_acc"] = ((0, 1),)
    return boxes


def _frames_history(hist: np.ndarray, cfg, want: tuple,
                    lead: bool = False) -> np.ndarray:
    """The JAX carry in the port's frame form ``(A*P, taps_pad, M)``.

    A frames-I/O run (the fused TPU path) saved it in that form already.
    A sample-axis run saved ``(A, P, (taps-1)*M)`` (``want[0] / P``
    antennas, all or a shard's): the stream's last
    taps-1 frames, which become the last taps-1 of the taps_pad frames
    (the first ``pad0`` frames are never read).

    A runner in the device coarse mode (``lead``) wants the lead-in
    ``(A, P, max_delay + (taps-1)*M)`` (``want``), which it takes as it
    is."""
    if hist.shape == want:
        return hist
    m, taps, p = cfg.fft_size, cfg.n_taps, cfg.n_pols
    if lead:
        raise ValueError(
            f"checkpoint history shape {hist.shape} is not the device "
            f"coarse mode's lead-in {want}: a run with coarse on the host "
            "resumes in a runner with coarse_on_host=True")
    a = want[0] // p
    if hist.shape == (a, p, (taps - 1) * m):
        out = np.zeros(want, np.int8)
        pad0 = taps_pad_for(taps) - taps + 1
        out[:, pad0:] = hist.reshape(want[0], taps - 1, m)
        return out
    if hist.ndim == 3 and hist.shape[:2] == (a, p) \
            and hist.shape[2] > (taps - 1) * m:
        raise ValueError(
            f"checkpoint history shape {hist.shape} is a device coarse-delay "
            "lead-in: resume in a runner with coarse_on_host=False")
    raise ValueError(
        f"checkpoint history shape {hist.shape} is neither the frame form "
        f"{want} nor the sample-axis form {(a, p, (taps - 1) * m)}")


def _history_want(runner, n_ants: int) -> tuple:
    """The runner's history form for ``n_ants`` antennas: frames ``(n_ants
    * P, taps_pad, M)``, or in the device coarse mode the lead-in ``(n_ants,
    P, L)``."""
    cfg = runner.cfg
    if runner._lead:
        return (n_ants, cfg.n_pols, runner.history[0].shape[-1])
    return (n_ants * cfg.n_pols, taps_pad_for(cfg.n_taps), cfg.fft_size)


def load_jax_checkpoint(runner, path: str, channel_perm=None) -> None:
    """Restore ``runner``'s carry in place from a JAX ``save_state`` file.

    A runner in the device coarse mode (``coarse_on_host=False``) takes
    the lead-in history of a JAX run in that mode; a runner with coarse on
    the host refuses it, and the other way round (the two carry different
    streams).

    The config hash must match (the port runs the same ``ChainConfig``).
    ``channel_perm``: when the JAX run used the fused native fx path, its
    accumulator's channel axis is in native (k2-major) order; pass
    ``dc_sand_tpu.ops.fengine_fused.native_channel_perm(n_chans)`` to put
    it back in natural order (``acc_natural = acc_native[perm]``).  The
    beam weights are restored too; in fengine and beam mode the
    accumulator is the rank-1 dummy that both packages carry.  A runner
    on a mesh takes a checkpoint of the same ``cfg`` (``time_shards``
    included) from a JAX run on any mesh of one process; a runner on a
    multi-process mesh takes its rank's file of a run with as many
    processes and the same mesh layout (module docstring).
    """
    mesh = runner.mesh
    if not path.endswith(".npz") and (mesh.multiprocess
                                      or os.path.exists(path + ".npz")):
        path = path + ".npz"      # np.savez appended the suffix at save time
    if mesh.multiprocess:
        path = process_path(path, mesh)
        if not os.path.exists(path):
            raise ValueError(
                f"multi-process checkpoint file {path} not found — was the "
                "save made with the same process count "
                f"({mesh.process_count})?")
    z = np.load(path, allow_pickle=False)
    if ("process_shape" in z.files) != mesh.multiprocess:
        raise ValueError("a multi-process checkpoint loads into a runner on "
                         "a multi-process mesh, and only such a one")
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
    if mesh.multiprocess:
        if channel_perm is not None:
            raise NotImplementedError("channel_perm on a multi-process "
                                      "checkpoint")
        _restore_process_shards(runner, z)
    else:
        _restore_global(runner, z, channel_perm)
    _restore_stream(runner, z, has_delay)


def _restore_global(runner, z, channel_perm) -> None:
    """The carry and weights of a single-process file, cut to the
    runner's shards."""
    cfg = runner.cfg
    n_t = cfg.time_shards
    want = _history_want(runner, cfg.n_ants)
    # one history block per time shard (only shard 0's is live)
    hists = [_frames_history(h, cfg, want, runner._lead)
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


def _shards_of(z, name: str) -> dict:
    """A multi-process file's entries of ``name``: box -> array."""
    out, j = {}, 0
    while f"{name}_shard{j}" in z.files:
        box = tuple((int(lo), int(hi)) for lo, hi in z[f"{name}_idx{j}"])
        out[box] = z[f"{name}_shard{j}"]
        j += 1
    if not out:
        raise ValueError(f"checkpoint is missing shards for '{name}'")
    return out


def _restore_process_shards(runner, z) -> None:
    """Each of this rank's shards from the entry of its own global box
    (the JAX loader's ``make_array_from_callback`` asks for the same)."""
    mesh, cfg = runner.mesh, runner.cfg
    saved_n = int(z["process_shape"][1])
    if saved_n != mesh.process_count:
        raise ValueError(
            f"checkpoint saved with {saved_n} processes, restoring under "
            f"{mesh.process_count}")
    saved = {name: _shards_of(z, name)
             for name in ("history", "vis_acc", "weights")}
    a_l = cfg.n_ants // mesh.shape[FX_AXIS]
    want = _history_want(runner, a_l)

    def take(name, key):
        if key not in saved[name]:
            raise ValueError(
                f"checkpoint shard layout mismatch for '{name}': this "
                f"process needs slice {key} but saved "
                f"{sorted(saved[name])} — resume with the same process "
                "count and mesh shape as the save")
        return np.ascontiguousarray(saved[name][key])

    put = _copy_into
    for k, d in enumerate(mesh.local_shards):
        boxes = shard_boxes(runner, d)
        put(runner.history[k], _frames_history(
            take("history", boxes["history"]), cfg, want, runner._lead))
        w = take("weights", boxes["weights"])
        put(runner._weights_sh[k], w)
        f0 = boxes["weights"][1][0]
        put(runner._weights[:, f0:f0 + a_l], w)
        if "vis_acc" in boxes:
            acc = take("vis_acc", boxes["vis_acc"])
            put(runner.vis_acc[k],
                acc.reshape(runner.vis_acc[k].shape))


def _copy_into(dst: torch.Tensor, src: np.ndarray) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint shard of shape {src.shape} for a "
                         f"carry of {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))


def _restore_stream(runner, z, has_delay: bool) -> None:
    """Stream position, the coarse-delay tail, the delay model, gains and
    counters."""
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
    put = _copy_into
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
