"""Checkpoint and resume of the streaming state.

PyTorch counterpart of the single-process part of
:mod:`dc_sand_tpu.runtime.checkpoint`: the carry (FIR history and
accumulator), the beam weights, the delay model, the gains, the counters
and the stream position go into one ``.npz`` at any chunk boundary, with
the JAX file's keys and meanings, so that each package reads the other's
file.  The delay model is part of it on purpose: a drifting model (d1 !=
0) keeps drifting from where it stopped.

The forms are those a JAX runner of the same ``cfg`` writes on the CPU:

* ``history``: the sample-axis form ``(A, P, (taps-1)*M)``, the stream's
  last taps-1 frames (the runner's first ``taps_pad - taps + 1`` frames
  are never read); in SP mode one block per time shard, joined on the
  last axis; in the device coarse mode (``coarse_on_host=False``) the
  lead-in ``(A, P, max_delay + (taps-1)*M)`` as it is, with an empty
  ``host_tail`` (the file's ``delay_max`` then sizes the lead-in);
* ``vis_acc``: the packed ``(K, ap, ap)`` int32 plane in natural channel
  order, with a leading axis of one partial per time shard in SP mode;
  in fengine and beam mode the rank-1 dummy both packages carry;
* a runner on a mesh saves the global carry, gathered from its shards
  (the inverse of the cut that :func:`load_state` makes);
* a runner on a mesh over several processes saves, on every rank, its own
  shards into ``{path}.proc{i}of{n}.npz``, as the JAX multi-process
  runner does: ``process_shape`` ``[i, n]`` and, per carry and shard, the
  shard and its global index box (``history_shard{j}`` and
  ``history_idx{j}``; ``vis_acc``, ``weights`` alike), in the forms
  above; ``host_tail`` holds the rank's own antennas' tail.  No rank
  gathers another's carry, so ranks on several nodes need nothing more:
  each writes and reads its own file on its own disk.

:func:`load_state` is :func:`~dc_sand_tpu_torch.runtime.jax_state.load_jax_checkpoint`
without a channel permutation: it refuses another config's file, another
``max_delay``, other shapes, a multi-process file in one process and
another process count or layout across several, and copies the carry in
place, so tensors that hold its addresses (a CUDA graph of
``run_batched``) stay valid.
"""

from __future__ import annotations

import numpy as np
import torch

from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.parallel import FX_AXIS, TIME_AXIS
from dc_sand_tpu_torch.runtime.jax_state import (load_jax_checkpoint,
                                                  process_path, shard_boxes)

__all__ = ["save_state", "load_state"]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _global_carry(runner) -> tuple:
    """``(history, vis_acc)`` of the whole array from the runner's
    shards, as numpy in the file's forms."""
    cfg, mesh = runner.cfg, runner.mesh
    n_t, n_f = mesh.shape[TIME_AXIS], mesh.shape[FX_AXIS]
    a, p, m, taps = cfg.n_ants, cfg.n_pols, cfg.fft_size, cfg.n_taps
    pad0 = taps_pad_for(taps) - taps + 1
    rows = [[None] * n_f for _ in range(n_t)]
    for d in range(mesh.size):
        t, f = mesh.coords(d)
        rows[t][f] = d
    if runner._lead is not None:
        hist = np.concatenate([_host(runner.history[d]) for d in rows[0]])
    else:
        hist = np.concatenate(
            [np.concatenate([_host(runner.history[d][:, pad0:])
                             for d in row]).reshape(a, p, (taps - 1) * m)
             for row in rows], axis=-1)
    if runner.mode != "fx":
        return hist, _host(runner.vis_acc[0])
    parts = [np.concatenate([_host(runner.vis_acc[d]) for d in row])
             for row in rows]
    return hist, np.stack(parts) if cfg.time_shards > 1 else parts[0]


def _process_carry(runner) -> dict:
    """This rank's shards of a multi-process runner's carries and weights,
    each with its global index box (:func:`~dc_sand_tpu_torch.runtime.
    jax_state.shard_boxes`)."""
    cfg, mesh = runner.cfg, runner.mesh
    p, m, taps = cfg.n_pols, cfg.fft_size, cfg.n_taps
    pad0 = taps_pad_for(taps) - taps + 1
    out = {"process_shape": np.array([mesh.rank, mesh.process_count],
                                     np.int64)}
    counts = {}
    for k, d in enumerate(mesh.local_shards):
        hist = (_host(runner.history[k]) if runner._lead is not None else
                _host(runner.history[k][:, pad0:]).reshape(
                    -1, p, (taps - 1) * m))
        values = {"history": hist,
                  "weights": _host(runner._weights_sh[k]),
                  "vis_acc": _host(runner.vis_acc[k])}
        for name, box in shard_boxes(runner, d).items():
            j = counts.get(name, 0)
            counts[name] = j + 1
            out[f"{name}_shard{j}"] = values[name].reshape(
                [hi - lo for lo, hi in box])
            out[f"{name}_idx{j}"] = np.array(box, np.int64)
    return out


def save_state(runner, path: str) -> str:
    """Save ``runner``'s streaming state; returns the path actually
    written: ``path`` with ``.npz`` appended when it lacks the suffix
    (``np.savez`` would append it), the name callers must report and
    reload.  On a multi-process mesh every rank calls it with the same
    ``path`` and writes, and returns, its own file."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    dm = runner.delay_model
    c = runner.counters
    if runner.mesh.multiprocess:
        path = process_path(path, runner.mesh)
        carry = _process_carry(runner)
    else:
        history, vis_acc = _global_carry(runner)
        carry = dict(history=history, vis_acc=vis_acc,
                     weights=_host(runner.weights))
    np.savez(
        path,
        t0=runner.t0,
        chunk_idx=runner.chunk_idx,
        acc_spectra=runner._acc_spectra,
        acc_integrated=runner._acc_integrated,
        acc_first_chunk=runner._acc_first_chunk,
        config_hash=runner.cfg.config_hash(),
        host_tail=(_host(runner._tail) if runner._tail is not None
                   else np.zeros(0, np.int8)),
        delay_d0=dm.d0, delay_d1=dm.d1, delay_p0=dm.p0, delay_p1=dm.p1,
        delay_d2=dm.d2, delay_p2=dm.p2, delay_t_ref=dm.t_ref,
        delay_max=dm.max_delay,
        gains=_host(runner.gains),
        counters=np.array([c.chunks_in, c.chunks_dropped, c.samples_in,
                           c.spectra_out, c.dumps], np.int64),
        **carry,
    )
    return path


def load_state(runner, path: str) -> None:
    """Restore ``runner``'s streaming state in place from a file of
    :func:`save_state` or of the JAX package's single-process
    ``save_state`` (``path`` with or without its ``.npz``)."""
    load_jax_checkpoint(runner, path)
