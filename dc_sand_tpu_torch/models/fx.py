"""One-shot FX compositions (configs 3 and 4) and the time-sharded
F-engine, on one device or a mesh.

PyTorch counterpart of :mod:`dc_sand_tpu.models.fx`.  Each runs the
streaming step of :mod:`dc_sand_tpu_torch.models.pipeline` once over a
whole stream, cold: the stream's first ``taps - 1`` frames become the
step's carried history and the rest its chunk, with ``reset`` set.
``fx_step_local`` runs it on one device; ``make_sharded_fx_step`` over the
``fx`` axis of a mesh (antenna-sharded F-engines, the corner-turn through
the all-to-all kernel K7b, channel-sharded X-engines);
``make_time_sharded_fengine`` shards the sample stream over the ``time``
axis instead, behind the overlap-save halo of the ring kernel K7a, through
the FIR kernel K6 and ``torch.fft``, from a zero history.  Each takes and
returns global tensors.

On a mesh over several processes (:func:`~dc_sand_tpu_torch.parallel.
build_global_mesh`) every rank calls the step with the same global
inputs, as JAX's multi-process rungs build one global array from each
process's copy; a rank cuts its own shards from them, the corner-turn and
the halo cross the process boundary, and ``make_sharded_fx_step`` gives
every rank the whole visibility set while ``make_time_sharded_fengine``
gives each rank the spectra of its own shards.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.fengine import coarse_delay
from dc_sand_tpu_torch.models.pipeline import (gather_acc, gather_outputs,
                                               history_shape, make_step,
                                               shard_inputs, zero_vis_acc)
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import extract_vis
from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                        build_mesh)

__all__ = ["fx_step_local", "make_sharded_fx_step",
           "make_time_sharded_fengine"]


def _local_rows(mesh, x):
    """The rows of ``x`` (``(A*P, ...)``) that this rank's fx columns
    hold: all of them in one process."""
    if x is None or not mesh.multiprocess:
        return x
    _, fs = mesh.local_block()
    s_l = x.shape[0] // mesh.shape[FX_AXIS]
    return x[fs[0] * s_l:(fs[-1] + 1) * s_l]


def _once(cfg: ChainConfig, window, mesh, history, chunk, frac, phase,
          gains, fused: bool) -> tuple:
    """One step of ``cfg`` over ``mesh`` with ``reset`` set, from the
    global frame-form history ``(A*P, taps_pad, M)`` and chunk ``(A*P, B,
    M)`` (``frac``/``phase`` ``(A*P, B)`` or None, ``gains`` ``(K, 2)``
    or None): ``(outputs, accs, buffers)``, outputs and accumulators per
    shard of this process, ``buffers`` the accumulators' shared buffers on
    a multi-process mesh on the card (else None)."""
    step = make_step(cfg, window, mesh=mesh, fused=fused)
    hists, = shard_inputs(mesh, _local_rows(mesh, history), time=False)
    chunks, fracs, phases = shard_inputs(
        mesh, *(_local_rows(mesh, v) for v in (chunk, frac, phase)))
    devices = mesh.local_devices
    bufs = None
    if mesh.multiprocess and devices[0].type == "cuda" and \
            cfg.run_xengine:
        bufs = SharedBuffers(mesh, zero_vis_acc(cfg, "cpu", mesh).shape,
                             torch.int32)
        accs = bufs.local
    else:
        accs = [zero_vis_acc(cfg, dev, mesh) for dev in devices]
    gs = [None if gains is None else
          torch.as_tensor(gains, dtype=torch.float32).to(dev)
          for dev in devices]
    out = step(hists, accs, chunks, fracs, phases, gs, [None] * len(devices),
               True)
    return out, accs, bufs


def _fx(mesh, x, window, taps: int, n_chans: int, frac_delay, phase, gains,
        coarse_delays, max_delay: int, fused: bool) -> torch.Tensor:
    x = torch.as_tensor(x)
    if coarse_delays is not None:
        x = coarse_delay(x, coarse_delays, max_delay)
    a, p, t = x.shape
    m = 2 * n_chans
    if t % m or t // m < taps:
        raise ValueError(f"a stream of {t} samples is not taps - 1 + b "
                         f"whole frames of {m}")
    b = t // m - (taps - 1)
    cfg = ChainConfig(name="fx", n_ants=a, n_pols=p, n_chans=n_chans,
                      n_taps=taps, spectra_per_chunk=b, n_spectra_per_acc=b,
                      apply_delay=frac_delay is not None,
                      apply_requant=True, run_xengine=True)
    frames = x.reshape(a * p, t // m, m)
    history = torch.zeros(history_shape(cfg), dtype=torch.int8,
                          device=x.device)
    history[:, taps_pad_for(taps) - taps + 1:] = frames[:, :taps - 1]

    def rows(v):
        return None if v is None else torch.as_tensor(v).reshape(a * p, b)

    _, accs, bufs = _once(cfg, window, mesh, history, frames[:, taps - 1:],
                          rows(frac_delay), rows(phase), gains, fused)
    return extract_vis(gather_acc(accs, mesh, mesh.local_devices[0], bufs),
                       a, p)


def fx_step_local(x, window, taps: int, n_chans: int, *, frac_delay=None,
                  phase=None, gains=None, coarse_delays=None,
                  max_delay: int = 0, fused: bool = True) -> torch.Tensor:
    """One-device FX: F-engine -> (local) corner-turn -> X-engine.

    ``x: (ant, pol, t)`` int8, ``t = max_delay + (taps - 1 + b) * M`` ->
    visibilities ``(n_bl, pol, pol, k, 2)`` int32, integrated over the b
    spectra.  ``gains`` ``(k, 2)`` float32 re/im are required: the CMAC
    takes int8 spectra."""
    x = torch.as_tensor(x)
    return _fx(build_mesh([x.device]), x, window, taps, n_chans, frac_delay,
               phase, gains, coarse_delays, max_delay, fused)


def make_sharded_fx_step(mesh, window, taps: int, n_chans: int,
                         n_ants: int, *, max_delay: int = 0,
                         fused: bool = True):
    """The FX step over the mesh's ``fx`` axis (a mesh with one time row).

    ``step(x, frac_delay, phase, gains, coarse_delays=None)`` takes global
    tensors: ``x (ant, pol, t)`` int8, ``frac_delay``/``phase (ant, pol,
    b)``, ``gains (k, 2)``, ``coarse_delays (ant, pol)``, and returns the
    visibilities of :func:`fx_step_local` on the device of this process's
    first shard."""
    n_fx = mesh.shape[FX_AXIS]
    if mesh.shape[TIME_AXIS] != 1:
        raise ValueError("make_sharded_fx_step shards over fx only; build "
                         "the mesh with time_shards=1")
    if n_ants % n_fx or n_chans % n_fx:
        raise ValueError(f"ants {n_ants} and chans {n_chans} must divide "
                         f"over {n_fx} fx shards")

    def step(x, frac_delay, phase, gains, coarse_delays=None):
        return _fx(mesh, x, window, taps, n_chans, frac_delay, phase, gains,
                   coarse_delays, max_delay, fused)

    return step


def make_time_sharded_fengine(mesh, window, taps: int, n_chans: int):
    """The F-engine with the sample stream sharded over the mesh's
    ``time`` axis (SP mode, unfused: K6 and ``torch.fft``), antennas over
    its ``fx`` axis.

    ``fe(x)`` takes ``x (ant, pol, t)`` int8, ``t`` a whole number of
    frames that cuts into ``n_time`` shards of at least ``taps_pad``
    frames each, and returns float32 spectra ``(ant, pol, b, k, 2)`` on
    the first shard's device; the first ``taps - 1`` spectra see zero
    history (stream cold start).  On a mesh over several processes it
    returns the block of this rank's shards: its fx columns' antennas,
    its time shards' spectra."""
    m = 2 * n_chans
    n_t = mesh.shape[TIME_AXIS]

    def fe(x):
        x = torch.as_tensor(x)
        a, p, t = x.shape
        if t % (n_t * m):
            raise ValueError(f"stream of {t} samples does not cut into "
                             f"{n_t} shards of whole frames")
        cfg = ChainConfig(name="fengine", n_ants=a, n_pols=p,
                          n_chans=n_chans, n_taps=taps,
                          spectra_per_chunk=t // m, time_shards=n_t)
        history = torch.zeros(history_shape(cfg), dtype=torch.int8,
                              device=x.device)
        out, _, _ = _once(cfg, window, mesh, history,
                          x.reshape(a * p, t // m, m), None, None, None,
                          fused=False)
        return gather_outputs(out, cfg, mesh,
                              mesh.local_devices[0])["spectra"]

    return fe
