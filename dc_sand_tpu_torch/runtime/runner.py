"""Chunked streaming runner (C21), fengine, fx and beam mode, on one
device or on a device mesh.

PyTorch counterpart of :class:`dc_sand_tpu.runtime.runner.FXRunner`:
feed a chunk to the device, advance the delay polynomials on the host,
apply the coarse delay as a read-pointer offset on the device, and run
the step — in fengine mode the F-engine alone, handing each chunk's
spectra to ``on_output``; in fx mode F-engine + corner-turn + CMAC,
dumping the integration at the accumulation cadence; in beam mode
F-engine + beam kernel, handing each chunk's beams to ``on_output``.
The FIR history and the packed accumulator live on the device and are
updated in place.

The runner keeps one carry per shard of its mesh
(:func:`dc_sand_tpu_torch.parallel.build_mesh`), as lists in shard order;
one device is a mesh of one shard.  The coarse shift runs on the whole
chunk on the first shard's device; the chunk is then cut to the shards by
antenna rows and, in SP mode, by spectra.  At a dump the channel blocks
are gathered and the SP partial accumulators summed, as the JAX runner's
dump extraction does, and ``on_output`` gets the outputs in their global
layout on the first shard's device (beam-parallel beams put back in beam
order).

Fault semantics as in the JAX runner: a dropped chunk is replaced by
zeros — stream timing advances, the FIR history stays continuous, and
the dump metadata records how many spectra actually integrated.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.pipeline import (gather_acc, gather_outputs,
                                               history_shape, make_step,
                                               mode_for, shard_inputs,
                                               zero_vis_acc)
from dc_sand_tpu_torch.ops.xcorr import extract_vis
from dc_sand_tpu_torch.parallel import FX_AXIS, build_mesh
from dc_sand_tpu_torch.runtime.delays import DelayModel

logger = logging.getLogger("dc_sand_tpu_torch.runner")

__all__ = ["FXRunner", "RunnerCounters", "Dump", "MAX_SPECTRA_PER_ACC"]

# int32 CMAC headroom: |V| <= 2 * 127**2 * n_spectra
MAX_SPECTRA_PER_ACC = (2 ** 31 - 1) // (2 * 127 * 127)


@dataclasses.dataclass
class RunnerCounters:
    chunks_in: int = 0
    chunks_dropped: int = 0
    samples_in: int = 0
    spectra_out: int = 0
    dumps: int = 0


@dataclasses.dataclass
class Dump:
    """One accumulator dump: visibilities + integration bookkeeping."""
    vis: np.ndarray            # (n_bl, P, P, K, 2) int32
    n_spectra: int             # spectra actually integrated (drops excluded)
    n_spectra_nominal: int     # window length in spectra
    first_chunk: int


class FXRunner:
    """Streaming runner on one device or a mesh, fengine, fx or beam mode
    (from ``cfg``).

    ``source(chunk_idx)`` returns the chunk's int8 samples, ``(A, P,
    chunk_samples)`` or the same bytes as frames ``(A*P, B, M)``: a numpy
    array, or a tensor (already on ``device`` or not).  ``gains``:
    ``(K, 2)`` float32 re/im (default ``cfg.quant_scale`` real).
    ``weights``: beam weights ``(n_beams, A, K, 2)`` float32 re/im
    (default zeros); :attr:`weights` is read at every chunk, so assigning
    it between chunks re-points the beams.  ``fused``: the F-engine path
    (:func:`dc_sand_tpu_torch.models.fengine.f_engine`); False is the
    counterpart of the JAX runner's ``impl="pallas"``.  Give ``device``
    for one device (a mesh of one shard) or ``mesh`` for a mesh (whose
    first shard's device is then :attr:`device`).
    """

    def __init__(self, cfg: ChainConfig, window: np.ndarray,
                 delay_model: Optional[DelayModel] = None,
                 gains: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None, *, device=None,
                 mesh=None, fused: bool = True):
        self.cfg = cfg
        self.mode = mode_for(cfg)
        if (device is None) == (mesh is None):
            raise ValueError("FXRunner takes a device or a mesh, one of them")
        if mesh is None:
            mesh = build_mesh([device])
        self.mesh = mesh
        self.device = mesh.flat_devices[0]
        self._devices = mesh.flat_devices
        self.delay_model = delay_model or DelayModel.zeros(
            cfg.n_ants, cfg.n_pols)
        self.max_delay = self.delay_model.max_delay
        if (self.mode == "fx"
                and cfg.n_spectra_per_acc > MAX_SPECTRA_PER_ACC):
            raise ValueError(
                f"n_spectra_per_acc={cfg.n_spectra_per_acc} overflows the "
                f"int32 visibility accumulator (max {MAX_SPECTRA_PER_ACC})")
        self._step = make_step(cfg, window, mesh=mesh, fused=fused)
        a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
        self.gains = (gains if gains is not None
                      else np.stack([np.full((k,), cfg.quant_scale,
                                             np.float32),
                                     np.zeros((k,), np.float32)], -1))
        self.weights = (weights if weights is not None
                        else np.zeros((max(cfg.n_beams, 1), a, k, 2),
                                      np.float32))
        self.history = [torch.zeros(history_shape(cfg, mesh),
                                    dtype=torch.int8, device=dev)
                        for dev in self._devices]
        self.vis_acc = [zero_vis_acc(cfg, dev, mesh) for dev in self._devices]
        # integer-sample (coarse) delay is a read-pointer offset applied in
        # the feed; the tail carries the previous chunk's last max_delay
        # samples (zeros at stream start)
        self._tail = (torch.zeros((a, p, self.max_delay),
                                       dtype=torch.int8, device=self.device)
                           if cfg.apply_delay and self.max_delay else None)
        self.counters = RunnerCounters()
        self.t0 = 0          # absolute sample index of next new sample
        self.chunk_idx = 0
        self._acc_spectra = 0       # spectra in current window (nominal)
        self._acc_integrated = 0    # spectra actually integrated
        self._acc_first_chunk = 0

    @property
    def gains(self) -> torch.Tensor:
        """Channel gains ``(K, 2)`` float32 re/im on the device."""
        return self._gains

    @gains.setter
    def gains(self, g) -> None:
        self._gains = torch.as_tensor(g, dtype=torch.float32,
                                      device=self.device).contiguous()
        per_dev = {dev: self._gains.to(dev) for dev in set(self._devices)}
        self._gains_sh = [per_dev[dev] for dev in self._devices]

    @property
    def weights(self) -> torch.Tensor:
        """Beam weights ``(n_beams, A, K, 2)`` float32 on the device."""
        return self._weights

    @weights.setter
    def weights(self, w) -> None:
        self._weights = torch.as_tensor(w, dtype=torch.float32,
                                        device=self.device).contiguous()
        # each fx shard's antennas
        a_l = self.cfg.n_ants // self.mesh.shape[FX_AXIS]
        self._weights_sh = []
        for d, dev in enumerate(self._devices):
            f = self.mesh.coords(d)[1]
            self._weights_sh.append(
                self._weights[:, f * a_l:(f + 1) * a_l].contiguous().to(dev))

    # ------------------------------------------------------------------
    def run(self, source: Callable[[int], np.ndarray], n_chunks: int,
            on_output: Optional[Callable[[int, dict], None]] = None,
            drop_chunks: Iterable[int] = ()):
        """Process ``n_chunks``; returns ``(dumps, counters)`` (dumps in
        fx mode only).

        ``on_output(chunk_idx, outputs)`` receives each chunk's outputs
        (fengine mode: ``"spectra"``; beam mode: ``"beams"`` and
        ``"incoherent"``) as tensors ON THE RUNNER'S DEVICE; the consumer
        copies what it needs.  The JAX
        runner hands over numpy arrays, but here that copy would set the
        pace: beam64 makes 268 MB of float32 beams per 256-spectra chunk,
        about 120 ms through pageable memory at the 2.2 GB/s measured for
        the fx dump on the H100, for 1.2 ms of stream.
        ``drop_chunks``: chunk indices to fault-inject as zeros.
        """
        cfg = self.cfg
        b = cfg.spectra_per_chunk
        drop = frozenset(drop_chunks)
        dumps = []
        for _ in range(n_chunks):
            i = self.chunk_idx
            chunk, frac, phase, dropped = self._feed_chunk(i, drop, source)
            reset = self._acc_spectra == 0
            if reset:
                self._acc_first_chunk = i
            outputs = self._step(self.history, self.vis_acc,
                                 *self._step_args(chunk, frac, phase), reset)
            if on_output is not None and outputs:
                on_output(i, gather_outputs(outputs, cfg, self.mesh,
                                            self.device))
            if self.mode != "fx":
                continue
            self._acc_spectra += b
            if not dropped:
                self._acc_integrated += b
            if self._acc_spectra >= cfg.n_spectra_per_acc:
                vis = extract_vis(self._acc_total(), cfg.n_ants, cfg.n_pols)
                dumps.append(Dump(vis=vis.contiguous().cpu().numpy(),
                                  n_spectra=self._acc_integrated,
                                  n_spectra_nominal=self._acc_spectra,
                                  first_chunk=self._acc_first_chunk))
                self.counters.dumps += 1
                self._acc_spectra = 0
                self._acc_integrated = 0
        return dumps, self.counters

    # ------------------------------------------------------------------
    def _feed_chunk(self, i: int, drop: frozenset, source):
        """Per-chunk feed: fault injection, the chunk's transfer to the
        device, delay-model evaluation, the coarse delay, the frame view,
        counter/clock bookkeeping."""
        cfg = self.cfg
        b = cfg.spectra_per_chunk
        a, p = cfg.n_ants, cfg.n_pols
        dropped = i in drop
        if dropped:
            chunk = torch.zeros((a, p, cfg.chunk_samples), dtype=torch.int8,
                                device=self.device)
            self.counters.chunks_dropped += 1
            logger.warning("chunk %d dropped (fault-injected)", i)
        else:
            chunk = source(i)
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        if chunk.dtype != torch.int8:
            raise ValueError(f"source chunks must be int8, got {chunk.dtype}")
        chunk = chunk.to(self.device)
        coarse, frac, phase = self.delay_model.evaluate_chunk(
            self.t0, b, cfg.fft_size)
        if self._tail is not None:
            chunk = self._coarse_shift(chunk, coarse)
        # (A, P, T) -> (A*P, B, M): a free row-major view, the layout the
        # F-engine kernel reads
        chunk = chunk.reshape(a * p, b, cfg.fft_size)
        self.counters.chunks_in += 1
        self.counters.samples_in += chunk.numel()
        self.counters.spectra_out += b
        self.t0 += cfg.chunk_samples
        self.chunk_idx += 1
        return (chunk.contiguous(), torch.from_numpy(frac.reshape(a * p, b)),
                torch.from_numpy(phase.reshape(a * p, b)), dropped)

    def _step_args(self, chunk, frac, phase) -> tuple:
        """The step's arguments after the carries: ``(chunk, frac, phase,
        gains, weights)`` from the frame chunk ``(A*P, B, M)`` and the
        per-spectrum ``(A*P, B)`` delays, as lists cut to the shards."""
        return shard_inputs(self.mesh, chunk, frac, phase) + (
            self._gains_sh, self._weights_sh)

    def _acc_total(self) -> torch.Tensor:
        """The packed ``(K, ap, ap)`` accumulator on the device."""
        return gather_acc(self.vis_acc, self.mesh, self.device)

    def _coarse_shift(self, chunk: torch.Tensor, coarse: np.ndarray):
        """Coarse delay: a read-pointer offset into ``[tail | chunk]``,
        coarse frozen at the chunk start (host-side delay values), one
        slice per stream on the runner's device."""
        cfg = self.cfg
        md = self.max_delay
        c = cfg.chunk_samples
        chunk = chunk.reshape(cfg.n_ants, cfg.n_pols, c)
        buf = torch.cat([self._tail, chunk], dim=-1)
        out = torch.empty_like(chunk)
        for idx in np.ndindex(cfg.n_ants, cfg.n_pols):
            off = md - int(coarse[idx])
            out[idx] = buf[idx][off:off + c]
        # .clone(): a view would pin the whole concat buffer between steps
        self._tail = buf[..., -md:].clone()
        return out
