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
one device is a mesh of one shard.  Two coarse modes, as in the JAX
runner:

* ``coarse_on_host=True`` (the default): the feed shifts the whole chunk
  on the first shard's device, one gather from ``[tail | chunk]`` (the
  tail the previous chunk's last ``max_delay`` samples), and the shifted
  chunk is then cut to the shards by antenna rows and, in SP mode, by
  spectra;
* ``coarse_on_host=False`` (with ``cfg.apply_delay``): the step gathers
  (:func:`~dc_sand_tpu_torch.models.pipeline.make_step`'s device coarse
  mode): the raw chunk and the chunk's coarse delays are cut to the
  shards, each shard gathers its own antennas from its carried lead-in
  history ``(A/n_fx, P, max_delay + (taps-1)*M)`` on its own device, and
  there is no tail.  SP mode refuses it when ``max_delay > 0``.

At a dump the channel blocks are gathered and the SP partial accumulators
summed, as the JAX runner's dump extraction does, and ``on_output`` gets
the outputs in their global layout on the first shard's device (beam-
parallel beams put back in beam order).

Fault semantics as in the JAX runner: a dropped chunk is replaced by
zeros — stream timing advances, the FIR history stays continuous, and
the dump metadata records how many spectra actually integrated.

:meth:`FXRunner.run_batched` replays recorded data a dump window at a
time, on one CUDA device as one CUDA graph a window; the state saves and
loads with :mod:`dc_sand_tpu_torch.runtime.checkpoint`.

On a mesh over several processes (:func:`~dc_sand_tpu_torch.parallel.
build_global_mesh`; the JAX runner's multi-process SPMD) every rank runs
one runner, holds its own shards' carries, and ``source(i)`` gives it its
own antennas only, rows :func:`~dc_sand_tpu_torch.parallel.distributed.
local_antenna_range`.  At a dump every rank gets the whole visibility set
(the peers' accumulators read through CUDA IPC within a node and from
mirrors filled over the staged route across nodes, or over gloo on the
CPU); ``on_output`` gets this rank's block of the outputs.  Ranks may sit
on several nodes (``torchrun --nnodes``): the node map of
:func:`~dc_sand_tpu_torch.parallel.init_distributed` picks each pair's
route, and nothing else changes.  The JAX
runner's refusals stand: SP needs the time axis within each process
(``build_mesh(..., time_local=True)``), and ``run_batched`` is
single-process.  Under several processes each rank gathers its own
antennas in either coarse mode; the device mode is the JAX runner's, and
the host mode, which the JAX runner refuses there, stays allowed: a rank
holds each of its antennas' whole stream, so its dumps are bitwise the
one-process run's.
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
                                               uses_frames_io, zero_vis_acc)
from dc_sand_tpu_torch.ops._dispatch import default_device
from dc_sand_tpu_torch.ops.coarse import carry_lead, coarse_gather
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dc_sand_tpu_torch.ops.pfb import pfb_fir
from dc_sand_tpu_torch.ops.xcorr import extract_vis, xcorr_accumulate_a2
from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                        build_mesh, local_antenna_range,
                                        uses_shared_buffers)
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
    for one device (a mesh of one shard; None is the current CUDA device,
    and raises without a card) or ``mesh`` for a mesh (whose first
    local shard's device is then :attr:`device`: a rank's chunk lands on
    its first card, and the cut to the shards copies each other card's
    antennas there, card to card).  ``coarse_on_host``: the
    coarse mode (module docstring); :attr:`coarse_on_host` is True when
    the feed shifts, as the JAX runner's attribute.
    """

    def __init__(self, cfg: ChainConfig, window: np.ndarray,
                 delay_model: Optional[DelayModel] = None,
                 gains: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None, *, device=None,
                 mesh=None, fused: bool = True,
                 coarse_on_host: bool = True):
        self.cfg = cfg
        self.mode = mode_for(cfg)
        if device is not None and mesh is not None:
            raise ValueError("FXRunner takes a device or a mesh, one of them")
        if mesh is None:
            mesh = build_mesh([default_device(device)])
        self.mesh = mesh
        self.device = mesh.local_devices[0]
        self._devices = mesh.local_devices
        self._mp = mesh.multiprocess
        self._rows = slice(0, cfg.n_ants)    # this rank's antennas
        if self._mp:
            self._rows = slice(*self._local_antennas(cfg, mesh))
        self.delay_model = delay_model or DelayModel.zeros(
            cfg.n_ants, cfg.n_pols)
        self.max_delay = self.delay_model.max_delay
        if (self.mode == "fx"
                and cfg.n_spectra_per_acc > MAX_SPECTRA_PER_ACC):
            raise ValueError(
                f"n_spectra_per_acc={cfg.n_spectra_per_acc} overflows the "
                f"int32 visibility accumulator (max {MAX_SPECTRA_PER_ACC})")
        self.coarse_on_host = coarse_on_host and cfg.apply_delay
        # device coarse mode: the lead-in history rides the device (SP
        # refuses a lead-in, as the JAX step does)
        self._lead = not uses_frames_io(cfg, coarse_on_host)
        dev_md = (self.max_delay if cfg.apply_delay and not coarse_on_host
                  else 0)
        self._step = make_step(cfg, window, mesh=mesh, fused=fused,
                               max_delay=dev_md,
                               coarse_on_host=coarse_on_host)
        a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
        self.gains = (gains if gains is not None
                      else np.stack([np.full((k,), cfg.quant_scale,
                                             np.float32),
                                     np.zeros((k,), np.float32)], -1))
        self.weights = (weights if weights is not None
                        else np.zeros((max(cfg.n_beams, 1), a, k, 2),
                                      np.float32))
        shape = history_shape(cfg, mesh, dev_md if self._lead else None)
        self.history = [torch.zeros(shape, dtype=torch.int8, device=dev)
                        for dev in self._devices]
        # the accumulators that the other ranks read at a dump
        self._acc_bufs = None
        if uses_shared_buffers(mesh) and self.mode == "fx":
            self._acc_bufs = SharedBuffers(
                mesh, zero_vis_acc(cfg, "cpu", mesh).shape, torch.int32)
            self.vis_acc = self._acc_bufs.local
        else:
            self.vis_acc = [zero_vis_acc(cfg, dev, mesh)
                            for dev in self._devices]
        # integer-sample (coarse) delay is a read-pointer offset applied in
        # the feed; the tail carries the previous chunk's last max_delay
        # samples of this rank's antennas (zeros at stream start)
        a_l = self._rows.stop - self._rows.start
        self._tail = (torch.zeros((a_l, p, self.max_delay),
                                  dtype=torch.int8, device=self.device)
                      if self.coarse_on_host and self.max_delay else None)
        self.counters = RunnerCounters()
        self.t0 = 0          # absolute sample index of next new sample
        self.chunk_idx = 0
        self._acc_spectra = 0       # spectra in current window (nominal)
        self._acc_integrated = 0    # spectra actually integrated
        self._acc_first_chunk = 0
        # run_batched's CUDA graph of a dump window (one CUDA device)
        self._graph = None
        self.graph_replays = 0      # windows replayed from the graph
        self.graph_launches = {}    # kernel launches captured a window

    @staticmethod
    def _local_antennas(cfg: ChainConfig, mesh) -> tuple:
        """``[a0, a1)`` of this rank on a multi-process mesh, with the JAX
        runner's refusal of a time axis that crosses processes; raises
        unless the rank's fx columns hold exactly
        :func:`local_antenna_range`'s antennas."""
        ts, fs = mesh.local_block()
        if len(ts) != mesh.shape[TIME_AXIS]:
            raise NotImplementedError(
                "multi-process SP streaming needs the time axis "
                "process-local (build_mesh(..., time_local=True)): one "
                "host ingests its antennas' contiguous stream; a time "
                "shard crossing hosts would split that stream across NICs "
                "and put the overlap-save halo on DCN")
        a0, a1 = local_antenna_range(cfg.n_ants)
        a_l = cfg.n_ants // mesh.shape[FX_AXIS]
        if (fs[0] * a_l, (fs[-1] + 1) * a_l) != (a0, a1):
            raise ValueError(
                f"rank {mesh.rank} holds fx columns {fs}, not those of its "
                f"antennas [{a0}, {a1}) (build the mesh with "
                "build_global_mesh)")
        return a0, a1

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
        for d, dev in zip(self.mesh.local_shards, self._devices):
            f = self.mesh.coords(d)[1]
            self._weights_sh.append(
                self._weights[:, f * a_l:(f + 1) * a_l].contiguous().to(dev))

    # ------------------------------------------------------------------
    def run(self, source: Callable[[int], np.ndarray], n_chunks: int,
            on_dump: Optional[Callable[[Dump], None]] = None,
            on_output: Optional[Callable[[int, dict], None]] = None,
            drop_chunks: Iterable[int] = ()):
        """Process ``n_chunks``; returns ``(dumps, counters)`` (dumps in
        fx mode only).

        ``on_dump(dump)`` is called at each dump (fx mode), as it is
        appended.  ``on_output(chunk_idx, outputs)`` receives each
        chunk's outputs (fengine mode: ``"spectra"``; beam mode:
        ``"beams"`` and ``"incoherent"``) as tensors ON THE RUNNER'S
        DEVICE; the consumer copies what it needs.  The JAX
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
            chunk, coarse, frac, phase, dropped = self._feed_chunk(
                i, drop, source)
            reset = self._acc_spectra == 0
            if reset:
                self._acc_first_chunk = i
            outputs = self._step(
                self.history, self.vis_acc,
                *self._step_args(chunk, torch.from_numpy(frac),
                                 torch.from_numpy(phase),
                                 torch.from_numpy(coarse)), reset)
            if on_output is not None and outputs:
                on_output(i, gather_outputs(outputs, cfg, self.mesh,
                                            self.device))
            if self.mode != "fx":
                continue
            self._acc_spectra += b
            if not dropped:
                self._acc_integrated += b
            if self._acc_spectra >= cfg.n_spectra_per_acc:
                dumps.append(self._dump(self._acc_integrated,
                                        self._acc_spectra,
                                        self._acc_first_chunk, on_dump))
                self._acc_spectra = 0
                self._acc_integrated = 0
        return dumps, self.counters

    def run_batched(self, source: Callable[[int], np.ndarray],
                    n_chunks: int,
                    on_dump: Optional[Callable[[Dump], None]] = None,
                    drop_chunks: Iterable[int] = ()):
        """Offline replay of recorded data (fx mode): one whole dump
        window of chunks a dispatch; returns ``(dumps, counters)``.

        The counterpart of the JAX runner's ``run_batched``, whose
        ``lax.scan`` runs a window's ``g = n_spectra_per_acc /
        spectra_per_chunk`` steps in one dispatch.  It gives what
        :meth:`run` gives, bitwise: the same feed (drops, delay model,
        coarse shift, counters), carry and dumps, with ``on_dump`` called
        at each, but no per-chunk ``on_output``.  ``n_chunks`` must be a
        multiple of ``g`` and the run must start at a dump boundary.

        On one CUDA device the window's ``g`` steps are captured once in
        one CUDA graph, and each window is then the feed (outside the
        graph, into static device buffers: the chunks ``(g, A*P, B, M)``
        int8, their delays ``(g, A*P, B)`` float32, in the device coarse
        mode the raw chunks and their coarse delays ``(g, A*P)`` int32,
        whose gather the graph holds, a copy of the gains), one replay,
        and the dump.  The graph holds the addresses of the
        carries ``history`` and ``vis_acc``: whatever replaces them
        rather than copying into them (``load_state`` copies) has it
        captured again.  Before the capture one step runs uncaptured on
        copies of the carries, so that the kernels are built, loaded and
        their tables cached.  A capture that fails raises.  Each wrapper
        counts its launches when called, so the capture counts the
        window's launches once (:attr:`graph_launches`) and the replays
        count in :attr:`graph_replays`.

        On a mesh and on the CPU it runs the step once a chunk, in a
        loop, with no graph.
        """
        cfg = self.cfg
        if self.mode != "fx":
            raise ValueError("run_batched is fx-mode only (other modes "
                             "emit per-chunk outputs; use run)")
        if self._mp:
            raise NotImplementedError(
                "run_batched is a single-process offline-replay path; "
                "multi-process streaming uses run()")
        b = cfg.spectra_per_chunk
        if cfg.n_spectra_per_acc % b:
            raise ValueError("n_spectra_per_acc must be a multiple of "
                             "spectra_per_chunk for the batched path")
        g = cfg.n_spectra_per_acc // b
        if n_chunks % g:
            raise ValueError(f"n_chunks must be dump-aligned "
                             f"(multiple of {g})")
        if self._acc_spectra:
            raise ValueError("run_batched must start at a dump boundary")
        graphed = self.device.type == "cuda" and self.mesh.size == 1
        if graphed and self._graph is None:
            self._graph = _WindowGraph(self, g)
        drop = frozenset(drop_chunks)
        dumps = []
        for _ in range(n_chunks // g):
            first_chunk = self.chunk_idx
            integrated = 0
            for k in range(g):
                out = self._graph.chunks[k] if graphed else None
                chunk, coarse, frac, phase, dropped = self._feed_chunk(
                    self.chunk_idx, drop, source, out=out)
                if not dropped:
                    integrated += b
                if graphed:
                    self._graph.frac_host[k] = frac
                    self._graph.phase_host[k] = phase
                    self._graph.coarse_host[k] = coarse
                else:
                    self._step(self.history, self.vis_acc,
                               *self._step_args(chunk,
                                                torch.from_numpy(frac),
                                                torch.from_numpy(phase),
                                                torch.from_numpy(coarse)),
                               k == 0)
            if graphed:
                self._graph.replay(self)
            dumps.append(self._dump(integrated, g * b, first_chunk,
                                    on_dump))
        return dumps, self.counters

    def _dump(self, n_spectra: int, nominal: int, first_chunk: int,
              on_dump) -> Dump:
        """The window's dump from the accumulator, counted and handed to
        ``on_dump``."""
        cfg = self.cfg
        vis = extract_vis(self._acc_total(), cfg.n_ants, cfg.n_pols)
        vis = vis.contiguous()
        if vis.is_cuda:
            # through a fresh pinned buffer (the caching host allocator
            # recycles it once the dump is dropped): a DMA at the link's
            # rate, where a pageable copy is staged by the host.  Never
            # one buffer across dumps, or a kept dump would change.
            host = torch.empty(vis.shape, dtype=vis.dtype, pin_memory=True)
            host.copy_(vis, non_blocking=True)
            torch.cuda.current_stream(vis.device).synchronize()
            vis = host
        d = Dump(vis=vis.cpu().numpy(), n_spectra=n_spectra,
                 n_spectra_nominal=nominal, first_chunk=first_chunk)
        self.counters.dumps += 1
        if on_dump is not None:
            on_dump(d)
        return d

    # ------------------------------------------------------------------
    def _feed_chunk(self, i: int, drop: frozenset, source, out=None):
        """Per-chunk feed: fault injection, the chunk's transfer to the
        device, delay-model evaluation, the host mode's coarse delay, the
        frame view, counter/clock bookkeeping.  Returns ``(chunk, coarse,
        frac, phase, dropped)``: the chunk in frame form ``(A*P, B, M)``
        on the device (written into ``out``, a tensor of that shape, when
        given; in the device coarse mode unshifted), the coarse delays
        ``(A*P,)`` int32 and the per-spectrum delays ``(A*P, B)`` float32,
        numpy."""
        cfg = self.cfg
        b = cfg.spectra_per_chunk
        rows = self._rows
        a, p = rows.stop - rows.start, cfg.n_pols
        shape = (a * p, b, cfg.fft_size)
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
        coarse, frac, phase = (v[rows] for v in self.delay_model.
                               evaluate_chunk(self.t0, b, cfg.fft_size))
        if self._tail is not None:
            chunk = self._coarse_shift(chunk.to(self.device), coarse, out)
        elif out is not None:
            chunk = out.copy_(chunk.reshape(shape))
        # (A, P, T) -> (A*P, B, M): a free row-major view, the layout the
        # F-engine kernel reads
        chunk = chunk.to(self.device).reshape(shape)
        self.counters.chunks_in += 1
        self.counters.samples_in += chunk.numel()
        self.counters.spectra_out += b
        self.t0 += cfg.chunk_samples
        self.chunk_idx += 1
        return (chunk.contiguous(),
                np.ascontiguousarray(coarse, np.int32).reshape(a * p),
                np.ascontiguousarray(frac).reshape(a * p, b),
                np.ascontiguousarray(phase).reshape(a * p, b), dropped)

    def _step_args(self, chunk, frac, phase, coarse=None) -> tuple:
        """The step's arguments after the carries: ``(chunk, frac, phase,
        gains, weights)`` from the frame chunk ``(A*P, B, M)`` and the
        per-spectrum ``(A*P, B)`` delays, as lists cut to the shards; in
        the device coarse mode ``(chunk, coarse, frac, ...)``, with the
        ``(A*P,)`` coarse delays as int32."""
        chunks, fracs, phases = shard_inputs(self.mesh, chunk, frac, phase)
        lead = ()
        if self._lead:
            lead = shard_inputs(self.mesh, torch.as_tensor(
                coarse, dtype=torch.int32).reshape(-1))
        return (chunks, *lead, fracs, phases, self._gains_sh,
                self._weights_sh)

    def _acc_total(self) -> torch.Tensor:
        """The packed ``(K, ap, ap)`` accumulator on the device (the whole
        plane, on every rank of a multi-process mesh)."""
        return gather_acc(self.vis_acc, self.mesh, self.device,
                          self._acc_bufs)

    def _coarse_shift(self, chunk: torch.Tensor, coarse: np.ndarray,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Coarse delay: a read-pointer offset into ``[tail | chunk]``,
        coarse frozen at the chunk start (host-side delay values), one
        gather on the runner's device (one kernel launch on a card), into
        ``out`` when given (any shape of the chunk's bytes); then the tail
        becomes the chunk's last ``max_delay`` samples."""
        rows = chunk.reshape(self._tail.shape[0] * self.cfg.n_pols, -1)
        out = torch.empty_like(rows) if out is None else out
        co = torch.as_tensor(np.ascontiguousarray(coarse, np.int32)
                             .reshape(-1)).to(self.device)
        coarse_gather(self._tail, rows, co, self.max_delay, out=out)
        carry_lead(self._tail, rows)
        return out


def _launch_counts() -> dict:
    """The launch counters of the kernels a one-device fx step runs."""
    return {"fengine": fengine_fused.launches, "pfb": pfb_fir.launches,
            "cmac": xcorr_accumulate_a2.launches,
            "coarse": coarse_gather.launches}


class _WindowGraph:
    """One dump window of a one-device fx runner's steps as a CUDA graph,
    with the static buffers it reads (:meth:`FXRunner.run_batched`): the
    window's chunks in frame form, their delays (filled on the host,
    copied up once a window; in the device coarse mode their coarse
    delays too) and the gains."""

    def __init__(self, runner: FXRunner, g: int):
        cfg, dev = runner.cfg, runner.device
        s, b = cfg.n_ants * cfg.n_pols, cfg.spectra_per_chunk
        self.chunks = torch.empty((g, s, b, cfg.fft_size), dtype=torch.int8,
                                  device=dev)
        self.frac_host = np.zeros((g, s, b), np.float32)
        self.phase_host = np.zeros((g, s, b), np.float32)
        self.frac = torch.zeros((g, s, b), device=dev)
        self.phase = torch.zeros((g, s, b), device=dev)
        self.coarse_host = np.zeros((g, s), np.int32)
        self.coarse = torch.zeros((g, s), dtype=torch.int32, device=dev)
        self.gains = torch.empty_like(runner.gains)
        self.graph = None
        self._carry_ptrs = None

    def _steps(self, runner: FXRunner, history, acc, n: int) -> None:
        """The window's first ``n`` steps on the static buffers, the first
        one resetting the accumulator."""
        for k in range(n):
            lead = ([self.coarse[k]],) if runner._lead else ()
            runner._step([history], [acc], [self.chunks[k]], *lead,
                         [self.frac[k]], [self.phase[k]], [self.gains],
                         runner._weights_sh, k == 0)

    def _capture(self, runner: FXRunner) -> None:
        history, acc = runner.history[0], runner.vis_acc[0]
        dev = runner.device
        # warm-up: one uncaptured step on copies of the carries builds and
        # loads the kernels and caches their tables
        self._steps(runner, history.clone(), acc.clone(), 1)
        torch.cuda.synchronize(dev)
        before = _launch_counts()
        self.graph = None       # an old graph's memory goes first
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            self._steps(runner, history, acc, len(self.chunks))
        runner.graph_launches = {k: v - before[k]
                                 for k, v in _launch_counts().items()}
        self.graph = graph
        self._carry_ptrs = (history.data_ptr(), acc.data_ptr())

    def replay(self, runner: FXRunner) -> None:
        """Copy the window's delays and the gains up, capture if the
        graph is missing or the carries moved, and replay."""
        self.frac.copy_(torch.from_numpy(self.frac_host))
        self.phase.copy_(torch.from_numpy(self.phase_host))
        self.coarse.copy_(torch.from_numpy(self.coarse_host))
        self.gains.copy_(runner.gains)
        ptrs = (runner.history[0].data_ptr(), runner.vis_acc[0].data_ptr())
        if self.graph is None or ptrs != self._carry_ptrs:
            self._capture(runner)
        self.graph.replay()
        runner.graph_replays += 1
