"""What every cell's run shares: the program built from a configuration
file, the closed loop that drives ``FXRunner.run`` through the window,
the seeded sample of answers it keeps, and their comparison with the
reference once the program is gone."""

from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import time

import numpy as np
import torch

from benchmark import compare, reference
from benchmark.inputs import delay_margin_s, rng


def process_start() -> float:
    """The epoch second at which this process started (``/proc``), to the
    kernel's clock tick; the current time where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def chain_config(name: str, spec: dict):
    """The port's ``ChainConfig`` from a configuration file's fields (its
    other keys, such as ``source`` or ``max_delay``, are the harness's)."""
    from dc_sand_tpu_torch.config import ChainConfig
    fields = {f.name for f in dataclasses.fields(ChainConfig)} - {"name"}
    return ChainConfig(name=name, **{k: v for k, v in spec.items()
                                     if k in fields})


def build_runner(cfg, inputs, traffic: dict, **where):
    """The port's runner on the run's inputs; ``where``: ``device=`` or
    ``mesh=``."""
    from dc_sand_tpu_torch.runtime.delays import DelayModel
    from dc_sand_tpu_torch.runtime.runner import FXRunner
    d = inputs.delays
    dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, d.max_delay)
    dm.d0, dm.d1, dm.p0, dm.p1 = (x.copy() for x in (d.d0, d.d1, d.p0, d.p1))
    return FXRunner(cfg, inputs.window, delay_model=dm, gains=inputs.gains,
                    weights=inputs.weights,
                    coarse_on_host=traffic["coarse_on_host"], **where)


def chunks_per_call(cfg, ring: list) -> int:
    """The chunks of one ``runner.run`` call: a dump window in fx mode,
    the ring otherwise."""
    if cfg.run_xengine and not cfg.n_beams:
        return cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    return len(ring)


def within_delay_budget(cfg, traffic: dict, max_delay: int,
                        chunks: int) -> float:
    """The stream seconds that ``chunks`` chunks cover; raises where that
    passes the traffic's delay margin (:func:`inputs.delay_margin_s`),
    after which a coarse delay would leave the budget and be clamped."""
    stream_s = chunks * cfg.chunk_samples / cfg.sample_rate_hz
    margin = delay_margin_s(traffic, max_delay, cfg.sample_rate_hz)
    if stream_s > margin:
        raise RuntimeError(
            f"the run covers {stream_s:.1f} s of stream; the delays stay "
            f"inside the {max_delay}-sample budget for {margin:.1f} s")
    return stream_s


def warm_up(runner, ring: list, calls: int) -> None:
    """``calls`` calls of the window's shape before it: every kernel of
    the cell built or loaded, and the answers of all but the last call
    held while the next ones run, so that the pinned dump buffers and the
    card's output blocks that the window's kept sample holds at once are
    in the allocators' caches before the clock starts."""
    held = []
    for _ in range(calls):
        dumps, _ = runner.run(lambda i: ring[i % len(ring)],
                              chunks_per_call(runner.cfg, ring),
                              on_output=lambda i, o: held.append(o))
        held += dumps
    del held


class Sample:
    """A seeded sample of ``k`` answers of the window, each ``(chunk
    index, answer)``: a reservoir sample over every answer, so that each
    is kept with the same chance, ``k`` over their number."""

    def __init__(self, seed: int, k: int):
        self.rng = rng(seed, 2)
        self.k = k
        self.seen = 0
        self.kept = []

    def offer(self, index: int, make):
        """Offer answer ``index``; ``make()`` gives what is kept of it
        (called only when it is kept)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, make()))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = (index, make())

    def answers(self) -> list:
        return sorted(self.kept, key=lambda x: x[0])


class Window:
    """The closed loop: ``runner.run`` called on ``per_call`` chunks of
    the ring at a time, straight through the window, until the host's
    clock passes ``seconds`` (``stop(elapsed) -> bool`` decides where the
    ranks must agree), then a synchronise.  A CUDA event is recorded on
    the runner's stream when each chunk is handed over, and one at the
    end, so that the completions' intervals are read after the window."""

    def __init__(self, runner, ring: list, sample: Sample):
        self.runner = runner
        self.ring = ring
        self.sample = sample
        self.cuda = runner.device.type == "cuda"
        self.stamps = []

    def source(self, i: int):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        return self.ring[i % len(self.ring)]

    def on_dump(self, dump) -> None:
        self.sample.offer(dump.first_chunk, lambda: dump)

    def on_output(self, i: int, outputs: dict) -> None:
        # the step allocates its outputs afresh each chunk: a reference
        # keeps them as they were made
        self.sample.offer(i, lambda: dict(outputs))

    def run(self, seconds: float, per_call: int, stop=None) -> dict:
        """Drive the window; returns its chunks, dumps and seconds."""
        runner = self.runner
        fx = runner.mode == "fx"
        stop = stop or (lambda elapsed: elapsed >= seconds)
        sync = (lambda: torch.cuda.synchronize(runner.device)) \
            if self.cuda else (lambda: None)
        sync()
        dumps0 = runner.counters.dumps
        first = runner.chunk_idx
        t0 = time.perf_counter()
        start_epoch = time.time()
        while True:
            runner.run(self.source, per_call,
                       on_dump=self.on_dump if fx else None,
                       on_output=None if fx else self.on_output)
            if stop(time.perf_counter() - t0):
                break
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.stamps.append(end)
        sync()
        t1 = time.perf_counter()
        return {"chunks": runner.chunk_idx - first,
                "dumps": runner.counters.dumps - dumps0,
                "seconds": t1 - t0, "start_epoch": start_epoch}

    def intervals_ms(self) -> list:
        """The intervals between consecutive chunk completions on the
        device, ms (one a chunk of the window)."""
        return [a.elapsed_time(b) for a, b in zip(self.stamps,
                                                  self.stamps[1:])]


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive)."""
    return statistics.quantiles(values, n=20)[18]


def free_program() -> None:
    """Give the card the memory of the program's state back, once the
    caller has dropped its last reference to the runner."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(cfg, inputs, answers: list, precision: str = "float64") -> list:
    """The numbers compared of each kept answer ``(chunk index, answer)``:
    ``{"vis_err"}`` for a dump, ``{"beam_err", "incoherent_err"}`` for a
    beam chunk, against the float64 reference (its beams quantised as the
    configuration's ``beam_quant_scale`` says).  An answer None stands for
    the chain computed at ``precision`` in the program's place (the
    control)."""
    fx = cfg.run_xengine and not cfg.n_beams
    g = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    out = []
    for index, got in answers:
        if fx:
            chunks = range(index, index + g)
            ref = _dump_vis(cfg, inputs, chunks, "float64")
            got = (_dump_vis(cfg, inputs, chunks, precision) if got is None
                   else torch.from_numpy(np.asarray(got.vis)))
            out.append({"vis_err": compare.vis_error(got, ref)})
            continue
        re, im = reference.chunk_spectra(inputs, index, cfg)
        ref_b, ref_i = reference.beams(re, im, inputs.weights, cfg.n_ants)
        ref_b = reference.quantise_beams(ref_b, cfg.beam_quant_scale)
        if got is None:
            re, im = reference.chunk_spectra(inputs, index, cfg, precision)
            got_b, got_i = reference.beams(re, im, inputs.weights,
                                           cfg.n_ants, precision)
            got_b = reference.quantise_beams(got_b, cfg.beam_quant_scale)
        else:
            got_b, got_i = got["beams"], got["incoherent"]
        out.append({"beam_err": compare.beam_error(got_b, ref_b),
                    "incoherent_err": compare.incoherent_error(got_i,
                                                               ref_i)})
    return out


def worst(readings: list) -> dict:
    """Each number's largest reading over the answers."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def _dump_vis(cfg, inputs, chunks, precision) -> torch.Tensor:
    """A dump's visibilities, every chunk's integrated exactly and added
    (int64), so that only one chunk's spectra are held at a time."""
    total = None
    for i in chunks:
        re, im = reference.chunk_spectra(inputs, i, cfg, precision)
        v = reference.visibilities(re, im, cfg.n_ants, cfg.n_pols)
        del re, im
        total = v if total is None else total.add_(v)
    return total


__all__ = ["process_start", "chain_config", "build_runner",
           "chunks_per_call", "within_delay_budget", "warm_up",
           "Sample", "Window", "p95", "free_program", "check", "worst"]
