"""Stage and pipeline benchmarks on one card: the F-engine, the fx step and
the beam step.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.pipelines`.  The headline
metric is channelized samples/s: real input samples the F-engine
consumes per second.  Every record carries ``vs_array_realtime``, the rate
over :data:`ARRAY_REALTIME`, the whole array's 128 streams x 1.712
Gsamp/s: the share of the array that the card keeps up with.

Not ported, each for its reason:

* ``fengine_cost_model``: its unit rates are the v5e's VPU and MXU rates;
  the bound here is the harness's H100 count
  (:func:`~dc_sand_tpu_torch.bench.harness.bound_ms`);
* ``REALTIME_FLOOR_PER_CHIP``: a v5e-16's per-chip share; the records
  carry ``vs_array_realtime`` instead;
* ``stage2`` and ``layout``: TPU knobs that stay in the reference.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from dc_sand_tpu_torch.bench.harness import (BenchResult, fengine_flops,
                                             time_cuda)
from dc_sand_tpu_torch.config import get_config
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.models.pipeline import (chunk_shape, history_shape,
                                               make_step, zero_vis_acc)
from dc_sand_tpu_torch.ops._dispatch import default_device
from dc_sand_tpu_torch.bench.fixtures import noise_int8
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["bench_fengine", "bench_fx_step", "bench_beam_step",
           "bench_runner_modes", "ARRAY_REALTIME"]

# the whole array in real time: 64 antennas x 2 pols at 1712 Msps, real
# samples per second
ARRAY_REALTIME = 128 * 1712e6


def _gains(n_chans: int, dev) -> torch.Tensor:
    return torch.tensor([[0.05, 0.0]], device=dev).expand(n_chans,
                                                          2).contiguous()


def bench_fengine(n_streams: int = 16, n_spectra: int = 512,
                  n_chans: int = 1024, taps: int = 16, impl: str = "fused",
                  full_chain: bool = True, iters: int = 256,
                  device=None) -> BenchResult:
    """F-engine throughput on one card, one stream of ``n_spectra +
    taps - 1`` frames each.

    ``full_chain=True`` adds the fine delay and fringe and the int8
    requant (int8 output); False is the bare PFB with float32 output (K1's
    float variant).  ``impl="fused"`` runs K1; ``"unfused"`` (the JAX
    package's ``impl="pallas"``) the standalone FIR kernel K6, then
    ``torch.fft.rfft``, the phasor and the requant as PyTorch ops."""
    if impl not in ("fused", "unfused"):
        raise ValueError(f"unknown impl {impl!r}; choose fused or unfused")
    dev = default_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = 2 * n_chans
    x = noise_int8(gen, (n_streams, (n_spectra + taps - 1) * m), dev)
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32, device=dev)
    kw = {}
    if full_chain:
        rng = np.random.default_rng(0)
        kw = dict(frac_delay=torch.as_tensor(
                      rng.uniform(-0.5, 0.5, (n_streams, n_spectra)),
                      dtype=torch.float32, device=dev),
                  phase=torch.zeros((n_streams, n_spectra), device=dev),
                  gains=_gains(n_chans, dev))
    wall = time_cuda(lambda: f_engine(x, w, taps, n_chans,
                                      fused=impl == "fused", **kw),
                     warmup=2, iters=iters, device=dev)
    samples = n_streams * n_spectra * m     # new samples consumed per call
    rate = samples / wall
    # int8 in (each byte read once) + the output: int8 x 2 quantised,
    # float32 x 2 unquantised
    out_bytes = n_streams * n_spectra * n_chans * (2 if full_chain else 8)
    return BenchResult(
        name=f"fengine_{'full' if full_chain else 'pfb'}_{impl}",
        metric="channelized samples/s/chip", value=rate, unit="samp/s",
        wall_s=wall, bytes_moved=samples + out_bytes,
        extra={"n_streams": n_streams, "n_spectra": n_spectra,
               "n_chans": n_chans, "taps": taps, "impl": impl,
               "vs_array_realtime": rate / ARRAY_REALTIME},
    ).finish(dev, fp32_ops=fengine_flops(n_streams * n_spectra, m, taps,
                                         rotate=full_chain,
                                         quant=full_chain))


def _step_setup(preset: str, taps: int, weights, dev, **overrides):
    """The config, its one-device step and device-resident inputs made
    from a seeded generator: ``(cfg, step, args)`` with ``args`` the
    step's arguments ``(history, acc, chunk, frac, phase, gains, weights,
    reset)``; history and acc are updated in place by every call, as the
    runner's carries are."""
    cfg = get_config(preset).replace(n_taps=taps, **overrides)
    step = make_step(cfg, pfb_window(taps, cfg.fft_size), device=dev)
    s, b = cfg.n_ants * cfg.n_pols, cfg.spectra_per_chunk
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = (torch.zeros(history_shape(cfg), dtype=torch.int8, device=dev),
            zero_vis_acc(cfg, dev),
            noise_int8(gen, chunk_shape(cfg), dev),
            torch.zeros((s, b), device=dev), torch.zeros((s, b), device=dev),
            _gains(cfg.n_chans, dev), weights, False)
    return cfg, step, args


def bench_fx_step(n_ants: int = 64, n_pols: int = 2, n_chans: int = 1024,
                  n_spectra: int = None, taps: int = 16, iters: int = 64,
                  device=None) -> BenchResult:
    """The one-card fx streaming step (F-engine K1 writing the CMAC
    operand, the CMAC into the carried accumulator), ``make_step`` on
    device-resident inputs; ``n_spectra`` defaults to fx64's own chunk."""
    dev = default_device(device)
    if n_spectra is None:
        n_spectra = get_config("fx64").spectra_per_chunk
    a, p, k, b = n_ants, n_pols, n_chans, n_spectra
    cfg, step, args = _step_setup(
        "fx64", taps, torch.zeros((1, a, k, 2), device=dev), dev,
        n_ants=a, n_pols=p, n_chans=k, spectra_per_chunk=b)
    wall = time_cuda(lambda: step(*args), warmup=2, iters=iters, device=dev)
    samples = a * p * cfg.chunk_samples
    ap = a * p
    return BenchResult(
        name="fx_step_64ant",
        metric="FX-step samples/s/chip", value=samples / wall,
        unit="samp/s", wall_s=wall,
        # int8 stream in + the packed (k, ap, ap) int32 accumulator in/out
        bytes_moved=samples + 2 * k * ap ** 2 * 4,
        extra={"n_ants": a, "n_chans": k, "n_spectra": b,
               "vs_array_realtime": samples / wall / ARRAY_REALTIME},
    ).finish(dev, fp32_ops=fengine_flops(ap * b, cfg.fft_size, taps,
                                         rotate=True, quant=True),
             int8_ops=8 * k * ap * ap * b)


def bench_runner_modes(n_ants: int = 16, n_pols: int = 2,
                       n_chans: int = 1024, spectra: int = 64,
                       n_chunks: int = 16, rounds: int = 5,
                       device=None) -> list:
    """Streaming ``run`` against offline ``run_batched`` on the same runner
    config (fx64's with the shapes given, 4 chunks a dump window): the
    launch and host overhead a window's CUDA graph takes away.  Each mode
    has its runner, warmed up on one window's worth of chunks (the graph
    is captured there); then the two run ``n_chunks`` more each in turns,
    ``rounds`` times (the first of a round alternating), host clock
    around synchronised work, numpy chunks fed from the host; every chunk
    of a run differs.  Returns the two records, ``runner_batched`` first;
    ``wall_s`` is the median time a chunk over the rounds (every round's
    in ``extra["ms_per_chunk"]``), ``chunks_per_dispatch`` the chunks a
    replay (1 for ``run``).  The bound counts one chunk's int8 samples
    in, the F-engine's fp32 operations and the CMAC's int8 ones."""
    dev = default_device(device)
    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=4 * spectra)
    g = cfg.n_spectra_per_acc // spectra
    rng = np.random.default_rng(0)
    n_cache = 4 * g
    chunks = [rng.integers(-100, 100, (n_ants, n_pols, cfg.chunk_samples),
                           dtype=np.int8) for _ in range(n_cache)]
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    ap = n_ants * n_pols
    samples = ap * cfg.chunk_samples            # a chunk's
    runners = {mode: FXRunner(cfg, window, device=dev)
               for mode in ("batched", "streaming")}
    fns = {"batched": runners["batched"].run_batched,
           "streaming": runners["streaming"].run}
    ms = {mode: [] for mode in fns}
    for fn in fns.values():
        fn(lambda i: chunks[i % n_cache], n_cache)      # warm-up, capture
    for rnd in range(rounds):
        for mode in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fns[mode](lambda i: chunks[(i + 1) % n_cache], n_chunks)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms[mode].append((time.perf_counter() - t0) / n_chunks * 1e3)
    results = []
    for mode, times in ms.items():
        wall = statistics.median(times) / 1e3
        results.append(BenchResult(
            name=f"runner_{mode}",
            metric="runner samples/s", value=samples / wall,
            unit="samp/s", wall_s=wall, bytes_moved=samples,
            extra={"n_ants": n_ants, "n_chans": n_chans,
                   "spectra": spectra, "n_chunks": n_chunks,
                   "chunks_per_dispatch": g if mode == "batched" else 1,
                   "graph_replays": runners[mode].graph_replays,
                   "ms_per_chunk": times},
        ).finish(dev, fp32_ops=fengine_flops(ap * spectra, cfg.fft_size,
                                             cfg.n_taps, rotate=True,
                                             quant=True),
                 int8_ops=8 * n_chans * ap * ap * spectra))
    return results


def bench_beam_step(n_ants: int = 64, n_pols: int = 2,
                    n_chans: int = 4096, n_spectra: int = 256,
                    n_beams: int = 16, taps: int = 16, iters: int = 64,
                    device=None) -> BenchResult:
    """The one-card beam streaming step (F-engine K1, then the beam kernel:
    coherent beams and the incoherent beam), ``make_step`` on
    device-resident inputs and seeded weights."""
    dev = default_device(device)
    a, p, k, b = n_ants, n_pols, n_chans, n_spectra
    rng = np.random.default_rng(3)
    weights = torch.as_tensor(
        rng.normal(size=(n_beams, a, k, 2)).astype(np.float32) * 0.1,
        device=dev)
    cfg, step, args = _step_setup(
        "beam64", taps, weights, dev, n_ants=a, n_pols=p, n_chans=k,
        n_beams=n_beams, spectra_per_chunk=b)
    wall = time_cuda(lambda: step(*args), warmup=2, iters=iters, device=dev)
    samples = a * p * cfg.chunk_samples
    return BenchResult(
        name="beam_step_64ant",
        metric="B-engine-step samples/s/chip", value=samples / wall,
        unit="samp/s", wall_s=wall,
        bytes_moved=samples + (n_beams + 1) * p * b * k * 8,
        extra={"n_ants": a, "n_chans": k, "n_spectra": b,
               "n_beams": n_beams,
               "vs_array_realtime": samples / wall / ARRAY_REALTIME},
    ).finish(dev, fp32_ops=fengine_flops(a * p * b, cfg.fft_size, taps,
                                         rotate=True, quant=True)
             + 4 * a * p * b * k,            # the incoherent sum
             bf16_ops=8 * n_beams * p * b * k * a)
