"""Where the time of the fx64 and beam64 production steps goes, on one
CUDA card.

Run from the repository root::

    python -m dc_sand_tpu_torch.profile_step [--out DIR] [--runs NAMES]

For each run of ``--runs`` (default ``fx64,beam64,fx64_unfused``: fx64,
beam64 and fx64 through the unfused F-engine, the standalone FIR kernel
then PyTorch ops; ``fx64_mesh4`` is fx64 sharded over a 4-way fx mesh,
shard i on ``cuda:(i mod the card count)``, so that the corner-turn's
share of a sharded step shows; ``fx64_batched`` drives the windows with
``run_batched``, one CUDA-graph replay a window; ``fx64_devcoarse`` and
``beam64_devcoarse`` run the device coarse mode, ``coarse_on_host=False``:
the step's one gather a chunk in place of the feed's shift;
``fx64_ingest`` feeds fx64 through the ingest, see
:func:`_profile_ingest`) it builds the
production runner (:func:`production_runner`: 64 ants x 2 pols, 4096 channels, the
config's own chunk length, coarse and fractional delay and fringe on,
seeded int8 noise made on the card; fx64 dumps 8192 spectra per 4
2048-spectra chunks, beam64 forms 16 steered beams and the incoherent
beam per 256-spectra chunk over :data:`BEAM_CHUNKS` chunks), warms it
over one window of chunks, then prints:

1. a ``torch.profiler`` trace of one window with device-resident chunks
   (beam outputs stay on the card): device time per kernel or copy name,
   and the device's idle share, ``1 - busy / wall``.  ``busy`` is the
   union of the device intervals in the trace (kernels, copies,
   memsets), so nested host-side ops are not counted twice;
2. fx64 only: the dump alone (``extract_vis`` and the device-to-host
   copy), host clock, three times;
3. ``run()`` (or ``run_batched``) fed with numpy chunks, so the
   pageable host-to-device copy of each chunk (2.15 GB for fx64, 268 MB
   for beam64) is paid, and that copy of one chunk alone.

The traces are written to ``DIR/<run>_trace.json`` (default
``build/profile_step``).  :func:`chrome_trace` is the profiler context the
bench entry's ``--profile DIR`` uses too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from dc_sand_tpu_torch.config import ChainConfig, get_config
from dc_sand_tpu_torch.models.steering import steering_weights
from dc_sand_tpu_torch.ops.xcorr import extract_vis
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["noise_int8", "production_runner", "production_delay_model",
           "device_busy_us", "overlap_us", "chrome_trace", "main",
           "BEAM_CHUNKS"]

# beam mode has no dump cadence: its window is a fixed count of chunks
BEAM_CHUNKS = 8

# trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def noise_int8(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Gaussian int8 noise (sigma 20) made with ``gen`` on ``device``, in
    slabs of the first axis (a float32 copy of a whole fx64 chunk is
    8.6 GB)."""
    out = torch.empty(shape, dtype=torch.int8, device=device)
    for i in range(0, shape[0], 16):
        blk = torch.randn((min(16, shape[0] - i),) + tuple(shape[1:]),
                          generator=gen, device=device)
        out[i:i + 16] = torch.clamp(torch.round(blk * 20.0),
                                    -127, 127).to(torch.int8)
    return out


def production_delay_model(cfg: ChainConfig,
                           rng: np.random.Generator) -> DelayModel:
    """The production runner's delay model, drawn from ``rng``: coarse
    delays up to 31 samples (``max_delay`` 32), a delay rate, fringe
    phases and rates."""
    a, p = cfg.n_ants, cfg.n_pols
    dm = DelayModel.zeros(a, p, max_delay=32)
    dm.d0 = rng.uniform(0.0, 31.0, (a, p))
    dm.d1 = rng.uniform(-1e-9, 1e-9, (a, p))
    dm.p0 = rng.uniform(-np.pi, np.pi, (a, p))
    dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    return dm


def production_runner(cfg: ChainConfig, gen: torch.Generator, device,
                      fused: bool = True, mesh=None,
                      coarse_on_host: bool = True):
    """The runner at ``cfg``'s own cadence with a seeded delay model
    (coarse up to 31 samples, fractional delay and fringe on) and one
    window of chunks made with ``gen`` on ``device``: one dump's worth in
    fx mode, :data:`BEAM_CHUNKS` in beam mode, whose beams are steered
    toward seeded pointings (geometric delays up to 0.25 us):
    ``(runner, chunks)``.  ``fused`` picks the runner's F-engine path;
    with ``mesh`` (whose first shard's device must be ``device``) the
    runner is sharded over it; ``coarse_on_host`` picks the coarse mode."""
    rng = np.random.default_rng(6)
    a, p = cfg.n_ants, cfg.n_pols
    dm = production_delay_model(cfg, rng)
    weights = None
    if cfg.n_beams:
        n_chunks = BEAM_CHUNKS
        weights = steering_weights(
            rng.uniform(-2.5e-7, 2.5e-7, (cfg.n_beams, a)), cfg.n_chans,
            cfg.sample_rate_hz)
    else:
        n_chunks = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    chunks = [noise_int8(gen, (a, p, cfg.chunk_samples), device)
              for _ in range(n_chunks)]
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                      delay_model=dm, weights=weights,
                      device=None if mesh is not None else device,
                      mesh=mesh, fused=fused, coarse_on_host=coarse_on_host)
    return runner, chunks


def device_busy_us(events) -> float:
    """Length of the union of the device intervals among chrome-trace
    ``events`` (``ts``/``dur`` in us, categories :data:`DEVICE_CATS`)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _spans(events, pred) -> list:
    """The union of the intervals ``(ts, ts + dur)`` of the device events
    whose name satisfies ``pred``, as sorted disjoint intervals."""
    merged = []
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") in DEVICE_CATS and "dur" in e
                         and pred(e["name"])):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two unions of intervals
    (:func:`_spans`)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@contextlib.contextmanager
def chrome_trace(path, cuda: bool = True):
    """``torch.profiler`` over the block (CPU activity, and the card's with
    ``cuda``); its Chrome trace is written to ``path`` (directories made)
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    path = Path(path)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield prof
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def _trace(name: str, what: str, n: int, fn, out: Path) -> list:
    """``fn`` (``n`` chunks) under the profiler: prints the wall, the
    device's busy time and idle share and the device time per kernel or
    copy name; returns the trace's events."""
    trace = out / f"{name}_trace.json"
    with chrome_trace(trace):
        wall_ms = _timed(fn)
    events = json.loads(trace.read_text())["traceEvents"]
    busy_ms = device_busy_us(events) / 1e3
    per_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            per_name[e["name"]][0] += e["dur"] / 1e3
            per_name[e["name"]][1] += 1
    print(f"[{name} trace] {n} chunks, {what}: wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms (union of intervals), idle "
          f"share {1 - busy_ms / wall_ms:.4f}")
    print(f"{'device ms per chunk':>20} {'share of wall':>14} "
          f"{'count':>6}  name")
    for item, (ms, cnt) in sorted(per_name.items(), key=lambda x: -x[1][0]):
        print(f"{ms / n:20.3f} {ms / wall_ms:14.4f} {cnt:6d}  {item[:90]}")
    return events


INGEST_SEED = 24    # the integer coarse delays of the ingest feed


def ingest_setup(cfg: ChainConfig, gen: torch.Generator, device) -> tuple:
    """The fx runner fed through the ingest (``fx64_ingest``, and the chip
    smoke's phase 24): one chunk of seeded int8 noise made with ``gen`` on
    ``device`` and its host copy, seeded integer coarse delays in ``[0,
    32]`` (applied at packet placement), the runner's delay model (d0 =
    d1 = 0, ``max_delay`` 0, the production runner's fringe) and the
    reference's (d0 = those integers, ``max_delay`` 32, the same fringe),
    for which the same samples fed from the card give the same dumps
    bitwise: ``(chunk, host_chunk, delays, runner_dm, reference_dm)``."""
    a, p = cfg.n_ants, cfg.n_pols
    chunk = noise_int8(gen, (a, p, cfg.chunk_samples), device)
    prod = production_delay_model(cfg, np.random.default_rng(6))
    delays = np.random.default_rng(INGEST_SEED).integers(0, 33, (a, p))
    runner_dm = DelayModel.zeros(a, p)
    reference_dm = DelayModel.zeros(a, p, max_delay=32)
    reference_dm.d0 = delays.astype(np.float64)
    for dm in (runner_dm, reference_dm):
        dm.p0, dm.p1 = prod.p0.copy(), prod.p1.copy()
    return chunk, chunk.cpu().numpy(), delays, runner_dm, reference_dm


def _overlap(name: str, events, n: int, more: str) -> None:
    """Print the host-to-device copies' busy time a chunk in ``events``
    and how much of it runs under K1 (``fengine_kernel``) and under any
    kernel."""
    h2d = _spans(events, lambda s: "HtoD" in s)
    k1 = _spans(events, lambda s: "fengine_kernel" in s)
    kern = _spans(events, lambda s: "kernel" in s or "Kernel" in s)
    h2d_ms = sum(hi - lo for lo, hi in h2d) / 1e3
    print(f"[{name} overlap] host-to-device copies busy {h2d_ms / n:.3f} ms "
          f"a chunk; of it under K1 {overlap_us(h2d, k1) / 1e3 / n:.3f} ms, "
          f"under any kernel {overlap_us(h2d, kern) / 1e3 / n:.3f} ms"
          + (f"; {more}" if more else ""))


def _profile_ingest(name: str, gen: torch.Generator, dev, out: Path) -> None:
    """``fx64_ingest``: the fx64 runner fed through the ingest (4 pinned
    assemblers of 16 antennas, SPEAD bursts placed by a thread each, the
    copies on a copy stream, :func:`ingest_setup`); warms one window, then
    traces the next two: the idle share, the host-to-device copies' busy
    time and how much of it runs while K1 (``fengine_kernel``) or any
    kernel runs; then the dump's pinned device-to-host copy alone; then
    (``<name>_ahead``) three chunks placed before the clock, fed to a new
    runner by a feed started inside the trace: the copies' overlap with
    K1 when the placement does not set the pace."""
    from dc_sand_tpu_torch.bench.ingest_bench import (retime, spead_bursts,
                                                      spead_feed)
    from dc_sand_tpu_torch.runtime.ingest import (Feeder, NativeIngest,
                                                  multi_ingest_source)
    cfg = get_config(name.partition("_")[0])
    chunk, host, delays, runner_dm, _ = ingest_setup(cfg, gen, dev)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    runner = FXRunner(cfg, window, delay_model=runner_dm, device=dev)
    n = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    feeder, ingests, submit_ms = spead_feed(host, 3 * n, delays=delays,
                                            max_delay=32, cfg=cfg,
                                            device=dev)
    samples = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    try:
        runner.run(feeder, n)                # warm, one window
        # two windows traced, so that the chunks the feed has ready when
        # the trace starts weigh little
        n *= 2
        events = _trace(name, "fed through the ingest", n,
                        lambda: runner.run(feeder, n), out)
    finally:
        feeder.close()
    stats = [ing.stats() for ing in ingests]
    for ing in ingests:
        ing.close()
    _overlap(name, events, n, "copy stream events ms " + ", ".join(
        f"{t:.3f}" for t in feeder.source.copy_ms) + "; submit ms (each of "
        f"4 threads) median {float(np.median(submit_ms)):.3f}; "
        f"{samples / 1e9:.3f} GB a chunk; ingest counters {stats}")
    vis = extract_vis(runner._acc_total(), cfg.n_ants, cfg.n_pols).contiguous()
    pinned = torch.empty(vis.shape, dtype=vis.dtype, pin_memory=True)
    dump_ms = [_timed(lambda: pinned.copy_(vis, non_blocking=True))
               for _ in range(3)]
    print(f"[{name} dump] pinned device-to-host copy of "
          f"{vis.numel() * 4 / 1e6:.1f} MB ms: "
          + ", ".join(f"{t:.3f}" for t in dump_ms))

    # the same machinery with the placement out of the way: the 3 chunks
    # the rings hold placed before the clock (no delays), the feed started
    # inside the trace, so that each chunk's copy can run under the
    # previous chunk's step
    ahead = [NativeIngest(cfg.n_ants // 4, cfg.n_pols, cfg.chunk_samples,
                          n_slots=3) for _ in range(4)]
    for ing, (blob, lens) in zip(ahead, spead_bursts(host, 4)):
        for i in range(3):
            retime(blob, lens, i * cfg.chunk_samples)
            ing.submit_spead_burst((blob, lens))
    fresh = FXRunner(cfg, window, delay_model=runner_dm, device=dev)

    def placed_ahead():
        with Feeder(multi_ingest_source(ahead, cfg, device=dev), 3) as fd:
            fresh.run(fd, 3)

    events = _trace(f"{name}_ahead", "placed before the clock", 3,
                    placed_ahead, out)
    for ing in ahead:
        ing.close()
    _overlap(f"{name}_ahead", events, 3, "")


def _profile(name: str, gen: torch.Generator, dev, out: Path) -> None:
    """Profile run ``name``: a config, then ``_unfused`` for the unfused
    F-engine, ``_mesh<N>`` for an N-way fx mesh, ``_batched`` for
    ``run_batched``, ``_devcoarse`` for the device coarse mode or
    ``_ingest`` for the feed through the ingest."""
    config, _, variant = name.partition("_")
    if variant == "ingest":
        return _profile_ingest(name, gen, dev, out)
    cfg = get_config(config)
    mesh = None
    if variant.startswith("mesh"):
        n_cards = torch.cuda.device_count()
        mesh = build_mesh([torch.device("cuda", i % n_cards)
                           for i in range(int(variant[4:]))])
        dev = mesh.flat_devices[0]
    elif variant not in ("", "unfused", "batched", "devcoarse"):
        raise SystemExit(f"unknown profile run {name!r}")
    runner, chunks = production_runner(cfg, gen, dev,
                                       fused=variant != "unfused", mesh=mesh,
                                       coarse_on_host=variant != "devcoarse")
    run = runner.run_batched if variant == "batched" else runner.run
    n = len(chunks)
    samples = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    run(lambda i: chunks[i % n], n)          # warm (and capture), one window

    # 1. one window under the profiler, device-resident chunks
    _trace(name, "device-resident", n, lambda: run(lambda i: chunks[i % n], n),
           out)

    # 2. the dump alone
    if runner.mode == "fx":
        dump_ms = [_timed(lambda: extract_vis(runner._acc_total(), cfg.n_ants,
                                              cfg.n_pols).contiguous().cpu())
                   for _ in range(3)]
        print(f"[{name} dump] extract_vis + device-to-host copy ms: "
              + ", ".join(f"{t:.3f}" for t in dump_ms))

    # 3. run() fed from numpy: a pageable host-to-device copy per chunk
    host = [c.cpu().numpy() for c in chunks]
    h2d_ms = _timed(lambda: torch.from_numpy(host[0]).to(dev))
    fed_ms = _timed(lambda: run(lambda i: host[i % n], n)) / n
    print(f"[{name} numpy feed] {run.__name__}() per chunk {fed_ms:.3f} ms = "
          f"{samples / fed_ms / 1e6:.3f} Gsamp/s; host-to-device copy of "
          f"one {host[0].nbytes / 1e9:.3f} GB chunk alone {h2d_ms:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_step",
                    help="directory for the traces")
    ap.add_argument("--runs", default="fx64,beam64,fx64_unfused",
                    help="comma-separated runs: a config name, with "
                         "_unfused, _mesh<N> (e.g. fx64_mesh4), _batched, "
                         "_devcoarse or _ingest")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in args.runs.split(","):
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        _profile(name, gen, dev, out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
