"""Fixtures of the card runs: seeded int8 noise made on the device, the
production runner at a config's own cadence with its seeded delay model
and beam pointings, the ingest feed's setup, and the arithmetic of a
trace's device intervals (each card's union, the idle share over the
cards).  ``chip_smoke.py``, the bench targets and the tests draw from
them; ``python -m benchmark.run --trace 1`` measures the cells."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.steering import steering_weights
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["noise_int8", "production_runner", "production_delay_model",
           "ingest_setup", "card_spans_us", "idle_share", "chrome_trace",
           "BEAM_CHUNKS", "INGEST_SEED", "DEVICE_CATS"]

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
                      coarse_on_host: bool = True, rows: slice = None,
                      n_chunks: int = None):
    """The runner at ``cfg``'s own cadence with a seeded delay model
    (coarse up to 31 samples, fractional delay and fringe on) and one
    window of chunks made with ``gen`` on ``device``: one dump's worth in
    fx mode, :data:`BEAM_CHUNKS` in beam mode (or the first ``n_chunks``
    of them), whose beams are steered toward seeded pointings (geometric
    delays up to 0.25 us): ``(runner, chunks)``.  ``fused`` picks the
    runner's F-engine path; with ``mesh`` (whose first shard's device must
    be ``device``) the runner is sharded over it; ``coarse_on_host`` picks
    the coarse mode; ``rows`` keeps only those antennas of each chunk (a
    rank's, made one chunk at a time from the same draws)."""
    rng = np.random.default_rng(6)
    a, p = cfg.n_ants, cfg.n_pols
    dm = production_delay_model(cfg, rng)
    weights = None
    if cfg.n_beams:
        n_chunks = n_chunks or BEAM_CHUNKS
        weights = steering_weights(
            rng.uniform(-2.5e-7, 2.5e-7, (cfg.n_beams, a)), cfg.n_chans,
            cfg.sample_rate_hz)
    else:
        n_chunks = n_chunks or cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    chunks = [noise_int8(gen, (a, p, cfg.chunk_samples), device)
              for _ in range(n_chunks)] if rows is None else [
        noise_int8(gen, (a, p, cfg.chunk_samples), device)[rows].clone()
        for _ in range(n_chunks)]
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                      delay_model=dm, weights=weights,
                      device=None if mesh is not None else device,
                      mesh=mesh, fused=fused, coarse_on_host=coarse_on_host)
    return runner, chunks


def _union_us(spans, lo: float = float("-inf")) -> float:
    """Length of the union of the intervals ``spans``, from ``lo`` on."""
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    return busy


def card_spans_us(events, base_us: float = 0.0) -> dict:
    """The device intervals of chrome-trace ``events`` by card: ``{card
    index: [(lo, hi), ...]}`` in us, shifted by ``base_us`` (a trace's
    ``baseTimeNanoseconds`` / 1e3 puts them on the host's clock)."""
    out = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            card = int(e.get("args", {}).get("device", 0))
            out[card].append((base_us + e["ts"], base_us + e["ts"] + e["dur"]))
    return dict(out)


def idle_share(runs) -> tuple:
    """``(idle share, busy ms, wall ms, cards)`` over every card of the
    ``runs`` (one per rank, or one: ``{"window_us": (lo, hi), "spans_us":
    {card: [(lo, hi), ...]}}`` on one clock): each card's busy time is
    the union of every run's intervals on it within the span of all the
    windows, and the idle share is one minus their sum over the cards
    times that span (on one card, one minus the union over the wall).
    The share is None when the intervals do not line up with the windows
    (less than 0.9 of their length inside)."""
    lo = min(x["window_us"][0] for x in runs)
    hi = max(x["window_us"][1] for x in runs)
    by_card = defaultdict(list)
    for x in runs:
        for card, spans in x["spans_us"].items():
            by_card[int(card)] += spans
    total = inside = busy = 0.0
    for spans in by_card.values():
        total += sum(b - a for a, b in spans)
        clipped = [(max(a, lo), min(b, hi)) for a, b in spans]
        inside += sum(max(0.0, b - a) for a, b in clipped)
        busy += _union_us(clipped, lo)
    cards = max(len(by_card), 1)
    share = (1 - busy / (cards * (hi - lo))
             if total and inside >= 0.9 * total else None)
    return share, busy / 1e3, (hi - lo) / 1e3, cards


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


INGEST_SEED = 24    # the integer coarse delays of the ingest feed


def ingest_setup(cfg: ChainConfig, gen: torch.Generator, device) -> tuple:
    """The fx runner fed through the ingest (the chip smoke's phase 24,
    the ingest tests): one chunk of seeded int8 noise made with ``gen`` on
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
