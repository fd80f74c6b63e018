"""The traffic generator: everything a run feeds the system, made from
``--seed`` and a traffic file's parameters, handed alike to the program
and to the reference.

* The chunks: a ring of ``ring_chunks`` distinct chunks of int8 Gaussian
  noise (``noise_sigma``), made on the card, one generator an antenna and
  chunk seeded from the run's seed, so that a rank makes its own
  antennas' rows of the same stream.  Chunk i of the stream is ring
  chunk ``i mod ring_chunks``.
* The delay model: coarse delays drawn in ``coarse_delay`` samples, delay
  rates in +-``delay_rate`` (samples a sample), fringe phases in +-pi and
  fringe rates in +-``fringe_rate`` (radians a sample).  The delays stay
  inside the coarse budget for :func:`delay_margin_s` of stream.
* The gains: a complex gain a channel of magnitude ``requant_rms`` over
  the rms of a channel's noise, times 1 +- ``gain_spread``, and a random
  phase.
* Beam weights (beam cells): steering weights toward seeded pointings,
  geometric delays in +-``beam_pointing_s`` seconds.
* The PFB window, from the configuration's kind.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def seed_words(seed: int, *path) -> list:
    """Entropy words of a stream of random numbers below the run's seed
    (any integer, negative ones too)."""
    return [int(seed) % 2 ** 64, *path]


def rng(seed: int, *path) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(seed_words(seed, *path)))


def torch_seed(seed: int, *path) -> int:
    return int(np.random.SeedSequence(seed_words(seed, *path))
               .generate_state(1, np.uint64)[0] >> 1)


def pfb_window(taps: int, fft_size: int, kind: str) -> np.ndarray:
    """The PFB prototype window, float64, its coefficients summing to M:
    Hann-windowed sinc (``hann-sinc``), Hann (``hann``) or boxcar
    (``rect``)."""
    length = taps * fft_size
    n = np.arange(length, dtype=np.float64)
    if kind == "hann-sinc":
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) * np.sinc(
            (n - (length - 1) / 2.0) / fft_size)
    elif kind == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))
    elif kind == "rect":
        w = np.ones(length)
    else:
        raise ValueError(f"unknown window kind {kind!r}")
    return w * (fft_size / np.sum(w))


def delay_margin_s(traffic: dict, max_delay: int,
                   sample_rate_hz: float) -> float:
    """Seconds of stream for which every delay drawn under ``traffic``
    stays inside ``[0, max_delay]`` samples: the smaller gap between the
    drawn range and the budget's ends, over the largest rate."""
    lo, hi = traffic["coarse_delay"]
    gap = min(lo, max_delay - hi)
    return gap / traffic["delay_rate"] / sample_rate_hz


@dataclasses.dataclass
class Delays:
    """The delay and fringe polynomials ``(A, P)`` (constant and linear
    terms, referenced to sample 0) and the coarse budget."""
    d0: np.ndarray
    d1: np.ndarray
    p0: np.ndarray
    p1: np.ndarray
    max_delay: int

    def evaluate(self, t0: int, n_spectra: int, fft_size: int) -> tuple:
        """``(coarse (A, P) int32, frac (A, P, B) float32, phase (A, P, B)
        float32)`` of the chunk whose first new sample is ``t0``: the
        coarse delay frozen at the chunk's start and clamped to the
        budget, the fractional residual and the fringe phase at each
        spectrum's centre sample."""
        d_start = self.d0 + self.d1 * t0
        coarse = np.clip(np.rint(d_start), 0, self.max_delay).astype(np.int32)
        tb = t0 + (np.arange(n_spectra) + 0.5) * fft_size
        d_b = self.d0[..., None] + self.d1[..., None] * tb
        frac = (d_b - coarse[..., None]).astype(np.float32)
        phase = (self.p0[..., None] + self.p1[..., None] * tb).astype(
            np.float32)
        return coarse, frac, phase


@dataclasses.dataclass
class Inputs:
    """What one run feeds: the ring (``(A_rows, P, C)`` int8 each), the
    delays, the gains ``(K, 2)`` float32, the beam weights ``(nb, A, K,
    2)`` float32 or None, the window."""
    ring: list
    delays: Delays
    gains: np.ndarray
    weights: np.ndarray
    window: np.ndarray
    rows: slice


def noise_chunk(seed: int, chunk: int, rows: slice, n_pols: int,
                samples: int, sigma: float, device) -> torch.Tensor:
    """Ring chunk ``chunk``'s antennas ``rows``: ``(rows, P, samples)``
    int8, one generator an antenna."""
    out = torch.empty((rows.stop - rows.start, n_pols, samples),
                      dtype=torch.int8, device=device)
    gen = torch.Generator(device=device)
    for k, ant in enumerate(range(rows.start, rows.stop)):
        gen.manual_seed(torch_seed(seed, 0, chunk, ant))
        x = torch.randn((n_pols, samples), generator=gen, device=device)
        out[k] = torch.clamp(torch.round(x * sigma), -127, 127).to(torch.int8)
    return out


def make_inputs(seed: int, traffic: dict, cfg, max_delay: int, device,
                rows: slice = None) -> Inputs:
    """The run's inputs for configuration ``cfg`` (the port's
    ``ChainConfig``, or anything with its fields) and coarse budget
    ``max_delay`` under ``traffic``; the chunks hold antennas ``rows``
    (all by default)."""
    a, p, k, m = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.fft_size
    rows = rows or slice(0, a)
    window = pfb_window(cfg.n_taps, m, cfg.window)
    ring = [noise_chunk(seed, c, rows, p, cfg.chunk_samples,
                        traffic["noise_sigma"], device)
            for c in range(traffic["ring_chunks"])]
    r = rng(seed, 1)
    lo, hi = traffic["coarse_delay"]
    delays = Delays(d0=r.uniform(lo, hi, (a, p)),
                    d1=r.uniform(-1, 1, (a, p)) * traffic["delay_rate"],
                    p0=r.uniform(-np.pi, np.pi, (a, p)),
                    p1=r.uniform(-1, 1, (a, p)) * traffic["fringe_rate"],
                    max_delay=max_delay)
    # the rms of one component of a channel of the noise after the PFB
    chan_rms = traffic["noise_sigma"] * np.sqrt(np.sum(window ** 2) / 2)
    mag = traffic["requant_rms"] / chan_rms * (
        1 + traffic["gain_spread"] * r.uniform(-1, 1, k))
    ph = r.uniform(-np.pi, np.pi, k)
    gains = np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).astype(
        np.float32)
    weights = None
    if cfg.n_beams:
        tau = r.uniform(-1, 1, (cfg.n_beams, a)) * traffic["beam_pointing_s"]
        f = np.arange(k) * (cfg.sample_rate_hz / m)
        w = np.exp(2j * np.pi * tau[..., None] * f)
        weights = np.stack([w.real, w.imag], -1).astype(np.float32)
    return Inputs(ring, delays, gains, weights, window, rows)
