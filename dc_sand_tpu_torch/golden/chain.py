"""Float64 golden models of the pipeline stages the port grades against.

A numpy copy of the part of :mod:`dc_sand_tpu.golden.chain` that the
port's verify and ``chip_smoke.py`` call: the composed F-engine and its
stages, the X-engine and the beamformer.  The formulas are THE definition
of each stage; a CPU test holds every copied function bitwise equal to
the JAX package's on seeded inputs.

Array conventions: raw streams ``x[..., t]`` real, time-major last axis;
spectra ``s[..., b, k]`` complex128 (``b`` spectrum, ``k`` channel in
``[0, n_chans)``); multi-antenna arrays carry leading ``(ant, pol)`` axes.
The critically-sampled real->complex PFB has FFT length ``M = 2 *
n_chans``; each spectrum consumes ``M`` new samples; the FIR window spans
``taps * M`` samples.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "apply_coarse_delay", "pfb_fir", "channelize", "fine_delay_fringe",
    "requantize", "corner_turn", "xcorr", "beamform", "incoherent_sum",
    "f_engine", "baseline_pairs",
]


def apply_coarse_delay(x: np.ndarray, delays: np.ndarray,
                       max_delay: int) -> np.ndarray:
    """Integer-sample delay per stream: ``y[..., t] = x[..., t + max_delay
    - delay]``, length ``x.shape[-1] - max_delay``; ``delays`` in ``[0,
    max_delay]`` broadcastable over the leading axes of ``x``."""
    x = np.asarray(x)
    delays = np.broadcast_to(np.asarray(delays, dtype=np.int64),
                             x.shape[:-1])
    if np.any(delays < 0) or np.any(delays > max_delay):
        raise ValueError("delays must lie in [0, max_delay]")
    n_out = x.shape[-1] - max_delay
    out = np.empty(x.shape[:-1] + (n_out,), dtype=x.dtype)
    for idx in np.ndindex(*x.shape[:-1]):
        start = max_delay - int(delays[idx])
        out[idx] = x[idx][start:start + n_out]
    return out


def pfb_fir(x: np.ndarray, window: np.ndarray, taps: int,
            fft_size: int) -> np.ndarray:
    """Weighted overlap-add FIR front half of the PFB:
    ``y[..., b, n] = sum_t w[t*M + n] * x[..., (b+t)*M + n]``, float64
    ``(..., n_samples // M - (taps - 1), M)``."""
    x = np.asarray(x, dtype=np.float64)
    m = fft_size
    if x.shape[-1] % m:
        raise ValueError(f"input length {x.shape[-1]} not a multiple of M={m}")
    n_blocks = x.shape[-1] // m
    b_out = n_blocks - (taps - 1)
    if b_out <= 0:
        raise ValueError("input shorter than the FIR window")
    frames = x.reshape(x.shape[:-1] + (n_blocks, m))
    w = np.asarray(window, dtype=np.float64).reshape(taps, m)
    out = np.zeros(x.shape[:-1] + (b_out, m), dtype=np.float64)
    for t in range(taps):
        out += w[t] * frames[..., t:t + b_out, :]
    return out


def channelize(fir_out: np.ndarray, n_chans: int) -> np.ndarray:
    """``rfft`` over the last axis (length ``2*n_chans``), channels
    ``0..n_chans-1`` (the Nyquist bin is dropped)."""
    spec = np.fft.rfft(fir_out, axis=-1)
    return spec[..., :n_chans]


def fine_delay_fringe(spectra: np.ndarray, frac_delay: np.ndarray,
                      phase: np.ndarray) -> np.ndarray:
    """``out[..., b, k] = s[..., b, k] * exp(-j * (2*pi * k * d[..., b] / M
    + p[..., b]))``, ``M = 2 * n_chans``; ``frac_delay`` in samples,
    ``phase`` in radians, both per stream and spectrum."""
    spectra = np.asarray(spectra, dtype=np.complex128)
    n_chans = spectra.shape[-1]
    m = 2 * n_chans
    k = np.arange(n_chans, dtype=np.float64)
    d = np.asarray(frac_delay, dtype=np.float64)[..., None]
    p = np.asarray(phase, dtype=np.float64)[..., None]
    theta = -(2.0 * np.pi / m) * k * d - p
    return spectra * np.exp(1j * theta)


def requantize(spectra: np.ndarray, gains: np.ndarray) -> np.ndarray:
    """Per-channel complex gain, then ``clip(rint(Re/Im), -127, 127)``,
    returned as complex128 holding the integer values."""
    scaled = np.asarray(spectra, dtype=np.complex128) * np.asarray(
        gains, dtype=np.complex128)
    re = np.clip(np.rint(scaled.real), -127, 127)
    im = np.clip(np.rint(scaled.imag), -127, 127)
    return re + 1j * im


def corner_turn(spectra: np.ndarray) -> np.ndarray:
    """``(ant, pol, b, k) -> (k, ant, pol, b)``: antenna-major to
    channel-major, the corner-turn's data movement (on a mesh the
    all-to-all)."""
    return np.moveaxis(spectra, -1, 0)


def baseline_pairs(n_ants: int) -> np.ndarray:
    """Canonical baseline ordering: (i, j) for i<=j, i-major (2080 pairs
    at 64 antennas, autos included)."""
    return np.array([(i, j) for i in range(n_ants)
                     for j in range(i, n_ants)], dtype=np.int32)


def xcorr(spectra: np.ndarray) -> np.ndarray:
    """X-engine CMAC + integration: ``V[bl, pi, pj, k] = sum_b x[i, pi, b,
    k] * conj(x[j, pj, b, k])`` over :func:`baseline_pairs`, from
    ``x[ant, pol, b, k]``."""
    x = np.asarray(spectra, dtype=np.complex128)
    n_ants = x.shape[0]
    full = np.einsum("apbk,cqbk->acpqk", x, np.conj(x))
    pairs = baseline_pairs(n_ants)
    return full[pairs[:, 0], pairs[:, 1]]  # (n_bl, pi, pj, k)


def beamform(spectra: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Coherent beams: ``y[beam, pol, b, k] = sum_ant w[beam, ant, k] *
    x[ant, pol, b, k]`` (weights shared across polarisation)."""
    x = np.asarray(spectra, dtype=np.complex128)
    w = np.asarray(weights, dtype=np.complex128)
    return np.einsum("eak,apbk->epbk", w, x)


def incoherent_sum(spectra: np.ndarray) -> np.ndarray:
    """Incoherent beam: sum_ant |x|^2, per (pol, b, k)."""
    x = np.asarray(spectra, dtype=np.complex128)
    return np.sum(np.abs(x) ** 2, axis=0)


def f_engine(x: np.ndarray, window: np.ndarray, taps: int, n_chans: int,
             *, coarse_delays=None, max_delay: int = 0,
             frac_delay=None, phase=None, gains=None) -> np.ndarray:
    """Full golden F-engine: coarse delay -> PFB -> fine delay/fringe ->
    requantise, each optional stage skipped when its parameters are None
    (``pfb1k`` runs the bare PFB).  ``x[..., t]`` real input; returns
    ``(..., b, k)`` complex128 spectra."""
    m = 2 * n_chans
    if coarse_delays is not None:
        x = apply_coarse_delay(x, coarse_delays, max_delay)
    fir = pfb_fir(x, window, taps, m)
    spec = channelize(fir, n_chans)
    if frac_delay is not None or phase is not None:
        fd = 0.0 if frac_delay is None else frac_delay
        ph = 0.0 if phase is None else phase
        spec = fine_delay_fringe(spec, np.asarray(fd), np.asarray(ph))
    if gains is not None:
        spec = requantize(spec, gains)
    return spec
