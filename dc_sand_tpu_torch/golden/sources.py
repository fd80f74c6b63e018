"""Synthetic signal sources (deterministic): a numpy copy of
:mod:`dc_sand_tpu.golden.sources`.  A CPU test
holds each function bitwise equal to the JAX package's."""

from __future__ import annotations

import numpy as np

__all__ = ["cw_tone", "gaussian_noise", "quantize_adc", "gaussian_noise_int8"]


def cw_tone(n_samples: int, freq_hz: float, sample_rate_hz: float,
            amplitude: float = 100.0, phase: float = 0.0) -> np.ndarray:
    """Real-valued continuous-wave tone, float64, length ``n_samples``."""
    t = np.arange(n_samples, dtype=np.float64) / sample_rate_hz
    return amplitude * np.cos(2.0 * np.pi * freq_hz * t + phase)


def gaussian_noise(n_samples, sigma: float = 10.0,
                   seed: int = 0) -> np.ndarray:
    """White Gaussian noise ``N(0, sigma)``, float64, from
    ``np.random.default_rng(seed)``; ``n_samples`` may be a shape
    tuple."""
    rng = np.random.default_rng(seed)
    shape = n_samples if isinstance(n_samples, tuple) else (n_samples,)
    return rng.normal(0.0, sigma, size=shape)


def quantize_adc(x: np.ndarray) -> np.ndarray:
    """Digitise to int8: round-half-even, saturate to [-127, 127] (-128 is
    excluded to keep the code symmetric)."""
    return np.clip(np.rint(x), -127, 127).astype(np.int8)


def gaussian_noise_int8(shape: tuple, sigma: float = 10.0,
                        seed: int = 0) -> np.ndarray:
    """``quantize_adc`` of white Gaussian noise ``N(0, sigma)`` of
    ``shape`` drawn from ``np.random.default_rng(seed)``, made one row of
    the last axis at a time, so that only the int8 result is held: the
    generator draws normals sequentially, so the rows drain its stream
    exactly as one whole-array draw would."""
    rng = np.random.default_rng(seed)
    lead = shape[:-1]
    out = np.empty(shape, dtype=np.int8)
    if not lead:
        return quantize_adc(rng.normal(0.0, sigma, size=shape))
    flat = out.reshape(-1, shape[-1])
    for i in range(flat.shape[0]):
        flat[i] = quantize_adc(rng.normal(0.0, sigma, size=shape[-1]))
    return out
