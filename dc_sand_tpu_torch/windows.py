"""Polyphase filterbank prototype-window generation (pure NumPy).

A copy of :mod:`dc_sand_tpu.windows`, so that the port, its golden
oracle and the JAX package filter with bit-identical coefficients; a CPU
test holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pfb_window"]


def pfb_window(taps: int, fft_size: int, kind: str = "hann-sinc") -> np.ndarray:
    """Return the length ``taps * fft_size`` PFB prototype window (float64).

    The window is normalised so its coefficients sum to ``fft_size`` — a DC
    input of amplitude *a* then produces an FFT bin-0 amplitude of
    ``a * fft_size``, matching an unwindowed FFT's scaling.

    ``kind``: ``"hann-sinc"`` (Hann-windowed sinc lowpass, the standard
    radio-astronomy PFB prototype), ``"hann"`` (plain Hann window,
    config ``pfb1k``'s "16-tap Hann FIR") or ``"rect"`` (boxcar).
    """
    length = taps * fft_size
    n = np.arange(length, dtype=np.float64)
    if kind == "hann-sinc":
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))
        # sinc argument in units of the channel spacing; centred.
        x = (n - (length - 1) / 2.0) / fft_size
        w = hann * np.sinc(x)
    elif kind == "hann":
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))
    elif kind == "rect":
        w = np.ones(length, dtype=np.float64)
    else:
        raise ValueError(f"unknown PFB window kind: {kind!r}")
    # Normalise: sum of coefficients == fft_size (see docstring).
    w *= fft_size / np.sum(w)
    return w
