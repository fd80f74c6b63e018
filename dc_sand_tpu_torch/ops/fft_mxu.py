"""Matmul-formulated real FFT: the channelizer FFT as two batched matrix
products and a twiddle multiply.

PyTorch counterpart of :mod:`dc_sand_tpu.ops.fft_mxu`, which has no
Pallas kernel (two XLA matmuls on the TPU's MXU).  The same Cooley-Tukey
split ``M = M1*M2`` (:func:`_factor`) and the same float32 tables
(:func:`_tables`), as ``torch.matmul`` in float32 with TF32 off, the
counterpart of the JAX module's ``Precision.HIGHEST``:

    x[n1 + M1*n2]  (reshape to [n2, n1])
    Y[n1, k2] = sum_n2 x[n2, n1] * W_M2^(n2 k2)      (matmul over n2)
    Z[n1, k2] = Y[n1, k2] * W_M^(n1 k2)              (twiddle)
    X[k2 + M2*k1] = sum_n1 Z[n1, k2] * W_M1^(n1 k1)  (matmul over n1)

Only bins ``k < M/2`` are kept (the channelizer drops Nyquist), so the
outer product needs ``M1/2`` rows of its DFT matrix.  The fx path runs
its FFT inside the fused F-engine kernel; this is the bench's
``fft_mxu_matmul`` beside ``torch.fft.rfft``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = ["rfft_mxu", "channelize_mxu"]


def _factor(m: int) -> tuple:
    """Pick M1 (outer) * M2 (inner) = m, as the JAX module does."""
    for m1 in (64, 32, 128, 16, 8):
        if m % m1 == 0 and m // m1 >= 8:
            return m1, m // m1
    raise ValueError(f"FFT size {m} not factorable for the matmul path")


@functools.lru_cache(maxsize=8)
def _tables_np(m: int):
    """DFT and twiddle tables, float32 numpy (built once in float64)."""
    m1, m2 = _factor(m)
    n2 = np.arange(m2)
    k2 = np.arange(m2)
    w2 = np.exp(-2j * np.pi * np.outer(n2, k2) / m2)      # (n2, k2)
    n1 = np.arange(m1)
    tw = np.exp(-2j * np.pi * np.outer(n1, k2) / m)        # (n1, k2)
    k1 = np.arange(m1 // 2)
    w1 = np.exp(-2j * np.pi * np.outer(k1, n1) / m1)       # (k1, n1)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (m1, m2, f32(w2.real), f32(w2.imag), f32(tw.real),
            f32(tw.imag), f32(w1.real), f32(w1.imag))


def _tables(m: int, device) -> tuple:
    m1, m2, *arrs = _tables_np(m)
    return (m1, m2) + tuple(torch.from_numpy(a).to(device) for a in arrs)


@contextlib.contextmanager
def _full_float32():
    """Float32 products without TF32 for the duration of the call."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def rfft_mxu(x: torch.Tensor) -> torch.Tensor:
    """rfft over the last axis (length M), keeping bins [0, M/2).

    float32 in -> complex64 ``(..., M/2)`` out, bins in natural order."""
    m = x.shape[-1]
    m1, m2, w2r, w2i, twr, twi, w1r, w1i = _tables(m, x.device)
    lead = x.shape[:-1]
    # (..., n2, n1) -> (..., n1, n2)
    xf = x.to(torch.float32).reshape(lead + (m2, m1)).transpose(-1, -2)
    with _full_float32():
        # inner DFT over n2: (..., n1, n2) @ (n2, k2) -> (..., n1, k2)
        yr, yi = xf @ w2r, xf @ w2i
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
        # outer DFT over n1, k1 < m1/2: (k1, n1) @ (..., n1, k2)
        xr = w1r @ zr - w1i @ zi
        xi = w1i @ zr + w1r @ zi
    return torch.complex(xr, xi).reshape(lead + ((m1 // 2) * m2,))


def channelize_mxu(fir_out: torch.Tensor, n_chans: int) -> torch.Tensor:
    """Drop-in for :func:`dc_sand_tpu_torch.ops.fft.channelize` on the
    matmul path."""
    if fir_out.shape[-1] != 2 * n_chans:
        raise ValueError(
            f"FFT length {fir_out.shape[-1]} != 2*n_chans={2 * n_chans}")
    return rfft_mxu(fir_out)
