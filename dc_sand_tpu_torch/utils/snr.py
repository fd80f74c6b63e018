"""Signal-to-noise verification metric (numpy).

A copy of :func:`dc_sand_tpu.utils.snr.snr_db`: that package's
``utils/__init__`` imports jax, which this package never imports.  A CPU
test holds the two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["snr_db"]


def snr_db(golden, test) -> float:
    """10 log10( sum|golden|^2 / sum|golden - test|^2 ), in float64.

    Returns ``inf`` for an exact match and ``-inf`` for a zero golden
    signal with nonzero residual.
    """
    g = np.asarray(golden, dtype=np.complex128)
    t = np.asarray(test, dtype=np.complex128)
    if g.shape != t.shape:
        raise ValueError(f"shape mismatch: golden {g.shape} vs test {t.shape}")
    sig = float(np.sum(np.abs(g) ** 2))
    err = float(np.sum(np.abs(g - t) ** 2))
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(sig / err)
