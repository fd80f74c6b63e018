"""Beam-steering weights (B-engine support).

A numpy copy of :func:`dc_sand_tpu.models.steering.steering_weights`
(``dc_sand_tpu/models/__init__.py`` imports jax); a CPU test holds the two
equal.  A coherent beam points at a sky direction by compensating each
antenna's geometric delay: ``w[beam, ant, chan] = exp(+2 pi i f_k tau)``,
optionally amplitude-tapered, in the ``(beam, ant, chan, 2)`` wire format
that the runner and :func:`dc_sand_tpu_torch.ops.beamform.beamform` take.
"""

from __future__ import annotations

import numpy as np

__all__ = ["steering_weights"]


def steering_weights(delays_s: np.ndarray, n_chans: int,
                     sample_rate_hz: float,
                     taper: np.ndarray = None) -> np.ndarray:
    """Weights from per-beam per-antenna delays.

    ``delays_s: (n_beams, n_ants)`` geometric delay of each antenna
    toward each beam's pointing (seconds).  Channel k's centre frequency
    is ``k * sample_rate / (2*n_chans)`` (baseband).  Returns float32
    ``(n_beams, n_ants, n_chans, 2)``.
    """
    delays_s = np.asarray(delays_s, np.float64)
    if delays_s.ndim != 2:
        raise ValueError("delays_s must be (n_beams, n_ants)")
    f = np.arange(n_chans) * (sample_rate_hz / (2.0 * n_chans))
    phase = 2.0 * np.pi * delays_s[..., None] * f  # (beam, ant, k)
    w = np.exp(1j * phase)
    if taper is not None:
        w = w * np.asarray(taper)[None, :, None]
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)
