"""Time-varying delay/phase polynomial state (C12) — host side, NumPy.

A copy of :mod:`dc_sand_tpu.runtime.delays`: importing that module runs
``dc_sand_tpu/runtime/__init__.py``, which imports jax, and this package
never imports jax.  A CPU test holds the two equal.

Per (ant, pol) stream the geometric model is a quadratic-in-time
polynomial per chunk (MeerKAT-style delay tracking hands the F-engine
polynomial sets at ~10 s cadence; the quadratic term carries the
geometric acceleration between handoffs — SURVEY.md C2/C12
"time-varying delay polynomial"):

    delay_samples(t) = d0 + d1 * t + d2 * t**2
    phase(t)         = p0 + p1 * t + p2 * t**2

evaluated at sample count ``t`` since stream start.  Per chunk this
yields the coarse (integer) delay, the per-spectrum fractional residual
fed to the fine-delay phase ramp (C5) and the per-spectrum fringe phase.

``update()`` is the production handoff: replace the coefficient set at
a chunk boundary with polynomials referenced to a new epoch — the
runner keeps streaming, and continuity across the handoff is the
delay-tracker's contract, not the F-engine's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DelayModel"]


@dataclasses.dataclass
class DelayModel:
    """Quadratic delay/phase models for ``(n_ants, n_pols)`` streams.

    The quadratic terms default to zero, so linear-model callers (and
    round-3 checkpoints, which predate d2/p2) are unchanged.
    """

    d0: np.ndarray          # (A, P) samples
    d1: np.ndarray          # (A, P) samples/sample (dimensionless rate)
    p0: np.ndarray          # (A, P) radians
    p1: np.ndarray          # (A, P) radians/sample
    max_delay: int          # coarse-delay budget (lead-in samples)
    d2: np.ndarray = None   # (A, P) samples/sample^2
    p2: np.ndarray = None   # (A, P) radians/sample^2
    # epoch (sample count) the polynomials are referenced to: evaluation
    # uses (t - t_ref), so a mid-stream update() hands off coefficients
    # in its own frame without accumulating t^2 precision loss
    t_ref: int = 0

    def __post_init__(self):
        if self.d2 is None:
            self.d2 = np.zeros_like(self.d0)
        if self.p2 is None:
            self.p2 = np.zeros_like(self.p0)

    @classmethod
    def zeros(cls, n_ants: int, n_pols: int, max_delay: int = 0):
        z = np.zeros((n_ants, n_pols))
        return cls(z, z.copy(), z.copy(), z.copy(), max_delay)

    def update(self, *, t_ref: int, d0=None, d1=None, d2=None,
               p0=None, p1=None, p2=None) -> None:
        """Per-dump polynomial handoff: replace any coefficient subset,
        re-referenced to epoch ``t_ref`` (the chunk boundary the new set
        takes effect at).  Unspecified coefficients are RE-EXPRESSED in
        the new epoch (exact polynomial recentering), so a partial
        update never jumps the evaluated delay at the handoff."""
        dt = float(t_ref - self.t_ref)
        # recenter the current polynomials to the new epoch first
        self.d0 = self.d0 + self.d1 * dt + self.d2 * dt * dt
        self.d1 = self.d1 + 2.0 * self.d2 * dt
        self.p0 = self.p0 + self.p1 * dt + self.p2 * dt * dt
        self.p1 = self.p1 + 2.0 * self.p2 * dt
        self.t_ref = int(t_ref)
        for name, val in (("d0", d0), ("d1", d1), ("d2", d2),
                          ("p0", p0), ("p1", p1), ("p2", p2)):
            if val is not None:
                setattr(self, name, np.broadcast_to(
                    np.asarray(val, np.float64), self.d0.shape).copy())

    def evaluate_chunk(self, t0: int, n_spectra: int, fft_size: int):
        """Delay terms for the chunk whose first new sample is ``t0``.

        Returns ``(coarse (A,P) int32, frac (A,P,B) f32, phase (A,P,B)
        f32)``.  Coarse delay is frozen at the chunk start (standard
        F-engine practice: the read-pointer offset holds for a chunk, the
        sub-sample drift rides the fine-delay phase ramp); spectrum b is
        evaluated at its centre sample.
        """
        tr = t0 - self.t_ref
        d_start = self.d0 + self.d1 * tr + self.d2 * tr * tr
        coarse = np.clip(np.rint(d_start), 0, self.max_delay).astype(np.int32)
        # centre of spectrum b within this chunk (new samples only)
        tb = tr + (np.arange(n_spectra) + 0.5) * fft_size  # (B,)
        d_b = (self.d0[..., None] + self.d1[..., None] * tb
               + self.d2[..., None] * tb * tb)             # (A,P,B)
        frac = (d_b - coarse[..., None]).astype(np.float32)
        phase = (self.p0[..., None] + self.p1[..., None] * tb
                 + self.p2[..., None] * tb * tb).astype(np.float32)
        return coarse, frac, phase
