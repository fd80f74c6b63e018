"""A chunk's delay terms from the delay polynomials, on the chunk's device.

:meth:`~dc_sand_tpu_torch.runtime.delays.DelayModel.evaluate_chunk`
computes them in numpy on the host; :func:`delay_terms` computes the same
numbers, bitwise, from the coefficients held as one ``(6, S)`` float64
tensor (rows ``d0, d1, d2, p0, p1, p2``, one column a stream), so that the
runner neither evaluates them on the host nor copies them up each chunk.
On a CUDA tensor it launches ``csrc/delays.cu`` (``dcs_delay_terms``), one
launch a chunk; that kernel is the port's own, as the JAX package
evaluates the model in numpy outside any kernel.  :func:`delay_terms_torch`
is the plain version in float64; a CPU tensor takes it.

Both keep numpy's order of operations, ``(c0 + c1*x) + (c2*x)*x``, with no
fused multiply-add, at ``x = tr`` for the coarse delay and at ``x = tr +
(b + 0.5) * fft_size`` for spectrum ``b``; the coarse delay is rounded
half to even and clipped to ``[0, max_delay]``, and ``frac`` and
``phase`` are rounded to float32 once.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["delay_terms", "delay_terms_torch", "COEFFICIENTS"]

# the rows of the coefficient tensor, in order
COEFFICIENTS = ("d0", "d1", "d2", "p0", "p1", "p2")


def delay_terms(coef: torch.Tensor, tr: float, n_spectra: int,
                fft_size: int, max_delay: int, *, out=None,
                impl: str = "auto") -> tuple:
    """``(coarse (S,) int32, frac (S, B) float32, phase (S, B) float32)``
    of the chunk whose first new sample lies ``tr`` samples after the
    polynomials' epoch, on ``coef``'s device.

    ``coef``: ``(6, S)`` float64, contiguous, rows :data:`COEFFICIENTS`;
    ``out``: ``(coarse, frac, phase)`` tensors of those shapes and types,
    contiguous, on that device, written in place (None allocates them).
    ``impl``: ``"auto"`` launches the kernel on a CUDA tensor and runs the
    plain version on a CPU tensor; ``"torch"`` names the plain version on
    either.  Each kernel launch adds one to ``delay_terms.launches``.
    """
    if coef.dim() != 2 or coef.shape[0] != len(COEFFICIENTS) \
            or coef.dtype != torch.float64 or not coef.is_contiguous():
        raise ValueError(f"coef must be contiguous float64 (6, S), got "
                         f"{coef.dtype} {tuple(coef.shape)}")
    s, b, dev = coef.shape[1], n_spectra, coef.device
    if b < 1 or max_delay < 0:
        raise ValueError(f"n_spectra {b} must be >= 1 and max_delay "
                         f"{max_delay} >= 0")
    if out is None:
        out = (torch.empty((s,), dtype=torch.int32, device=dev),
               torch.empty((s, b), dtype=torch.float32, device=dev),
               torch.empty((s, b), dtype=torch.float32, device=dev))
    for t, dtype, shape in zip(out, (torch.int32, torch.float32,
                                     torch.float32), ((s,), (s, b), (s, b))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"out must be contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    coarse, frac, phase = out
    if resolve_impl(impl, coef) == "torch":
        delay_terms_torch(coef, tr, b, fft_size, max_delay, out)
        return out
    if s > 65535:
        raise ValueError(f"the kernel takes 1..65535 streams, got {s}")
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_delay_terms(
            coef.data_ptr(), s, float(tr), b, fft_size, max_delay,
            coarse.data_ptr(), frac.data_ptr(), phase.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_delay_terms")
    delay_terms.launches += 1
    return out


delay_terms.launches = 0


def _quadratic(c0, c1, c2, x):
    """``(c0 + c1*x) + (c2*x)*x``: numpy's order for ``c0 + c1 * x + c2 *
    x * x``, each operation rounded on its own."""
    return (c0 + c1 * x) + (c2 * x) * x


def delay_terms_torch(coef: torch.Tensor, tr: float, n_spectra: int,
                      fft_size: int, max_delay: int, out: tuple) -> None:
    """The plain version into ``out = (coarse, frac, phase)``."""
    d0, d1, d2, p0, p1, p2 = (c[:, None] for c in coef)
    tr = float(tr)
    coarse = torch.clamp(torch.round(_quadratic(d0, d1, d2, tr)), 0,
                         max_delay)
    x = tr + (torch.arange(n_spectra, dtype=torch.float64,
                           device=coef.device) + 0.5) * fft_size
    out[0].copy_(coarse[:, 0])
    out[1].copy_(_quadratic(d0, d1, d2, x) - coarse)
    out[2].copy_(_quadratic(p0, p1, p2, x))
