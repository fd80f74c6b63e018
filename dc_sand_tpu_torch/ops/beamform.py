"""B-engine: coherent multi-beam weighted sum (C10) + incoherent sum (C11).

Golden semantics: :func:`dc_sand_tpu.golden.chain.beamform` /
:func:`~dc_sand_tpu.golden.chain.incoherent_sum`.  Per channel k,

    y[e, p, b, k] = sum_a w[e, a, k] * x[a, p, b, k]

and the incoherent beam is ``sum_a |x[a, p, b, k]|^2``.  On CUDA tensors
:func:`beamform` launches the hand-written kernel ``csrc/beamform.cu``,
which replaces the TPU kernels of ``dc_sand_tpu/ops/beamform.py``
(``_beam_native_kernel``, ``_beam_native_kernel_pmerge`` and
``_bf_kernel``): it reads the F-engine's wire spectra as they are, forms
both outputs in one pass, and can quantise the beams to int8 in its
epilogue.  The kernel runs each channel as a real GEMM on the bf16
tensor cores with exact operands: the int8 samples as they are, and each
float32 weight split into three bf16 pieces (:func:`split3`), laid out
with the reduction axis ordered (antenna, re/im)
(:func:`interleaved_weights`); :func:`beamform_split_torch` is that
arithmetic in plain PyTorch, for the tests.  On CPU tensors
:func:`beamform` runs the plain versions below.

The plain versions cast int8 samples to float32 before any product:
PyTorch's int8 ``einsum`` returns int8 and wraps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["beamform", "beamform_torch", "incoherent_sum",
           "incoherent_sum_torch",
           "quantize_beams", "split3", "interleaved_weights",
           "beamform_split_torch"]


def _split_ri(x: torch.Tensor):
    """Wire-format ``(..., 2)`` re/im -> two float32 tensors."""
    return x[..., 0].to(torch.float32), x[..., 1].to(torch.float32)


def beamform_torch(q: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain version: ``q (a, p, b, k, 2)`` int8 or float32, ``weights
    (nb, a, k, 2)`` float32 -> float32 beams ``(nb, p, b, k, 2)``, as four
    real float32 contractions (the JAX package's jnp arm)."""
    xr, xi = _split_ri(q)
    wr, wi = _split_ri(weights)

    def mm(w_, x_):
        return torch.einsum("eak,apbk->epbk", w_, x_)

    return torch.stack([mm(wr, xr) - mm(wi, xi), mm(wr, xi) + mm(wi, xr)],
                       dim=-1)


def split3(w: torch.Tensor):
    """The kernel's weight split: float32 ``w`` -> ``(hi, mid, lo)``, each
    float32 holding a bf16 value, ``hi = bf16(w)``, ``mid = bf16(w - hi)``,
    ``lo = bf16(w - hi - mid)`` (round to nearest even, residuals in
    float32).  8 + 8 + 8 significant bits: ``hi + mid + lo == w`` exactly
    for a normal float32."""
    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    hi = bf16(w)
    r1 = w - hi
    mid = bf16(r1)
    return hi, mid, bf16(r1 - mid)


def interleaved_weights(weights: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: ``weights (nb, a, k, 2)`` -> ``W' (k, 2a,
    2nb)`` with rows ``2a + c'`` (antenna, re/im of the sample) and
    columns ``2e + c`` (beam, re/im of the output): ``(wr, -wi)`` down the
    real column, ``(wi, wr)`` down the imaginary."""
    wr, wi = weights[..., 0], weights[..., 1]              # (nb, a, k)
    col_re = torch.stack([wr, -wi], dim=-1)                # (nb, a, k, c')
    col_im = torch.stack([wi, wr], dim=-1)
    w4 = torch.stack([col_re, col_im], dim=-1)             # (nb, a, k, c', c)
    nb, a, k = wr.shape
    return w4.permute(2, 1, 3, 0, 4).reshape(k, 2 * a, 2 * nb)


def beamform_split_torch(q: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per channel the real
    product ``X' (p*b, 2a) @ W' (2a, 2nb)`` once for each bf16 piece of
    the weights, summed in float32.  Same arguments and result as
    :func:`beamform_torch`."""
    a, p, b, k, _ = q.shape
    nb = weights.shape[0]
    x = q.to(torch.float32).permute(3, 1, 2, 0, 4).reshape(k, p * b, 2 * a)
    y = sum(torch.matmul(x, interleaved_weights(piece))
            for piece in reversed(split3(weights)))
    return y.reshape(k, p, b, nb, 2).permute(3, 1, 2, 0, 4).contiguous()


def quantize_beams(y: torch.Tensor, quant_scale: float) -> torch.Tensor:
    """The int8 beam product ``clip(rint(y * quant_scale), -127, 127)`` of
    float beams (round half to even)."""
    return torch.clamp(torch.round(y * quant_scale), -127, 127).to(
        torch.int8)


def incoherent_sum_torch(q: torch.Tensor) -> torch.Tensor:
    """Plain version of the incoherent beam: ``sum_a (xr^2 + xi^2)`` ->
    float32 ``(p, b, k)``; exact for int8 samples (every partial sum is
    an integer below 2**24 up to 520 antennas)."""
    xr, xi = _split_ri(q)
    return (xr * xr + xi * xi).sum(dim=0)


def incoherent_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum_ant |x|^2`` per (pol, b, k), float32: ``x (ant, pol, b, k,
    2)`` int8 or float32 wire spectra, or complex ``(ant, pol, b, k)``
    (the JAX package's ``ops.incoherent_sum``).  The beam kernel forms
    the same sum beside the beams (:func:`beamform` with ``incoherent``);
    alone it is :func:`incoherent_sum_torch`."""
    if x.is_complex():
        x = torch.view_as_real(x)
    return incoherent_sum_torch(x)


def beamform(q: torch.Tensor, weights: torch.Tensor, *,
             quant_scale: float = 0.0, incoherent: bool = False,
             impl: str = "auto") -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Coherent beams and, with ``incoherent``, the incoherent beam.

    ``q: (a, p, b, k, 2)`` wire spectra (int8; the plain version also
    takes float32), ``weights: (nb, a, k, 2)`` float32 re/im.  Returns
    ``(beams, inc)``: ``beams (nb, p, b, k, 2)`` float32, or when
    ``quant_scale > 0`` the int8 beam product ``clip(rint(y *
    quant_scale), -127, 127)`` of the float beams (round half to even);
    ``inc (p, b, k)`` float32, or None without ``incoherent``.

    ``impl="auto"`` launches the CUDA kernel on CUDA tensors (each launch
    adds one to ``beamform.launches``) and runs the plain versions on CPU
    tensors; ``"torch"`` names the plain versions on either device.  Float
    spectra (beam mode without requantisation) take the float product
    :func:`beamform_torch` on either device and launch nothing: the JAX
    package routes only int8 spectra to its Pallas kernel
    (``dc_sand_tpu/ops/beamform.py:381-383``).
    """
    if q.dim() != 5 or q.shape[-1] != 2:
        raise ValueError(f"q must be (a, p, b, k, 2), got {tuple(q.shape)}")
    n_ants, n_pols, n_b, n_k, _ = q.shape
    if (weights.dim() != 4 or weights.shape[1:] != (n_ants, n_k, 2)
            or weights.shape[0] < 1):
        raise ValueError(f"weights must be (nb, {n_ants}, {n_k}, 2), got "
                         f"{tuple(weights.shape)}")
    if not quant_scale >= 0.0:
        raise ValueError(f"quant_scale must be >= 0, got {quant_scale}")
    if resolve_impl(impl, q) == "torch" or q.is_floating_point():
        y = beamform_torch(q, weights)
        if quant_scale:
            y = quantize_beams(y, quant_scale)
        return y, (incoherent_sum_torch(q) if incoherent else None)
    dev = q.device
    if q.dtype != torch.int8 or not q.is_contiguous() or q.data_ptr() % 2:
        raise ValueError(f"q must be contiguous, 2-byte aligned int8, got "
                         f"{q.dtype}")
    if (weights.dtype != torch.float32 or weights.device != dev
            or not weights.is_contiguous() or weights.data_ptr() % 8):
        raise ValueError(f"weights must be contiguous, 8-byte aligned "
                         f"float32 on {dev}, got {weights.dtype} on "
                         f"{weights.device}")
    n_beams = weights.shape[0]
    beams = torch.empty((n_beams, n_pols, n_b, n_k, 2),
                        dtype=torch.int8 if quant_scale else torch.float32,
                        device=dev)
    inc = (torch.empty((n_pols, n_b, n_k), dtype=torch.float32, device=dev)
           if incoherent else None)
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_beamform(
            q.data_ptr(), weights.data_ptr(), beams.data_ptr(),
            None if inc is None else inc.data_ptr(), n_ants, n_pols, n_b,
            n_k, n_beams, float(quant_scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_beamform")
    beamform.launches += 1
    return beams, inc


beamform.launches = 0
