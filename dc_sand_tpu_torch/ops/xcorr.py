"""X-engine cross-correlation CMAC (C8) + integration (C9).

Golden semantics: :func:`dc_sand_tpu_torch.golden.chain.xcorr` over the
canonical :func:`~dc_sand_tpu_torch.golden.chain.baseline_pairs`
ordering.  Per channel, with A = Ar + j*Ai the (antpol, spectrum) int8
matrix,

    V = A A^H = (Ar Ar^T + Ai Ai^T) + j (Ai Ar^T - Ar Ai^T) = vr + j vi.

The streaming path carries ONE packed ``(K, ap, ap)`` int32 plane per
channel (:func:`acc_shape`): vr is symmetric and vi antisymmetric with a
zero diagonal, so the upper triangle (with the diagonal) holds vr and the
strict lower triangle vi.  :func:`xcorr_accumulate_a2` bumps it in place
from the stacked operand ``a2 = [Ar; Ai]`` ``(K, 2ap, B)`` int8 — on CUDA
tensors through the hand-written kernel ``csrc/cmac.cu`` (K2/K3), which
replaces the TPU CMAC kernels of ``dc_sand_tpu/ops/xcorr.py``.
:func:`extract_vis` unpacks the plane to baselines once per dump.

The plain version never multiplies int8 tensors (PyTorch returns int8
and wraps) nor float32 ones (inexact past 2**24; at fx64 sums reach
2*127**2*2048 ~ 6.6e7): it uses int64 on the CPU and float64 on the card,
which is exact below 2**53.  Headroom: |V| <= 2 * 127**2 * b, so at most
~66k spectra per dump fit int32 (the runner enforces it).
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.golden.chain import baseline_pairs
from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["acc_shape", "xcorr_full", "extract_baselines", "extract_vis",
           "xcorr_accumulate", "xcorr_accumulate_a2",
           "xcorr_accumulate_a2_torch", "wire_to_a2", "wire_to_operand"]

# channels per block of the plain version: bounds its exact int64/float64
# operand copy to about 512 MB
_PLAIN_BLOCK_ELEMS = 1 << 26


def acc_shape(n_ants: int, n_pols: int, n_chans: int) -> tuple:
    """Shape of the streaming accumulator: ``(K, ap, ap)`` int32, vr in
    the upper triangle with the diagonal, vi in the strict lower one."""
    ap = n_ants * n_pols
    return (n_chans, ap, ap)


def _vr_vi(a2: torch.Tensor):
    """Exact (vr, vi) of a channel block ``(k, 2ap, b)`` int8, in int64
    (CPU) or float64 (CUDA)."""
    ap = a2.shape[1] // 2
    x = a2.to(torch.float64 if a2.is_cuda else torch.int64)
    ar, ai = x[:, :ap], x[:, ap:]
    art, ait = ar.transpose(1, 2), ai.transpose(1, 2)
    vr = torch.bmm(ar, art) + torch.bmm(ai, ait)
    vi = torch.bmm(ai, art) - torch.bmm(ar, ait)
    return vr, vi


def _pack_mask(ap: int, device) -> torch.Tensor:
    idx = torch.arange(ap, device=device)
    return idx[:, None] <= idx[None, :]


def wire_to_operand(q: torch.Tensor) -> torch.Tensor:
    """Corner-turn glue: wire spectra ``(..., B, K, 2)`` -> the operand
    layout ``(K, 2, S, B)`` (S the leading dims flattened), ``out[k, c,
    s, b] = q[s, b, k, c]``.  One ``permute(...).contiguous()``: a full
    read and write of the spectra, the moveaxis + concat of
    ``dc_sand_tpu/ops/xcorr.py:219-223``.  The fused F-engine writes this
    layout itself (``fengine_fused(..., layout="operand")``)."""
    b, k = q.shape[-3], q.shape[-2]
    return q.reshape(-1, b, k, 2).permute(2, 3, 0, 1).contiguous()


def wire_to_a2(q: torch.Tensor) -> torch.Tensor:
    """Wire spectra ``(S, B, K, 2)`` int8 (S = ap streams) -> the stacked
    CMAC operand ``(K, 2ap, B)`` with ``a2[k, c*ap + s, b] = q[s, b, k,
    c]`` (``[Ar; Ai]`` per channel): :func:`wire_to_operand`, viewed."""
    s, b, k, _ = q.shape
    return wire_to_operand(q).reshape(k, 2 * s, b)


def xcorr_full(q: torch.Tensor) -> torch.Tensor:
    """Full correlation matrix from channel-major quantised spectra
    ``q: (k, ant, pol, b, 2)`` int8 -> ``(k, ap, ap, 2)`` int32, integrated
    over ``b`` (plain version)."""
    k, n_ants, n_pols, b, _ = q.shape
    ap = n_ants * n_pols
    a = q.reshape(k, ap, b, 2)
    vr, vi = _vr_vi(torch.cat([a[..., 0], a[..., 1]], dim=1))
    return torch.stack([vr, vi], dim=-1).to(torch.int32)


def extract_baselines(full: torch.Tensor, n_ants: int,
                      n_pols: int) -> torch.Tensor:
    """(k, ap, ap, 2) int32 -> (n_bl, pol_i, pol_j, k, 2) int32 over the
    canonical i<=j baseline ordering."""
    pairs = torch.as_tensor(baseline_pairs(n_ants), dtype=torch.int64,
                            device=full.device)
    p = torch.arange(n_pols, device=full.device)
    rows = pairs[:, 0, None] * n_pols + p[None, :]  # (n_bl, pol)
    cols = pairs[:, 1, None] * n_pols + p[None, :]
    out = full[:, rows[:, :, None], cols[:, None, :]]  # (k, bl, pi, pj, 2)
    return torch.movedim(out, 0, 3)


def extract_vis(acc: torch.Tensor, n_ants: int, n_pols: int) -> torch.Tensor:
    """Dump-time extraction from the packed accumulator ``(k, ap, ap)`` ->
    ``(n_bl, pi, pj, k, 2)`` int32 canonical visibilities: unpack the
    triangles by symmetry (``vr = vr^T``, ``vi = -vi^T``, zero vi
    diagonal), then gather the baselines."""
    ap = acc.shape[-1]
    upper = _pack_mask(ap, acc.device)
    lower = ~upper
    off_upper = upper & ~torch.eye(ap, dtype=torch.bool, device=acc.device)
    acc_t = acc.transpose(-1, -2)
    vr = torch.where(upper, acc, acc_t)
    vi = torch.where(lower, acc,
                     torch.where(off_upper, -acc_t, torch.zeros_like(acc)))
    full = torch.stack([vr, vi], dim=-1)
    return extract_baselines(full, n_ants, n_pols)


def xcorr_accumulate(acc: torch.Tensor, q: torch.Tensor, keep: int = 1,
                     impl: str = "auto") -> torch.Tensor:
    """One chunk of integration into the packed plane, in place, from
    corner-turned spectra ``q: (k, ant, pol, b, 2)`` int8."""
    k, n_ants, n_pols, b, _ = q.shape
    a = q.reshape(k, n_ants * n_pols, b, 2)
    a2 = torch.cat([a[..., 0], a[..., 1]], dim=1)
    return xcorr_accumulate_a2(acc, a2, keep=keep, impl=impl)


def xcorr_accumulate_a2(acc: torch.Tensor, a2: torch.Tensor, keep: int = 1,
                        impl: str = "auto") -> torch.Tensor:
    """``acc = acc * keep + packed(a2)``, in place (it replaces the JAX
    package's donated accumulator); returns ``acc``.

    ``acc: (K, ap, ap)`` int32; ``a2: (K, 2ap, B)`` int8 ``[Ar; Ai]``;
    ``keep`` 1 integrates, 0 starts a new window (the reset of
    ``xcorr_accumulate_native``).  ``impl="auto"`` launches the CUDA
    kernel on CUDA tensors (each launch adds one to
    ``xcorr_accumulate_a2.launches``) and runs the plain version on CPU
    tensors.
    """
    if keep not in (0, 1):
        raise ValueError(f"keep must be 0 or 1, got {keep!r}")
    if resolve_impl(impl, a2) == "torch":
        return xcorr_accumulate_a2_torch(acc, a2, keep)
    n_chans, tap, n_b = a2.shape
    ap = tap // 2
    dev = a2.device
    if a2.dtype != torch.int8 or not a2.is_contiguous() or tap % 2:
        raise ValueError("a2 must be contiguous int8 (K, 2ap, B)")
    if (acc.dtype != torch.int32 or acc.device != dev
            or not acc.is_contiguous() or acc.shape != (n_chans, ap, ap)):
        raise ValueError(f"acc must be contiguous int32 ({n_chans}, {ap}, "
                         f"{ap}) on {dev}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    if n_b % 16 or a2.data_ptr() % 16:
        raise ValueError(f"the CMAC kernel needs B % 16 == 0 and a 16-byte "
                         f"aligned operand, got B={n_b}")
    if not 1 <= n_chans <= 65535:
        raise ValueError(f"the CMAC kernel takes 1..65535 channels, "
                         f"got {n_chans}")
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_cmac(
            a2.data_ptr(), acc.data_ptr(), n_chans, ap, n_b, int(keep),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_cmac")
    xcorr_accumulate_a2.launches += 1
    return acc


xcorr_accumulate_a2.launches = 0


def xcorr_accumulate_a2_torch(acc: torch.Tensor, a2: torch.Tensor,
                              keep: int = 1) -> torch.Tensor:
    """Plain version of :func:`xcorr_accumulate_a2`: exact products in
    channel blocks, packed by a select, added in int32 in place."""
    n_chans, tap, n_b = a2.shape
    ap = tap // 2
    mask = _pack_mask(ap, a2.device)
    kb = max(1, _PLAIN_BLOCK_ELEMS // max(1, tap * n_b))
    for k0 in range(0, n_chans, kb):
        vr, vi = _vr_vi(a2[k0:k0 + kb])
        packed = torch.where(mask, vr, vi).to(torch.int32)
        blk = acc[k0:k0 + kb]
        if keep:
            blk.add_(packed)
        else:
            blk.copy_(packed)
    return acc
