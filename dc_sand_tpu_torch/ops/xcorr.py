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
           "xcorr_accumulate_a2_torch", "wire_to_a2", "wire_to_operand",
           "cmac_units", "cmac_plan_torch"]

# channels per block of the plain version: bounds its exact int64/float64
# operand copy to about 512 MB
_PLAIN_BLOCK_ELEMS = 1 << 26

# csrc/cmac.cu: kT (rows and columns of a work unit), kBK (spectra a stage)
CMAC_TILE = 128
CMAC_STAGE = 128


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


def cmac_units(n_chans: int, ap: int) -> list:
    """The CMAC kernel's work units in its order (``csrc/cmac.cu``):
    ``(k, bi, bj, kind)`` for channel k and the 128-row block bi, 128-column
    block bj of its plane, kind ``"diag"`` (bi == bj: every unit when ap
    <= 128), ``"upper"`` (vr only) or ``"lower"`` (vi only)."""
    nb = -(-ap // CMAC_TILE)
    return [(k, bi, bj, "diag" if bi == bj else
             ("upper" if bi < bj else "lower"))
            for k in range(n_chans) for bi in range(nb) for bj in range(nb)]


def cmac_plan_torch(acc: torch.Tensor, a2: torch.Tensor,
                    keep: int = 1) -> torch.Tensor:
    """The CMAC kernel's schedule as PyTorch ops on the CPU, for tests:
    ``acc = acc * keep + packed(a2)`` in place, computed as
    ``csrc/cmac.cu`` computes it, so that an index error in its plan shows
    here before it reaches the card.

    It walks :func:`cmac_units` (all channels of a kind of unit at once),
    reads each block through the tensor map's view ``(2K, ap, B)`` with
    rows past ap and spectra past B zero-filled, sums each warpgroup's
    products stage by stage in int64 (the kernel's int32 sums wrap the
    same way modulo 2**32), forms vi of a diagonal unit as W - W^T with W
    = Ai Ar^T (each W element above the diagonal written first to the
    place of its transpose in the staging tile, which starts full of
    stale values), and of a lower unit as Ai_I Ar_J^T - Ar_I Ai_J^T;
    selects the packed element; and adds the staged tile to the
    accumulator (``keep`` 1, the reduce-add) or stores it (0), clipped at
    ap."""
    if keep not in (0, 1):
        raise ValueError(f"keep must be 0 or 1, got {keep!r}")
    n_chans, tap, n_b = a2.shape
    ap, t, h = tap // 2, CMAC_TILE, CMAC_TILE // 2
    nb, n_st = -(-ap // t), -(-n_b // CMAC_STAGE)
    x = torch.zeros((n_chans, 2, nb * t, n_st * CMAC_STAGE),
                    dtype=torch.int64)
    x[:, :, :ap, :n_b] = a2.reshape(n_chans, 2, ap, n_b).to(torch.int64)
    gen = torch.Generator().manual_seed(ap * n_b)
    lower = torch.ones(t, t, dtype=torch.bool).tril(-1)  # r > c

    def stages(a, b):
        """A (k, m, S) . B (k, n, S)^T, one stage at a time."""
        out = 0
        for st in range(n_st):
            sl = slice(st * CMAC_STAGE, (st + 1) * CMAC_STAGE)
            out = out + torch.bmm(a[..., sl], b[..., sl].transpose(1, 2))
        return out

    for _, bi, bj, kind in cmac_units(1, ap):   # every channel at once
        ar, ai = (x[:, c, bi * t:(bi + 1) * t] for c in (0, 1))
        cr, ci = (x[:, c, bj * t:(bj + 1) * t] for c in (0, 1))
        stg = torch.randint(-2 ** 31, 2 ** 31, (n_chans, t, t),
                            generator=gen, dtype=torch.int64)
        if kind == "diag":
            # warpgroup 0, rows 0-63
            vr0 = stages(ar[:, :h], cr) + stages(ai[:, :h], ci)
            w00 = stages(ai[:, :h], cr[:, :h])
            # warpgroup 1, rows 64-127
            w1 = stages(ai[:, h:], cr)
            vr11 = stages(ar[:, h:], cr[:, h:]) + stages(ai[:, h:],
                                                         ci[:, h:])
            w01 = stages(ai[:, :h], cr[:, h:])
            # 1. W above the diagonal to the place of its transpose
            stg[:, :h, :h] = torch.where(lower[:h, :h],
                                         w00.transpose(1, 2), stg[:, :h, :h])
            stg[:, h:, :h] = w01.transpose(1, 2)
            stg[:, h:, h:] = torch.where(lower[h:, h:],
                                         w1[:, :, h:].transpose(1, 2),
                                         stg[:, h:, h:])
            # 2. the packed element
            tile = torch.empty_like(stg)
            tile[:, :h, :h] = torch.where(lower[:h, :h],
                                          w00 - stg[:, :h, :h],
                                          vr0[:, :, :h])
            tile[:, :h, h:] = vr0[:, :, h:]
            tile[:, h:, :h] = w1[:, :, :h] - stg[:, h:, :h]
            tile[:, h:, h:] = torch.where(lower[h:, h:],
                                          w1[:, :, h:] - stg[:, h:, h:],
                                          vr11)
        elif kind == "upper":
            tile = stages(ar, cr) + stages(ai, ci)
        else:   # each warpgroup: Ai_I Ar_J^T less Ar_I Ai_J^T by halves
            tile = stages(ai, cr) - torch.cat(
                [stages(ar, ci[:, :h]), stages(ar, ci[:, h:])], 2)
        # 3. the tensor store or reduce-add, clipped at ap
        rows = slice(bi * t, min((bi + 1) * t, ap))
        cols = slice(bj * t, min((bj + 1) * t, ap))
        got = tile[:, :rows.stop - rows.start, :cols.stop - cols.start]
        got = (got + 2 ** 31) % 2 ** 32 - 2 ** 31   # int32 wrap
        blk = acc[:, rows, cols]
        if keep:
            blk.add_(got.to(torch.int32))
        else:
            blk.copy_(got.to(torch.int32))
    return acc
