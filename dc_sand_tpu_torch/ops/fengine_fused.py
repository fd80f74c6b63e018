"""Fused F-engine (kernel K1): FIR + FFT + phase + requant in one launch.

The CUDA kernel ``csrc/fengine.cu`` replaces the TPU kernel
``dc_sand_tpu/ops/fengine_fused.py:_kernel``.  Its plain PyTorch version,
:func:`fengine_fused_torch`, composes the per-stage ops (the plain
:func:`~dc_sand_tpu_torch.ops.pfb.pfb_fir`, then :func:`fengine_tail`:
``channelize -> fine_delay_fringe -> requantize``) in float32; the CPU
tests hold it to the JAX package's jnp arm, and the chip smoke holds the
kernel to it.

Input conventions: those of :mod:`dc_sand_tpu_torch.ops.pfb` (split I/O
with ``history`` ``(..., taps_pad, M)`` and the chunk's frames ``(..., B,
M)``, or one stream ``(..., T)``).

Output layouts, channels in natural order in each:

* ``layout="wire"`` (the default): ``(..., B, K, 2)``, int8 with
  ``gains`` and float32 without (the JAX package's float-output mode,
  config ``pfb1k``).  Fengine mode, beam mode and the bench read it;
* ``layout="wire_flat"``: the same bytes viewed ``(..., B, 2K)``, re/im
  pairs channel-major (``dc_sand_tpu/ops/fengine_fused.py:754``);
* ``layout="operand"`` (int8 only): ``(K, 2, S, pitch)`` with ``out[k, c,
  s, b] = wire[s, b, k, c]`` for ``b < B`` and zeros past B (S the leading
  dims flattened; ``pitch`` >= B, default B), the X-engine's stacked
  operand ``a2 = [Ar; Ai]`` of :mod:`dc_sand_tpu_torch.ops.xcorr` viewed
  as ``(K, 2S, pitch)``.  The fx path asks for the CMAC's pitch
  (:func:`~dc_sand_tpu_torch.ops.xcorr.cmac_pitch`, B rounded up to 16)
  and feeds it to the CMAC as it is, or on a mesh to the corner-turn's
  all-to-all, with no permute or pad between: the counterpart of the JAX
  package's ``layout="native"``.  The plain version is the wire output
  through :func:`~dc_sand_tpu_torch.ops.xcorr.wire_to_operand`.

The kernel's FFT is a plan of Stockham passes (:func:`fft_plan`) whose
twiddle tables are made here in float64; :func:`fft_plan_torch` runs the
same plan (radix order, twiddle indices, Stockham addressing, the
in-register DFT's stages) in PyTorch, for the tests only.  From M = 2048
the kernel's CTAs are persistent and walk tiles of 6 spectra;
:func:`k1_tiles` is that walk, :func:`k1_grid` the grid it is launched
with and :func:`k1_l2_bytes` the bytes its FIR reads from L2.

At M = 65536 (:data:`WIDE_FFT_SIZE`, the 32k-channel mode) a spectrum no
longer fits one CTA: a cluster of 8 holds a tile, each CTA an eighth of
every spectrum, and the kernel ``fengine_wide_kernel`` writes the wire
layout; the operand layout is that output transposed by a second kernel,
``fengine_wide_operand``.  :func:`check_fft_size` says which M the
kernels take.
:func:`fengine_wide_torch` runs its decomposition in PyTorch, for the
tests only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.ops.fft import channelize
from dc_sand_tpu_torch.ops.pfb import MAX_TAPS, frames_of, pfb_fir
from dc_sand_tpu_torch.ops.phase import fine_delay_fringe
from dc_sand_tpu_torch.ops.quant import requantize
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
from dc_sand_tpu_torch.utils.cplx import c2ri, ri2c

__all__ = ["fengine_fused", "fengine_fused_torch", "fengine_tail",
           "fft_plan", "fft_plan_torch", "k1_tiles", "k1_grid",
           "k1_l2_bytes", "check_fft_size", "fengine_wide_torch",
           "MAX_FFT_SIZE",
           "WIDE_FFT_SIZE", "LAYOUTS"]

# a CTA holds its spectra's M/2 <= 4096 values up to M = 8192; at M = 65536
# a cluster of 8 CTAs holds them, 4096 values of a spectrum each; no M
# between the two is taken (check_fft_size)
MAX_CTA_FFT_SIZE = 8192
WIDE_FFT_SIZE = 65536
WIDE_RADIX = 16   # csrc/fengine.cu: the pass across the cluster (kWideRadix)
MAX_FFT_SIZE = WIDE_FFT_SIZE   # the largest M the kernels take
LAYOUTS = ("wire", "wire_flat", "operand")
# csrc/fengine.cu: spectra a tile (kJ), the operand layout's cluster
# (kCluster), the least M whose tile fills a CTA (kPersistentM)
K1_TILE = 6
K1_CLUSTER = 8
K1_PERSISTENT_M = 2048


def _per_spectrum(v, lead, b_out, device):
    """Per-spectrum parameter broadcast to ``lead + (B,)``, flattened to
    ``(S, B)`` float32."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.broadcast_to(t, tuple(lead) + (b_out,)).reshape(
        -1, b_out).contiguous()


def fengine_fused(x: torch.Tensor, window, taps: int, n_chans: int, *,
                  history: torch.Tensor = None, frac_delay=None, phase=None,
                  gains=None, layout: str = "wire", pitch: int = None,
                  impl: str = "auto") -> torch.Tensor:
    """Fused F-engine; see the module docstring for the conventions.

    ``frac_delay``/``phase``: per spectrum, broadcastable to ``(..., B)``
    (no rotation when both are None).  ``gains``: ``(K, 2)`` float32
    re/im.  Returns int8 ``(..., B, K, 2)`` with gains, float32 ``(...,
    B, K, 2)`` spectra without, ``(..., B, 2K)`` with
    ``layout="wire_flat"``, or with ``layout="operand"`` (gains needed)
    int8 ``(K, 2, S, pitch)``, zeros past B.

    ``impl``: ``"auto"`` launches the kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"torch"`` names the plain version on
    either device.  Each kernel launch up to M = 8192 adds one to
    ``fengine_fused.launches`` (int8 output, either layout) or to
    ``fengine_fused.float_launches`` (float32 output); at M = 65536 each
    launch of its cluster kernel adds one to ``fengine_fused.wide_launches``
    and each of its operand transpose one to
    ``fengine_fused.wide_operand_launches``.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "operand" and gains is None:
        raise ValueError("the operand layout is int8: it needs gains")
    if resolve_impl(impl, x) == "torch":
        return fengine_fused_torch(x, window, taps, n_chans, history=history,
                                   frac_delay=frac_delay, phase=phase,
                                   gains=gains, layout=layout, pitch=pitch)
    m = 2 * n_chans
    lead, fa, fb, pad0, b_out = frames_of(x, history, taps, m)
    pitch = _pitch(pitch, b_out, layout)
    dev = x.device
    check_fft_size(m)
    wide = m == WIDE_FFT_SIZE
    if not 1 <= taps <= MAX_TAPS:
        raise ValueError(f"the F-engine kernel takes 1..{MAX_TAPS} taps, "
                         f"got {taps}")
    for name, t in (("chunk", x), ("history", history)):
        if t is None:
            continue
        if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int8 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    s = fa.shape[0]
    if not 1 <= s <= 65535:
        raise ValueError(f"the kernel takes 1..65535 streams, got {s}")
    w = torch.as_tensor(window, dtype=torch.float32, device=dev)
    if w.numel() != taps * m:
        raise ValueError(f"window must hold taps*M = {taps * m} values")
    w = w.reshape(taps, m).contiguous()
    g = None
    if gains is not None:
        g = torch.as_tensor(gains, dtype=torch.float32, device=dev)
        if g.shape != (n_chans, 2):
            raise ValueError(f"gains must be ({n_chans}, 2), got "
                             f"{tuple(g.shape)}")
        g = g.contiguous()
        if wide:   # the kernel reads bin k1 + 16 k2 at 2048 k1 + k2
            g = g.view(-1, WIDE_RADIX, 2).transpose(0, 1).contiguous()
    if frac_delay is None and phase is None:
        fd = ph = None
    else:
        fd = _per_spectrum(0.0 if frac_delay is None else frac_delay,
                           lead, b_out, dev)
        ph = _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev)
    operand = layout == "operand"
    shape = (n_chans, 2, s, pitch) if operand else (s, b_out, n_chans, 2)
    out = torch.empty(shape, device=dev,
                      dtype=torch.float32 if g is None else torch.int8)
    # at M = 65536 the kernel writes the wire layout, which a second kernel
    # transposes into the operand layout
    dst = torch.empty((s, b_out, n_chans, 2), device=dev, dtype=torch.int8) \
        if wide and operand else out
    split_tw, pass_tw = _tables(m, dev)
    lib = _build.library()
    with torch.cuda.device(dev):   # a launch needs its stream's device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dcs_fengine(
            fa.data_ptr(), (fb if fb is not None else fa).data_ptr(),
            w.data_ptr(), split_tw.data_ptr(), pass_tw.data_ptr(),
            None if fd is None else fd.data_ptr(),
            None if ph is None else ph.data_ptr(),
            None if g is None else g.data_ptr(), dst.data_ptr(), s,
            fa.shape[1], 0 if fb is None else fb.shape[1], b_out, m, taps,
            pad0, int(operand and not wide), pitch, stream)
        _build.check(err, "dcs_fengine")
        if dst is not out:
            _build.check(lib.dcs_fengine_operand(
                dst.data_ptr(), out.data_ptr(), s, b_out, n_chans, pitch,
                stream), "dcs_fengine_operand")
    if wide:
        fengine_fused.wide_launches += 1
        fengine_fused.wide_operand_launches += dst is not out
    elif g is None:
        fengine_fused.float_launches += 1
    else:
        fengine_fused.launches += 1
    if operand:
        return out
    return _wire(out, lead, layout)


fengine_fused.launches = 0
fengine_fused.float_launches = 0
fengine_fused.wide_launches = 0
fengine_fused.wide_operand_launches = 0


def check_fft_size(m: int) -> None:
    """Raises ValueError unless the kernels take FFT size ``m``: a power
    of two in [32, :data:`MAX_CTA_FFT_SIZE`] (a spectrum in one CTA) or
    :data:`MAX_FFT_SIZE` (across a cluster of 8 CTAs)."""
    if m != MAX_FFT_SIZE and (m < 32 or m & (m - 1)
                              or m > MAX_CTA_FFT_SIZE):
        raise ValueError(
            f"the F-engine kernel takes M = 2*n_chans a power of two in [32, "
            f"{MAX_CTA_FFT_SIZE}] (a spectrum's M/2 values in one CTA's "
            f"shared memory) or {MAX_FFT_SIZE} (across a cluster of 8 "
            f"CTAs), got {m}")


def _pitch(pitch, b_out: int, layout: str) -> int:
    """The operand layout's spectra a row (default ``b_out``)."""
    if pitch is None:
        return b_out
    if layout != "operand" or pitch < b_out:
        raise ValueError(f"pitch takes the operand layout and at least its "
                         f"{b_out} spectra, got {pitch} ({layout})")
    return int(pitch)


def _wire(res: torch.Tensor, lead, layout: str) -> torch.Tensor:
    """Wire spectra ``(S, B, K, 2)`` with the leading dims ``lead`` back,
    ``(..., B, K, 2)``, or viewed ``(..., B, 2K)`` for ``"wire_flat"``."""
    b, k = res.shape[-3], res.shape[-2]
    tail = (b, 2 * k) if layout == "wire_flat" else (b, k, 2)
    return res.reshape(tuple(lead) + tail)


def _units(n_streams: int, n_out: int, operand: bool, m: int) -> tuple:
    """``(units, per)``: the walk's units and the CTAs a unit takes, a
    (stream, tile) each or, in the operand layout, a (stream, group of
    :data:`K1_CLUSTER` consecutive tiles) a cluster; at M = 65536 a
    (stream, tile) a cluster, in both layouts."""
    tiles = -(-n_out // K1_TILE)
    if m == WIDE_FFT_SIZE:
        return n_streams * tiles, K1_CLUSTER
    if operand:
        return n_streams * -(-tiles // K1_CLUSTER), K1_CLUSTER
    return n_streams * tiles, 1


def k1_grid(n_streams: int, n_out: int, resident: int,
            operand: bool, m: int = MAX_CTA_FFT_SIZE) -> int:
    """The persistent kernel's grid at FFT size ``m``: the CTAs the card
    holds at once (``resident``, whole clusters in the operand layout and at
    M = 65536), no more than the call has units."""
    units, per = _units(n_streams, n_out, operand, m)
    return min(units, resident // per) * per


def k1_tiles(n_streams: int, n_out: int, grid: int,
             operand: bool, m: int = MAX_CTA_FFT_SIZE) -> list:
    """The persistent kernel's walk (``csrc/fengine.cu:walk_tile``): for
    each of the ``grid`` CTAs, the ``(stream, first spectrum)`` of its
    tiles in order.  CTA b takes units b, b + G, ... of the grid's G;
    in the operand layout cluster c = b // 8 takes units c, c + G/8, ...
    and its CTA of rank b % 8 the group's tile of that rank, whose first
    spectrum lies past ``n_out`` where the stream's tiles end (a tile of no
    spectra: its runs are zeros).  At M = 65536 (``fengine_wide_kernel``,
    either layout) cluster c takes tiles c, c + G/8, ... and every CTA of
    it the same tile, each an eighth of its spectra."""
    units, per = _units(n_streams, n_out, operand, m)
    if grid < per or grid % per:
        raise ValueError(f"the grid takes whole clusters of {per} CTAs, "
                         f"got {grid}")
    tiles = -(-n_out // K1_TILE)
    groups = -(-tiles // K1_CLUSTER)
    walk = []
    for b in range(grid):
        steps = []
        for v in range(b // per, units, grid // per):
            if operand and m != WIDE_FFT_SIZE:
                s, g = divmod(v, groups)
                steps.append((s, (g * K1_CLUSTER + b % K1_CLUSTER) * K1_TILE))
            else:
                s, t = divmod(v, tiles)
                steps.append((s, t * K1_TILE))
        walk.append(steps)
    return walk


def k1_l2_bytes(n_streams: int, n_out: int, m: int, taps: int) -> int:
    """The bytes the kernel's FIR reads from L2 for a call, as its design
    counts them: each tile of ``n`` spectra the whole ``(taps, M)`` float32
    window and its ``n + taps - 1`` frames of M bytes (at M = 65536 each of
    the cluster's 8 CTAs reads an eighth of the columns of both)."""
    full, last = divmod(n_out, K1_TILE)
    frames = full * (K1_TILE + taps - 1) + (last + taps - 1 if last else 0)
    tiles = full + bool(last)
    return n_streams * (tiles * taps * m * 4 + frames * m)


def fft_plan(n: int) -> tuple:
    """The kernel's plan for its N-point complex FFT (N a power of two):
    one ``(R, Ns, offset)`` per Stockham pass, radix-16 passes then one of
    radix ``2**(log2 N mod 4)``.  ``Ns`` is the product of the earlier
    radices; a pass with ``Ns > 1`` reads its twiddle ``W_{Ns R}^{(j mod
    Ns) r}`` at ``offset + (r - 1) * Ns + j mod Ns`` of the pass table
    (``csrc/fengine.cu`` derives the same plan)."""
    plan, ns, off, left = [], 1, 0, int(n).bit_length() - 1
    while left > 0:
        r = 1 << min(left, 4)
        plan.append((r, ns, off))
        if ns > 1:
            off += (r - 1) * ns
        ns *= r
        left -= 4
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _tables_np(m: int) -> tuple:
    """``(split, passes)`` complex64, made in float64: ``W_M^k`` for ``k <
    M/2`` (the real FFT's split) and the Stockham pass twiddles of
    :func:`fft_plan` (at least one value, so the pointer is never null).
    At M = 65536 (bin ``k = k1 + 16 k2`` of sub-sequence k1 < 16, k2 <
    2048) ``split`` is in the sub-sequences' order, ``W_M^k`` at ``2048 k1
    + k2``, and ``passes`` holds the table of the 2048-point plan that each
    CTA of the cluster runs, then the cluster's twiddles ``W_N^(n2 k1)`` for
    k1 = 1..15 and n2 < 2048, row k1 - 1 after the plan's 2032."""
    n = m // 2
    split = np.exp(-2j * np.pi * np.arange(n) / m)
    if m == WIDE_FFT_SIZE:
        sub = n // WIDE_RADIX
        split = split.reshape(sub, WIDE_RADIX).T.ravel()
        k1, n2 = np.meshgrid(np.arange(1, WIDE_RADIX), np.arange(sub),
                             indexing="ij")
        cross = np.exp(-2j * np.pi * (k1 * n2) / n).ravel()
        passes = np.concatenate([_tables_np(2 * sub)[1], cross])
        return split.astype(np.complex64), passes.astype(np.complex64)
    parts = [np.ones(1)]
    for r, ns, _ in fft_plan(n):
        if ns > 1:
            rr, jm = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
            parts.append(np.exp(-2j * np.pi * (jm * rr) / (ns * r)).ravel())
    passes = np.concatenate(parts[1:]) if len(parts) > 1 else parts[0]
    return split.astype(np.complex64), passes.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _tables(m: int, device: torch.device) -> tuple:
    """:func:`_tables_np` as float32 (re, im) pairs on ``device``."""
    return tuple(torch.from_numpy(np.stack([t.real, t.imag], -1)).to(device)
                 for t in _tables_np(m))


def _dft_regs(v: torch.Tensor) -> torch.Tensor:
    """The kernel's in-register R-point DFT over the last axis: radix-2
    decimation-in-frequency stages, then the bit reversal."""
    r = v.shape[-1]
    x = list(v.unbind(-1))
    span = r // 2
    while span >= 1:
        for i0 in range(0, r, 2 * span):
            for k in range(span):
                a, b = x[i0 + k], x[i0 + k + span]
                x[i0 + k] = a + b
                x[i0 + k + span] = (a - b) * np.exp(-2j * np.pi * k / (2 * span))
        span //= 2
    bits = r.bit_length() - 1
    rev = [int(f"{k:0{bits}b}"[::-1], 2) if bits else 0 for k in range(r)]
    return torch.stack([x[i] for i in rev], -1)


def _stockham(z: torch.Tensor, passes: torch.Tensor) -> torch.Tensor:
    """The kernel's complex FFT of ``z`` over its last axis: the Stockham
    passes of :func:`fft_plan`, twiddles from ``passes`` (the plan's
    table, in ``z``'s dtype), each butterfly the in-register DFT."""
    n = z.shape[-1]
    for r, ns, off in fft_plan(n):
        per = n // r
        j = torch.arange(per)
        jm = j % ns
        rr = torch.arange(r)
        v = z[..., j[:, None] + rr[None, :] * per]            # (..., per, R)
        if ns > 1:
            idx = off + (rr[None, 1:] - 1) * ns + jm[:, None]
            tw = torch.cat([torch.ones(per, 1, dtype=z.dtype),
                            passes[idx]], 1)
            v = v * tw
        out = torch.empty_like(z)
        out[..., ((j - jm) * r + jm)[:, None] + rr[None, :] * ns] = \
            _dft_regs(v).to(z.dtype)
        z = out
    return z


def _split(z: torch.Tensor, split: torch.Tensor) -> torch.Tensor:
    """The real FFT's bins k < N from the packed complex FFT ``z`` (..., N):
    ``E[k] + W_M^k O[k]``, as the kernel's epilogue forms them."""
    n = z.shape[-1]
    k = torch.arange(n)
    a, b = z, z[..., (n - k) % n]
    e = torch.complex(0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag))
    o = torch.complex(0.5 * (a.imag + b.imag), -0.5 * (a.real - b.real))
    return e + split * o


def fft_plan_torch(y: torch.Tensor) -> torch.Tensor:
    """The kernel's real FFT of ``y (..., M)`` float64 as PyTorch ops, in
    complex128 with its float32 twiddle tables: the packed complex FFT of
    :func:`fft_plan`'s Stockham passes, then the split.  Returns the first
    M/2 bins (``torch.fft.rfft`` without the Nyquist bin).  For tests."""
    m = y.shape[-1]
    split, passes = (torch.from_numpy(t.astype(np.complex128))
                     for t in _tables_np(m))
    z = torch.complex(y[..., 0::2], y[..., 1::2])
    return _split(_stockham(z, passes), split)


def fengine_wide_torch(x: torch.Tensor, window, taps: int, n_chans: int, *,
                       history: torch.Tensor = None, frac_delay=None,
                       phase=None, gains=None) -> tuple:
    """The M = 65536 kernel's arithmetic as PyTorch ops, in float32 and
    complex64 with its tables, in its decomposition and order: the FIR of
    each output in tap order; the packed spectrum ``z[n2 + 2048 q]`` as 16
    sub-sequences q (two a CTA); the radix-16 in-register DFT over q and
    the twiddle ``W_N^(n2 k1)``; :func:`fft_plan`'s 2048-point passes on
    each sub-sequence k1, which leave bin ``k = k1 + 16 k2`` at ``k2``; the
    split; the phasor as the product of its two float64-made table values,
    ``exp(i ((-(2 pi / M)) (k1 + 1024 kh) d - p))`` and ``exp(i (-(2 pi /
    M)) 16 kl d)`` for ``k2 = 64 kh + kl``; the gain.  Returns ``(wire,
    pre)``: the int8 wire spectra ``(..., B, K, 2)`` (float32 without
    gains) and the complex64 values before rounding.  For tests (the
    kernel is held to the float64 chain through it on the CPU)."""
    m = 2 * n_chans
    if m != WIDE_FFT_SIZE:
        raise ValueError(f"the wide route takes M = {WIDE_FFT_SIZE}, got {m}")
    lead, fa, fb, pad0, b_out = frames_of(x, history, taps, m)
    frames = fa if fb is None else torch.cat([fa, fb], 1)
    w = torch.as_tensor(window, dtype=torch.float32).reshape(taps, m)
    y = torch.zeros((frames.shape[0], b_out, m), dtype=torch.float32)
    for t in range(taps):
        y = y + w[t] * frames[:, pad0 + t:pad0 + t + b_out].to(torch.float32)
    n, r = m // 2, WIDE_RADIX
    sub = n // r
    split, passes = (torch.from_numpy(t) for t in _tables_np(m))
    split = split.reshape(r, sub).T.reshape(n)      # back to bin order
    plan = passes[:-(r - 1) * sub]
    cross = passes[-(r - 1) * sub:].reshape(r - 1, sub)
    z = torch.complex(y[..., 0::2], y[..., 1::2])
    # sub-sequence q holds z[n2 + 2048 q]; the DFT over q, then the twiddle
    v = _dft_regs(z.reshape(*z.shape[:-1], r, sub).transpose(-1, -2))
    v = v.to(torch.complex64).transpose(-1, -2)           # (..., k1, n2)
    v = torch.cat([v[..., :1, :], v[..., 1:, :] * cross], -2)
    # bin k1 + 16 k2 lies at k2 of sub-sequence k1
    spec = _split(_stockham(v, plan).transpose(-1, -2).reshape(
        *v.shape[:-2], n), split)
    if frac_delay is not None or phase is not None:
        d = _per_spectrum(0.0 if frac_delay is None else frac_delay, lead,
                          b_out, "cpu").double()[..., None]
        p = _per_spectrum(0.0 if phase is None else phase, lead, b_out,
                          "cpu").double()[..., None]
        scale, lo = -2.0 * np.pi / m, 64
        k = torch.arange(n)
        k1, k2 = k % r, k // r
        hi = torch.polar(torch.ones_like(d * k),
                         scale * (k1 + r * lo * (k2 // lo)) * d - p)
        lw = torch.polar(torch.ones_like(d * k), scale * r * (k2 % lo) * d)
        spec = spec * (hi.to(torch.complex64) * lw.to(torch.complex64))
    if gains is None:
        res = c2ri(spec)
        return res.reshape(tuple(lead) + res.shape[1:]), spec
    g = torch.as_tensor(gains, dtype=torch.float32)
    pre = spec * ri2c(g)
    res = torch.stack([torch.clamp(torch.round(pre.real), -127, 127),
                       torch.clamp(torch.round(pre.imag), -127, 127)],
                      -1).to(torch.int8)
    return res.reshape(tuple(lead) + res.shape[1:]), pre


def fengine_fused_torch(x: torch.Tensor, window, taps: int, n_chans: int, *,
                        history: torch.Tensor = None, frac_delay=None,
                        phase=None, gains=None, layout: str = "wire",
                        pitch: int = None) -> torch.Tensor:
    """Plain version of the fused F-engine: the plain FIR, then
    :func:`fengine_tail`, as separate float32 PyTorch ops on the same
    conventions; ``layout="operand"`` permutes the wire result into rows of
    ``pitch`` spectra, zeros past B."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    fir = pfb_fir(x, window, taps, 2 * n_chans, history=history,
                  impl="torch")
    res = fengine_tail(fir, n_chans, frac_delay=frac_delay, phase=phase,
                       gains=gains)
    pitch = _pitch(pitch, res.shape[-3], layout)
    if layout == "operand":
        return wire_to_operand(res, pitch)
    return _wire(res, res.shape[:-3], layout)


def fengine_tail(fir: torch.Tensor, n_chans: int, *, frac_delay=None,
                 phase=None, gains=None) -> torch.Tensor:
    """The F-engine after the FIR, on FIR output ``(..., B, M)`` float32:
    rfft, the fine-delay/fringe phasor (when ``frac_delay`` or ``phase``
    is given, per spectrum, broadcastable to ``(..., B)``), then the gain
    and requantisation to int8 ``(..., B, K, 2)``, or float32 ``(..., B,
    K, 2)`` spectra when ``gains`` is None."""
    lead, b_out = fir.shape[:-2], fir.shape[-2]
    spec = channelize(fir.reshape(-1, b_out, fir.shape[-1]), n_chans)
    if frac_delay is not None or phase is not None:
        dev = fir.device
        spec = fine_delay_fringe(
            spec, _per_spectrum(0.0 if frac_delay is None else frac_delay,
                                lead, b_out, dev),
            _per_spectrum(0.0 if phase is None else phase, lead, b_out, dev))
    if gains is None:
        res = c2ri(spec)
    else:
        g = torch.as_tensor(gains, dtype=torch.float32, device=fir.device)
        res = requantize(spec, ri2c(g))
    return res.reshape(tuple(lead) + res.shape[1:])
