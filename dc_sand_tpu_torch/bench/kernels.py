"""Per-kernel benchmarks: the X-engine CMAC, the beamformer, the FFT.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.kernels`.  Inputs are made
on the device from a seeded :class:`torch.Generator`; the byte and
operation counts are the JAX file's, and :meth:`BenchResult.finish` puts
the time beside the H100 bound of those counts and the int8 and fp32
rates beside their peaks.
"""

from __future__ import annotations

import math

import torch

from dc_sand_tpu_torch.bench.harness import BenchResult, time_cuda
from dc_sand_tpu_torch.golden.chain import baseline_pairs
from dc_sand_tpu_torch.ops._dispatch import default_device
from dc_sand_tpu_torch.ops.beamform import beamform
from dc_sand_tpu_torch.ops.fft import channelize
from dc_sand_tpu_torch.ops.fft_mxu import channelize_mxu
from dc_sand_tpu_torch.ops.xcorr import (acc_shape, extract_baselines,
                                         xcorr_accumulate,
                                         xcorr_accumulate_a2, xcorr_full)
from dc_sand_tpu_torch.profile_step import noise_int8

__all__ = ["bench_xcorr", "bench_beamform", "bench_fft"]


def _gen(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def bench_fft(n_chans: int = 1024, n_streams: int = 16,
              n_spectra: int = 512, iters: int = 64, device=None) -> list:
    """rfft implementations head to head at the channelizer shape, the JAX
    file's two entries: ``fft_torch_rfft``, the port's
    :func:`~dc_sand_tpu_torch.ops.fft.channelize` (``torch.fft.rfft``),
    and ``fft_mxu_matmul``, the matmul-formulated split of
    :func:`~dc_sand_tpu_torch.ops.fft_mxu.channelize_mxu` (float32,
    TF32 off).  Both plain PyTorch: the fx path runs its FFT inside the
    F-engine kernel."""
    dev = default_device(device)
    m = 2 * n_chans
    x = torch.randn((n_streams, n_spectra, m), generator=_gen(dev, 0),
                    device=dev) * 30
    samples = n_streams * n_spectra * m
    # 5 M log2 M real FLOPs per length-M rfft (the standard count), for
    # both: the matmul path trades them for dense-DFT MACs
    flops = 5 * samples * math.log2(m)
    out = []
    for name, fn in (("fft_torch_rfft", channelize),
                     ("fft_mxu_matmul", channelize_mxu)):
        wall = time_cuda(lambda: fn(x, n_chans), warmup=2, iters=iters,
                         device=dev)
        out.append(BenchResult(
            name=name, metric="FFT samples/s",
            value=samples / wall, unit="samp/s", wall_s=wall,
            bytes_moved=samples * 4 + samples // 2 * 8,
            extra={"n_chans": n_chans, "n_streams": n_streams,
                   "n_spectra": n_spectra, "impl": "torch"},
        ).finish(dev, fp32_ops=flops))
    return out


def bench_xcorr(n_ants: int = 64, n_pols: int = 2, n_chans: int = 4096,
                n_spectra: int = 256, iters: int = 64,
                mode: str = "accumulate", device=None) -> BenchResult:
    """X-engine CMAC throughput, baselines/s.

    ``mode="native"`` times
    :func:`~dc_sand_tpu_torch.ops.xcorr.xcorr_accumulate_a2` on its
    stacked ``(K, 2ap, B)`` operand, the kernel the port's fx step
    dispatches; ``"accumulate"`` times ``xcorr_accumulate`` on the
    channel-major wire operand ``(K, A, P, B, 2)``, its glue into the
    stacked operand included; ``"extract"`` times
    ``extract_baselines(xcorr_full(q))``, the port's counterpart of the
    JAX package's one-shot ``ops.xcorr``, plain PyTorch (recorded with
    ``impl: "torch"``).  The accumulator is read and written in place
    every call, as in the streaming step."""
    dev = default_device(device)
    gen = _gen(dev, 0)
    ap = n_ants * n_pols
    acc = torch.zeros(acc_shape(n_ants, n_pols, n_chans), dtype=torch.int32,
                      device=dev)
    if mode == "native":
        q = noise_int8(gen, (n_chans, 2 * ap, n_spectra), dev)
        fn = lambda: xcorr_accumulate_a2(acc, q)  # noqa: E731
    elif mode == "accumulate":
        q = noise_int8(gen, (n_chans, n_ants, n_pols, n_spectra, 2), dev)
        fn = lambda: xcorr_accumulate(acc, q)  # noqa: E731
    elif mode == "extract":
        q = noise_int8(gen, (n_chans, n_ants, n_pols, n_spectra, 2), dev)
        fn = lambda: extract_baselines(xcorr_full(q), n_ants,  # noqa: E731
                                       n_pols)
    else:
        raise ValueError(f"unknown mode {mode!r}; choose native, accumulate "
                         "or extract")
    wall = time_cuda(fn, warmup=2, iters=iters, device=dev)
    n_bl = len(baseline_pairs(n_ants))
    # complex MACs: the full ap x ap matrix per channel per spectrum (the
    # count the JAX file uses; the kernel computes the packed halves)
    cmacs = n_chans * ap * ap * n_spectra
    kept_cmacs = n_chans * n_bl * 4 * n_spectra
    out_bytes = (2 * acc.numel() * 4 if mode != "extract"
                 else n_bl * n_pols * n_pols * n_chans * 2 * 4)
    return BenchResult(
        name=f"xcorr_cmac_{mode}",
        metric="correlator baselines/s",
        value=n_bl * n_chans * n_spectra / wall,
        unit="baseline-chan-spectra/s", wall_s=wall,
        bytes_moved=q.numel() + out_bytes,
        extra={"cmac_per_s": cmacs / wall,
               "kept_cmac_per_s": kept_cmacs / wall,
               "mode": mode, "impl": "torch" if mode == "extract" else "cuda",
               "n_ants": n_ants, "n_chans": n_chans,
               "n_spectra": n_spectra},
    ).finish(dev, int8_ops=8 * cmacs)


def bench_beamform(n_beams: int = 16, n_ants: int = 64, n_pols: int = 2,
                   n_chans: int = 4096, n_spectra: int = 64,
                   iters: int = 128, quant_scale: float = 0.0,
                   layout: str = "wire", device=None) -> BenchResult:
    """Coherent beamformer throughput on the wire spectra ``(A, P, B, K,
    2)`` int8, float32 beams, or int8 beams from the kernel's epilogue
    with ``quant_scale > 0``.  The port has one layout, the wire layout
    (``layout="native"`` raises)."""
    if layout != "wire":
        raise ValueError(f"layout {layout!r}: the port has no native layout; "
                         "its beam kernel reads the wire spectra")
    dev = default_device(device)
    gen = _gen(dev, 0)
    q = noise_int8(gen, (n_ants, n_pols, n_spectra, n_chans, 2), dev)
    w = torch.randn((n_beams, n_ants, n_chans, 2), generator=_gen(dev, 1),
                    device=dev)
    wall = time_cuda(lambda: beamform(q, w, quant_scale=quant_scale),
                     warmup=2, iters=iters, device=dev)
    flops = 4 * 2 * n_beams * n_ants * n_pols * n_spectra * n_chans
    out_bytes = n_beams * n_pols * n_spectra * n_chans * 2 * (
        1 if quant_scale else 4)
    return BenchResult(
        name="beamform" + ("_int8" if quant_scale else "")
             + (f"_{n_beams}b" if n_beams != 16 else ""),
        metric="beamformed samples/s",
        value=n_beams * n_pols * n_spectra * n_chans / wall,
        unit="beam-samples/s", wall_s=wall,
        bytes_moved=q.numel() + w.numel() * 4 + out_bytes,
        extra={"n_beams": n_beams, "n_ants": n_ants, "n_chans": n_chans,
               "n_spectra": n_spectra, "layout": layout,
               "quant_scale": quant_scale},
    ).finish(dev, bf16_ops=flops)   # the tensor-core kernel's useful flops
