#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's main path on one NVIDIA card.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments, one card).  It imports no jax.  Phases, each of which fails
the run (non-zero exit) when it fails:

1. build both CUDA kernels with nvcc from ``dc_sand_tpu_torch/csrc``;
2. F-engine kernel (K1) vs its plain version at the fx64 chunk shape
   (128 streams x 2048 spectra x 8192 samples): every difference a
   single LSB, at most 1e-4 of the values, and each flip of the stream
   with the most lies within 1e-3 of a .5 rounding boundary of the
   float64 golden chain;
3. CMAC kernel (K2/K3) vs its plain version at the fx64 shape
   (K = 4096, ap = 128, B = 2048), keep 1 and 0: bitwise equal;
4. ``verify fx4`` at its full config through the port's runner: >50 dB
   against the float64 golden chain;
5. ``verify fx64`` at full width (64 ants x 2 pols, 4096 channels) with
   verify's short cadence (16-spectra chunks, 32-spectra dumps, every
   baseline graded): >50 dB;
6. fx64 at production cadence: 4 chunks of 2048 spectra, made on the
   card from a seed, coarse + fractional delay and fringe on, make one
   8192-spectra dump; both kernels' launch counters, zeroed just
   before, must each read 4.  The ``run()`` rate it prints is with the
   chunks already on the card (no host-to-device copy);
   ``python -m dc_sand_tpu_torch.profile_step`` measures the numpy feed.

The second-to-last line is ``{"kernels": [...]}`` (launches from phase
6, times from phases 2-3); the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

FX64_STREAMS, FX64_SPECTRA, FX64_M, TAPS = 128, 2048, 8192, 16
PLAIN_BLOCK_STREAMS = 16   # bounds the plain F-engine's float32 copies
MAX_FLIP_FRACTION = 1e-4   # measured on the H100: about 1e-5
FLIP_BOUNDARY_TOL = 1e-3   # a flip's float64 pre-round value to a .5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _events_ms(torch, fn, n):
    """Mean device time of ``fn`` over ``n`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA "
              "device, nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    from dc_sand_tpu import golden
    from dc_sand_tpu.config import get_config
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused, taps_pad_for
    from dc_sand_tpu_torch.ops.xcorr import wire_to_a2, xcorr_accumulate_a2
    from dc_sand_tpu_torch.profile_step import noise_int8, production_runner
    from dc_sand_tpu_torch.verify import SNR_BOUND, verify_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    # ---- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    print(f"[1 build] nvcc sm_90a, {time.perf_counter() - t:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            print("   ", line.strip(), flush=True)

    # ---- 2. F-engine kernel vs plain at the fx64 chunk shape --------------
    s, b, m, nch = FX64_STREAMS, FX64_SPECTRA, FX64_M, FX64_M // 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hist = noise_int8(gen, (s, TAPS, m), dev)
    chunk = noise_int8(gen, (s, b, m), dev)
    fd = torch.rand((s, b), generator=gen, device=dev) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=dev) - 0.5) * 2 * np.pi
    ang = torch.rand((nch,), generator=gen, device=dev) * 2 * np.pi
    gains = torch.stack([0.05 * torch.cos(ang), 0.05 * torch.sin(ang)], -1)
    window = torch.as_tensor(pfb_window(TAPS, m), dtype=torch.float32,
                             device=dev)
    kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)

    def k1():
        return fengine_fused(chunk, window, TAPS, nch, impl="cuda", **kw)

    got = k1()
    k1_ms = _events_ms(torch, k1, 5)

    def plain_blocks(compare):
        for i in range(0, s, PLAIN_BLOCK_STREAMS):
            sl = slice(i, i + PLAIN_BLOCK_STREAMS)
            want = fengine_fused(chunk[sl], window, TAPS, nch, history=hist[sl],
                                 frac_delay=fd[sl], phase=ph[sl], gains=gains,
                                 impl="torch")
            if compare is not None:
                compare(sl, want)

    stats = {"max": 0, "flips": torch.zeros(s, dtype=torch.int64)}

    def compare(sl, want):
        d = (got[sl].to(torch.int16) - want.to(torch.int16)).abs()
        stats["max"] = max(stats["max"], int(d.max()))
        stats["flips"][sl] = (d > 0).sum(dim=(1, 2, 3)).cpu()

    plain_blocks(compare)
    k1_plain_ms = _events_ms(torch, lambda: plain_blocks(None), 1)
    flip_frac = int(stats["flips"].sum()) / got.numel()
    print(f"[2 fengine] kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms "
          f"({PLAIN_BLOCK_STREAMS}-stream blocks), max |diff| {stats['max']} "
          f"LSB, flip fraction {flip_frac:.3e} ({card})", flush=True)
    if stats["max"] > 1 or flip_frac > MAX_FLIP_FRACTION:
        raise RuntimeError("F-engine kernel disagrees with its plain version")
    # certify the flips of the stream with the most: each must round a
    # float64 golden pre-round value within FLIP_BOUNDARY_TOL of a .5
    # boundary, where float32 FFTs summing in different orders may
    # round either way (a wrong rounding mode or phase flips elsewhere)
    w = int(torch.argmax(stats["flips"]))
    pad0 = taps_pad_for(TAPS) - TAPS + 1
    one = slice(w, w + 1)
    want = fengine_fused(chunk[one], window, TAPS, nch, history=hist[one],
                         frac_delay=fd[one], phase=ph[one], gains=gains,
                         impl="torch")
    diff = (got[one].to(torch.int16) - want.to(torch.int16)).cpu().numpy()
    x = torch.cat([hist[w, pad0:], chunk[w]]).reshape(1, -1).cpu().numpy()
    g = gains.double().cpu().numpy()
    pre = golden.f_engine(x, window.double().cpu().numpy(), TAPS, nch,
                          frac_delay=fd[one].double().cpu().numpy(),
                          phase=ph[one].double().cpu().numpy()) * (
                              g[:, 0] + 1j * g[:, 1])
    v = np.stack([pre.real, pre.imag], -1)[diff != 0]
    dist = np.abs(v - np.floor(v) - 0.5)
    print(f"[2 fengine] stream {w}: {v.size} flips, largest distance of a "
          f"flip's golden pre-round value from a .5 boundary "
          f"{dist.max(initial=0):.2e} (limit {FLIP_BOUNDARY_TOL})", flush=True)
    if (dist >= FLIP_BOUNDARY_TOL).any():
        raise RuntimeError("F-engine kernel flips a value away from a .5 "
                           "rounding boundary")
    ct_ms = _events_ms(torch, lambda: wire_to_a2(got), 5)
    print(f"[2 corner-turn glue] wire_to_a2 {ct_ms:.3f} ms for "
          f"{got.numel() / 1e9:.2f} GB ({card})", flush=True)
    del got, chunk, hist, fd, ph
    torch.cuda.empty_cache()

    # ---- 3. CMAC kernel vs plain at the fx64 shape ------------------------
    ap = FX64_STREAMS
    a2 = torch.randint(-127, 128, (nch, 2 * ap, b), generator=gen,
                       device=dev, dtype=torch.int8)
    acc0 = torch.randint(-2 ** 24, 2 ** 24, (nch, ap, ap), generator=gen,
                         device=dev, dtype=torch.int32)
    cmac_err = 0
    for keep in (1, 0):
        x, y = acc0.clone(), acc0.clone()
        xcorr_accumulate_a2(x, a2, keep=keep, impl="cuda")
        xcorr_accumulate_a2(y, a2, keep=keep, impl="torch")
        cmac_err = max(cmac_err, int((x.to(torch.int64) - y).abs().max()))
        if not torch.equal(x, y):
            raise RuntimeError(f"CMAC kernel != plain version (keep={keep}): "
                               f"{int((x != y).sum())} elements differ")
    scratch = acc0.clone()
    cmac_ms = _events_ms(
        torch, lambda: xcorr_accumulate_a2(scratch, a2, keep=0,
                                           impl="cuda"), 5)
    cmac_plain_ms = _events_ms(
        torch, lambda: xcorr_accumulate_a2(scratch, a2, keep=0,
                                           impl="torch"), 1)
    ops = 12 * 2 * 64 * 64 * b * nch   # 12 of the 16 64x64 tile products
    print(f"[3 cmac] bitwise equal (keep 1 and 0); kernel {cmac_ms:.3f} ms "
          f"({ops / cmac_ms / 1e9:.1f} int8 TOP/s executed), plain "
          f"{cmac_plain_ms:.3f} ms ({card})", flush=True)
    del a2, acc0, x, y, scratch
    torch.cuda.empty_cache()

    # ---- 4./5. verify fx4 and full-width fx64 against golden --------------
    for name in ("fx4", "fx64"):
        t = time.perf_counter()
        snrs, counters = verify_config(name, device=dev)
        snr = snrs["visibilities"]
        print(f"[verify {name}] visibilities {snr:.2f} dB vs golden over "
              f"{counters.dumps} dumps ({time.perf_counter() - t:.1f} s)",
              flush=True)
        if not snr > SNR_BOUND:
            raise RuntimeError(f"verify {name}: {snr:.2f} dB <= {SNR_BOUND}")

    # ---- 6. fx64 at production cadence ------------------------------------
    cfg = get_config("fx64")
    a, p = cfg.n_ants, cfg.n_pols
    runner, chunks = production_runner(cfg, gen, dev)
    n_chunks = len(chunks)
    torch.cuda.synchronize()
    fengine_fused.launches = 0
    xcorr_accumulate_a2.launches = 0
    t = time.perf_counter()
    dumps, counters = runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = {"fengine": fengine_fused.launches,
                "cmac": xcorr_accumulate_a2.launches}
    if launches != {"fengine": n_chunks, "cmac": n_chunks}:
        raise RuntimeError(f"launch counts {launches}, want {n_chunks} each")
    if len(dumps) != 1 or dumps[0].n_spectra != cfg.n_spectra_per_acc:
        raise RuntimeError(f"expected one {cfg.n_spectra_per_acc}-spectra "
                           f"dump, got {[d.n_spectra for d in dumps]}")
    vis = dumps[0].vis
    n_bl = a * (a + 1) // 2
    if vis.shape != (n_bl, p, p, cfg.n_chans, 2) or vis.dtype != np.int32:
        raise RuntimeError(f"dump shape {vis.shape} {vis.dtype}")
    pairs = golden.baseline_pairs(a)
    autos = np.flatnonzero(pairs[:, 0] == pairs[:, 1])
    for q in range(p):
        au = vis[autos, q, q]
        if au[..., 1].any() or (au[..., 0] < 0).any():
            raise RuntimeError("an autocorrelation is not real and >= 0")
    # steady state: the same chunks again, host clock around synchronised
    # work (coarse shift on the card, both kernels, the dump); the chunks
    # already sit on the card, so no host-to-device copy is paid
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_chunks * 1e3
    # the device step alone (F-engine kernel, corner-turn glue, CMAC
    # kernel, history carry), CUDA events over back-to-back steps
    frames = chunks[0].reshape(a * p, cfg.spectra_per_chunk, cfg.fft_size)
    zeros = torch.zeros((a * p, cfg.spectra_per_chunk), device=dev)
    dev_step_ms = _events_ms(
        torch, lambda: runner._step(runner.history, runner.vis_acc, frames,
                                    zeros, zeros, runner.gains, False), 4)
    samples = a * p * cfg.chunk_samples
    print(f"[6 fx64 production] {n_chunks} chunks -> 1 dump of "
          f"{dumps[0].n_spectra} spectra; launches {launches}; first run "
          f"{first_s:.2f} s; steady run() per chunk {step_ms:.3f} ms = "
          f"{samples / step_ms / 1e6:.2f} Gsamp/s (device-resident chunks: "
          f"coarse shift on the card and dump included, host-to-device copy "
          f"excluded); device step {dev_step_ms:.3f} ms = "
          f"{samples / dev_step_ms / 1e6:.2f} Gsamp/s ({card})", flush=True)

    assert "jax" not in sys.modules, "the port must not import jax"
    kernels = [
        {"name": "fengine", "route": "cuda",
         "source": "dc_sand_tpu_torch/csrc/fengine.cu",
         "replaces": "dc_sand_tpu/ops/fengine_fused.py:335",
         "launches": launches["fengine"], "max_abs_err": stats["max"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "cmac", "route": "cuda",
         "source": "dc_sand_tpu_torch/csrc/cmac.cu",
         "replaces": "dc_sand_tpu/ops/xcorr.py:371",
         "launches": launches["cmac"], "max_abs_err": cmac_err,
         "ms": cmac_ms, "plain_ms": cmac_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
