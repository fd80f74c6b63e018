#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's main path on one NVIDIA card.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments, one card).  It imports no jax.  Phases, each of which fails
the run (non-zero exit) when it fails:

1. build the three CUDA kernels from ``dc_sand_tpu_torch/csrc``, one
   nvcc per source, all started together;
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
   ``python -m dc_sand_tpu_torch.profile_step`` measures the numpy feed;
7. beam kernel (K4/K4p/K5) vs its plain version at the beam64 shape
   (64 ants x 2 pols, 256 spectra, 4096 channels, 16 beams): float beams
   >= 100 dB apart, the incoherent beam bitwise equal, and int8 beams at
   a scale that puts the rms of y*s near 30 LSB within 1 LSB with at
   most 1e-4 of the values flipped;
8. ``verify beam64`` at full width with verify's short cadence (16-spectra
   chunks, 4 chunks): beams and incoherent beam each >50 dB against the
   float64 golden chain;
9. beam64 at its own cadence: 8 chunks of 256 spectra made on the card
   from a seed, coarse + fractional delay and fringe on, 16 beams
   steered with the port's ``steering_weights``, outputs kept on the
   card; the F-engine and beam kernels' launch counters, zeroed just
   before, must each read 8.  It prints the device step, ``run()`` per
   chunk with device-resident chunks, and the device-to-host copy of
   one chunk's outputs.

The second-to-last line is ``{"kernels": [...]}`` (launches from phase 6
for the F-engine and the CMAC and from phase 9 for the beam kernel,
times from phases 2, 3 and 7); the last is
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
BEAMS, BEAM_SPECTRA = 16, 256
BEAM_SNR_DB = 100.0        # two float32 beamformers, summed in other orders
BEAM_QUANT_RMS = 30.0      # rms of y*s in LSB for the int8 epilogue check


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


def _snr_db(ref, got) -> float:
    """10 log10(sum |ref|^2 / sum |ref - got|^2), in float64 on the card."""
    ref, got = ref.double(), got.double()
    return float(10 * ((ref * ref).sum() / ((ref - got) ** 2).sum()).log10())


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
    from dc_sand_tpu_torch.ops.beamform import beamform
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused, taps_pad_for
    from dc_sand_tpu_torch.ops.xcorr import wire_to_a2, xcorr_accumulate_a2
    from dc_sand_tpu_torch.profile_step import (BEAM_CHUNKS, noise_int8,
                                                production_runner)
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
                                    zeros, zeros, runner.gains,
                                    runner.weights, False), 4)
    samples = a * p * cfg.chunk_samples
    print(f"[6 fx64 production] {n_chunks} chunks -> 1 dump of "
          f"{dumps[0].n_spectra} spectra; launches {launches}; first run "
          f"{first_s:.2f} s; steady run() per chunk {step_ms:.3f} ms = "
          f"{samples / step_ms / 1e6:.2f} Gsamp/s (device-resident chunks: "
          f"coarse shift on the card and dump included, host-to-device copy "
          f"excluded); device step {dev_step_ms:.3f} ms = "
          f"{samples / dev_step_ms / 1e6:.2f} Gsamp/s ({card})", flush=True)
    del runner, chunks, frames, zeros, dumps, vis
    torch.cuda.empty_cache()

    # ---- 7. beam kernel vs plain at the beam64 shape ----------------------
    q = noise_int8(gen, (FX64_STREAMS // 2, 2, BEAM_SPECTRA, nch, 2), dev)
    bw = torch.randn((BEAMS, FX64_STREAMS // 2, nch, 2), generator=gen,
                     device=dev)
    got, inc = beamform(q, bw, incoherent=True, impl="cuda")
    want, inc_w = beamform(q, bw, incoherent=True, impl="torch")
    beam_snr = _snr_db(want, got)
    beam_err = float((got - want).abs().max())
    inc_equal = torch.equal(inc, inc_w)
    qs = BEAM_QUANT_RMS / float(want.double().pow(2).mean().sqrt())
    got_q, _ = beamform(q, bw, quant_scale=qs, impl="cuda")
    want_q, _ = beamform(q, bw, quant_scale=qs, impl="torch")
    dq = (got_q.to(torch.int16) - want_q.to(torch.int16)).abs()
    q_max, q_flips = int(dq.max()), float((dq > 0).double().mean())
    beam_ms = _events_ms(
        torch, lambda: beamform(q, bw, incoherent=True, impl="cuda"), 10)
    beam_plain_ms = _events_ms(
        torch, lambda: beamform(q, bw, incoherent=True, impl="torch"), 2)
    tflops = 8 * BEAMS * 2 * BEAM_SPECTRA * nch * (FX64_STREAMS // 2) \
        / beam_ms / 1e9                   # 8 flops per complex MAC
    print(f"[7 beamform] float beams {beam_snr:.2f} dB vs plain (max |diff| "
          f"{beam_err:.3e}), incoherent bitwise {inc_equal}; int8 at "
          f"scale {qs:.5f}: max |diff| {q_max} LSB, flip fraction "
          f"{q_flips:.3e}; kernel {beam_ms:.3f} ms ({tflops:.2f} fp32 "
          f"TFLOP/s), plain {beam_plain_ms:.3f} ms ({card})", flush=True)
    if not (beam_snr >= BEAM_SNR_DB and inc_equal and q_max <= 1
            and q_flips <= MAX_FLIP_FRACTION):
        raise RuntimeError("beam kernel disagrees with its plain version")
    del q, bw, got, inc, want, inc_w, got_q, want_q, dq
    torch.cuda.empty_cache()

    # ---- 8. verify beam64 at full width against golden --------------------
    t = time.perf_counter()
    snrs, counters = verify_config("beam64", device=dev)
    print(f"[8 verify beam64] beams {snrs['beams']:.2f} dB, incoherent "
          f"{snrs['incoherent']:.2f} dB vs golden over {counters.chunks_in} "
          f"chunks ({time.perf_counter() - t:.1f} s)", flush=True)
    if not (snrs["beams"] > SNR_BOUND and snrs["incoherent"] > SNR_BOUND):
        raise RuntimeError(f"verify beam64: {snrs} not all > {SNR_BOUND}")

    # ---- 9. beam64 at its own cadence -------------------------------------
    cfg = get_config("beam64")
    runner, chunks = production_runner(cfg, gen, dev)
    n_chunks = len(chunks)
    outs = []
    torch.cuda.synchronize()
    fengine_fused.launches = 0
    beamform.launches = 0
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks,
               on_output=lambda i, o: outs.append(o))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    beam_launches = {"fengine": fengine_fused.launches,
                     "beamform": beamform.launches}
    if beam_launches != {"fengine": BEAM_CHUNKS, "beamform": BEAM_CHUNKS}:
        raise RuntimeError(f"launch counts {beam_launches}, want "
                           f"{BEAM_CHUNKS} each")
    b = cfg.spectra_per_chunk
    for o in outs:
        beams, inc = o["beams"], o["incoherent"]
        if (beams.shape != (BEAMS, 2, b, nch, 2) or inc.shape != (2, b, nch)
                or beams.dtype != torch.float32 or not beams.is_cuda):
            raise RuntimeError(f"beam outputs {beams.shape} {beams.dtype} "
                               f"{beams.device}, incoherent {inc.shape}")
        if (not torch.isfinite(beams).all() or (inc < 0).any()
                or not torch.equal(inc, torch.round(inc))):
            raise RuntimeError("beams not finite, or an incoherent value "
                               "is not a non-negative integer")
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    beam_run_ms = (time.perf_counter() - t) / n_chunks * 1e3
    frames = chunks[0].reshape(FX64_STREAMS, b, FX64_M)
    zeros = torch.zeros((FX64_STREAMS, b), device=dev)
    beam_step_ms = _events_ms(
        torch, lambda: runner._step(runner.history, runner.vis_acc, frames,
                                    zeros, zeros, runner.gains,
                                    runner.weights, False), 8)
    d2h_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        {k: v.cpu() for k, v in outs[-1].items()}
        d2h_ms.append((time.perf_counter() - t) * 1e3)
    samples = FX64_STREAMS * cfg.chunk_samples
    print(f"[9 beam64 production] {n_chunks} chunks of {b} spectra; "
          f"launches {beam_launches}; first run {first_s:.2f} s; device "
          f"step {beam_step_ms:.3f} ms = {samples / beam_step_ms / 1e6:.2f} "
          f"Gsamp/s; steady run() per chunk {beam_run_ms:.3f} ms = "
          f"{samples / beam_run_ms / 1e6:.2f} Gsamp/s (device-resident "
          f"chunks, outputs left on the card) ({card})", flush=True)
    out_mb = sum(v.numel() * v.element_size() for v in outs[-1].values()) / 1e6
    print(f"[9 beam64 outputs to host] one chunk's {out_mb:.1f} MB of beams "
          f"and incoherent beam, device-to-host copy into pageable memory: "
          + ", ".join(f"{x:.3f}" for x in d2h_ms) + f" ms ({card})",
          flush=True)

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
        {"name": "beamform", "route": "cuda",
         "source": "dc_sand_tpu_torch/csrc/beamform.cu",
         "replaces": "dc_sand_tpu/ops/beamform.py:147",
         "launches": beam_launches["beamform"], "max_abs_err": beam_err,
         "ms": beam_ms, "plain_ms": beam_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
