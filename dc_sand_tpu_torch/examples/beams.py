#!/usr/bin/env python
"""Worked example: tied-array beamforming toward two sky directions.

Simulates a 4-antenna array observing a point source on a known bearing,
then forms TWO coherent beams with the real streaming pipeline (fused
F-engine -> beam kernel): beam 0 steered AT the source (steering weights
from the geometric delays), beam 1 steered well off it.  The on-source
beam must gain the full coherent factor N^2 over the off-source beam at
the source's channel, and the incoherent sum (N * per-antenna power) sits
between them.  The shapes of ``examples/beams.py``.  Runs on the card, or
on the CPU with ``--cpu``::

    python -m dc_sand_tpu_torch.examples.beams [--chans 128] [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import ChainConfig
    from dc_sand_tpu_torch.models.steering import steering_weights
    from dc_sand_tpu_torch.ops._dispatch import default_device
    from dc_sand_tpu_torch.runtime import FXRunner
    from dc_sand_tpu_torch.windows import pfb_window

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chans", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = default_device("cpu" if args.cpu else None)

    n_ants, k0 = 4, args.chans // 3
    cfg = ChainConfig(name="beamdemo", n_ants=n_ants, n_pols=1,
                      n_chans=args.chans, n_taps=8, spectra_per_chunk=16,
                      apply_delay=False, apply_requant=True,
                      n_beams=2, incoherent_beam=True, quant_scale=0.01)
    m, fs = cfg.fft_size, cfg.sample_rate_hz

    # Source bearing: per-antenna geometric delays (seconds).  The coarse
    # part is tiny here, so the steering weights alone carry the phase
    # compensation.
    tau = np.array([0.0, 0.35, 0.8, 1.3]) / fs      # on-source delays
    tau_off = np.array([0.0, -2.1, 1.7, -0.6]) / fs  # some other bearing

    n_chunks = 3
    n = n_chunks * cfg.chunk_samples
    t = np.arange(n, dtype=np.float64)
    freq = k0 * fs / m
    rng = np.random.default_rng(0)
    # the wavefront arrives LATER at delayed antennas: x_a(t) = s(t - tau_a)
    sky = [80 * np.cos(2 * np.pi * freq * (t / fs - d)) +
           rng.normal(0, 5, n) for d in tau * 1.0]
    stream = golden.quantize_adc(np.stack(sky)[:, None, :])

    # beam 0 at the source, beam 1 elsewhere
    w = steering_weights(np.stack([tau, tau_off]), cfg.n_chans, fs)

    runner = FXRunner(cfg, pfb_window(cfg.n_taps, m), weights=w, device=dev)
    outs = []
    runner.run(lambda i: stream[..., i * cfg.chunk_samples:
                                (i + 1) * cfg.chunk_samples],
               n_chunks, on_output=lambda i, o: outs.append(
                   {k: v.cpu().numpy() for k, v in o.items()}))

    # steady-state chunk (no cold-start history)
    beams = outs[-1]["beams"]        # (beam, pol, B, K, 2) float32
    inc = outs[-1]["incoherent"]     # (pol, B, K)
    p_on = float(np.mean(beams[0, 0, :, k0, 0] ** 2
                         + beams[0, 0, :, k0, 1] ** 2))
    p_off = float(np.mean(beams[1, 0, :, k0, 0] ** 2
                          + beams[1, 0, :, k0, 1] ** 2))
    p_inc = float(np.mean(inc[0, :, k0]))
    print(f"tone channel {k0} ({dev}):")
    print(f"  on-source beam power : {p_on:12.1f}")
    print(f"  incoherent sum (xN)  : {p_inc * n_ants:12.1f}")
    print(f"  off-source beam power: {p_off:12.1f}")
    gain = p_on / max(p_off, 1e-9)
    print(f"  on/off beam gain: {gain:.1f}x (>= N={n_ants}x means "
          "coherent; off-source phasors can cancel below the incoherent "
          "floor)")
    # full coherence: on-source beam power ~= N * incoherent sum
    ok = p_on > 0.8 * n_ants * p_inc and gain > n_ants
    print("beam steering " + ("COHERENT" if ok else "NOT coherent"))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
