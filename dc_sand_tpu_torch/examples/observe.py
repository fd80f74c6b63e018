#!/usr/bin/env python
"""Worked example: a miniature interferometric observation.

Simulates a 4-antenna array observing a sky tone through per-antenna
geometric delays, runs the real streaming pipeline (host coarse delay,
fused F-engine writing the CMAC operand, X-engine) on 8-spectra chunks,
as ``examples/observe.py``, and fringe-stops: with the delay model engaged
the cross-correlation phases collapse to ~0.  Runs on the card, or on the
CPU with ``--cpu``::

    python -m dc_sand_tpu_torch.examples.observe [--chans 128] [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import ChainConfig
    from dc_sand_tpu_torch.golden.chain import baseline_pairs
    from dc_sand_tpu_torch.ops._dispatch import default_device
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    from dc_sand_tpu_torch.windows import pfb_window

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chans", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = default_device("cpu" if args.cpu else None)

    n_ants, k0 = 4, args.chans // 3
    cfg = ChainConfig(name="demo", n_ants=n_ants, n_pols=1,
                      n_chans=args.chans, n_taps=8, spectra_per_chunk=8,
                      n_spectra_per_acc=32, apply_delay=True,
                      apply_requant=True, run_xengine=True,
                      quant_scale=0.005)
    m = cfg.fft_size
    fs = cfg.sample_rate_hz
    geometric = np.array([0.0, 3.4, 7.9, 12.25])  # samples toward source

    # Sky signal: each antenna sees the wavefront advanced by its delay.
    n_chunks = 4
    n = n_chunks * cfg.chunk_samples
    t = np.arange(n, dtype=np.float64)
    freq = k0 * fs / m
    rng = np.random.default_rng(0)
    sky = [90 * np.cos(2 * np.pi * freq * (t + d) / fs) +
           rng.normal(0, 4, n) for d in geometric]
    stream = golden.quantize_adc(np.stack(sky)[:, None, :])

    dm = DelayModel.zeros(n_ants, 1, max_delay=16)
    dm.d0 = geometric.reshape(n_ants, 1)

    runner = FXRunner(cfg, pfb_window(cfg.n_taps, m), delay_model=dm,
                      device=dev)
    dumps, counters = runner.run(
        lambda i: stream[..., i * cfg.chunk_samples:
                         (i + 1) * cfg.chunk_samples], n_chunks)
    print(f"streamed {counters.samples_in} samples in "
          f"{counters.chunks_in} chunks of {cfg.spectra_per_chunk} spectra "
          f"-> {counters.dumps} dump(s) ({dev})")

    vis = dumps[-1].vis
    pairs = baseline_pairs(n_ants)
    print(f"\ntone channel {k0}: cross-correlation after fringe stopping")
    print(f"{'baseline':>9} {'|V|':>10} {'phase (rad)':>12}")
    for b, (i, j) in enumerate(pairs):
        v = vis[b, 0, 0, k0, 0] + 1j * vis[b, 0, 0, k0, 1]
        tag = "auto " if i == j else "cross"
        print(f"{tag} {i}-{j}: {abs(v):10.0f} {np.angle(v):12.4f}")
    cross = [vis[b, 0, 0, k0, 0] + 1j * vis[b, 0, 0, k0, 1]
             for b, (i, j) in enumerate(pairs) if i != j]
    worst = max(abs(np.angle(v)) for v in cross)
    ok = worst < 0.05
    print(f"\nworst cross phase: {worst:.4f} rad -> "
          f"{'fringes stopped' if ok else 'NOT stopped'}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
