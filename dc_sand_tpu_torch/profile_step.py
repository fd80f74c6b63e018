"""Where the time of the fx64 and beam64 production steps goes, on one
CUDA card.

Run from the repository root::

    python -m dc_sand_tpu_torch.profile_step [--out DIR] [--runs NAMES]

For each run of ``--runs`` (default ``fx64,beam64,fx64_unfused``: fx64,
beam64 and fx64 through the unfused F-engine, the standalone FIR kernel
then PyTorch ops; ``fx64_mesh4`` is fx64 sharded over a 4-way fx mesh,
shard i on ``cuda:(i mod the card count)``, so that the corner-turn's
share of a sharded step shows; ``fx64_batched`` drives the windows with
``run_batched``, one CUDA-graph replay a window) it builds the
production runner (:func:`production_runner`: 64 ants x 2 pols, 4096 channels, the
config's own chunk length, coarse and fractional delay and fringe on,
seeded int8 noise made on the card; fx64 dumps 8192 spectra per 4
2048-spectra chunks, beam64 forms 16 steered beams and the incoherent
beam per 256-spectra chunk over :data:`BEAM_CHUNKS` chunks), warms it
over one window of chunks, then prints:

1. a ``torch.profiler`` trace of one window with device-resident chunks
   (beam outputs stay on the card): device time per kernel or copy name,
   and the device's idle share, ``1 - busy / wall``.  ``busy`` is the
   union of the device intervals in the trace (kernels, copies,
   memsets), so nested host-side ops are not counted twice;
2. fx64 only: the dump alone (``extract_vis`` and the device-to-host
   copy), host clock, three times;
3. ``run()`` (or ``run_batched``) fed with numpy chunks, so the
   pageable host-to-device copy of each chunk (2.15 GB for fx64, 268 MB
   for beam64) is paid, and that copy of one chunk alone.

The traces are written to ``DIR/<run>_trace.json`` (default
``build/profile_step``).
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from dc_sand_tpu_torch.config import ChainConfig, get_config
from dc_sand_tpu_torch.models.steering import steering_weights
from dc_sand_tpu_torch.ops.xcorr import extract_vis
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["noise_int8", "production_runner", "device_busy_us", "main",
           "BEAM_CHUNKS"]

# beam mode has no dump cadence: its window is a fixed count of chunks
BEAM_CHUNKS = 8

# trace categories of work that occupies the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def noise_int8(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Gaussian int8 noise (sigma 20) made with ``gen`` on ``device``, in
    slabs of the first axis (a float32 copy of a whole fx64 chunk is
    8.6 GB)."""
    out = torch.empty(shape, dtype=torch.int8, device=device)
    for i in range(0, shape[0], 16):
        blk = torch.randn((min(16, shape[0] - i),) + tuple(shape[1:]),
                          generator=gen, device=device)
        out[i:i + 16] = torch.clamp(torch.round(blk * 20.0),
                                    -127, 127).to(torch.int8)
    return out


def production_runner(cfg: ChainConfig, gen: torch.Generator, device,
                      fused: bool = True, mesh=None):
    """The runner at ``cfg``'s own cadence with a seeded delay model
    (coarse up to 31 samples, fractional delay and fringe on) and one
    window of chunks made with ``gen`` on ``device``: one dump's worth in
    fx mode, :data:`BEAM_CHUNKS` in beam mode, whose beams are steered
    toward seeded pointings (geometric delays up to 0.25 us):
    ``(runner, chunks)``.  ``fused`` picks the runner's F-engine path;
    with ``mesh`` (whose first shard's device must be ``device``) the
    runner is sharded over it."""
    rng = np.random.default_rng(6)
    a, p = cfg.n_ants, cfg.n_pols
    dm = DelayModel.zeros(a, p, max_delay=32)
    dm.d0 = rng.uniform(0.0, 31.0, (a, p))
    dm.d1 = rng.uniform(-1e-9, 1e-9, (a, p))
    dm.p0 = rng.uniform(-np.pi, np.pi, (a, p))
    dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    weights = None
    if cfg.n_beams:
        n_chunks = BEAM_CHUNKS
        weights = steering_weights(
            rng.uniform(-2.5e-7, 2.5e-7, (cfg.n_beams, a)), cfg.n_chans,
            cfg.sample_rate_hz)
    else:
        n_chunks = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    chunks = [noise_int8(gen, (a, p, cfg.chunk_samples), device)
              for _ in range(n_chunks)]
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                      delay_model=dm, weights=weights,
                      device=None if mesh is not None else device,
                      mesh=mesh, fused=fused)
    return runner, chunks


def device_busy_us(events) -> float:
    """Length of the union of the device intervals among chrome-trace
    ``events`` (``ts``/``dur`` in us, categories :data:`DEVICE_CATS`)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    return busy


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _profile(name: str, gen: torch.Generator, dev, out: Path) -> None:
    """Profile run ``name``: a config, then ``_unfused`` for the unfused
    F-engine, ``_mesh<N>`` for an N-way fx mesh or ``_batched`` for
    ``run_batched``."""
    config, _, variant = name.partition("_")
    cfg = get_config(config)
    mesh = None
    if variant.startswith("mesh"):
        n_cards = torch.cuda.device_count()
        mesh = build_mesh([torch.device("cuda", i % n_cards)
                           for i in range(int(variant[4:]))])
        dev = mesh.flat_devices[0]
    elif variant not in ("", "unfused", "batched"):
        raise SystemExit(f"unknown profile run {name!r}")
    runner, chunks = production_runner(cfg, gen, dev,
                                       fused=variant != "unfused", mesh=mesh)
    run = runner.run_batched if variant == "batched" else runner.run
    n = len(chunks)
    samples = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    run(lambda i: chunks[i % n], n)          # warm (and capture), one window

    # 1. one window under the profiler, device-resident chunks
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = _timed(lambda: run(lambda i: chunks[i % n], n))
    trace = out / f"{name}_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    busy_ms = device_busy_us(events) / 1e3
    per_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            per_name[e["name"]][0] += e["dur"] / 1e3
            per_name[e["name"]][1] += 1
    print(f"[{name} trace] {n} chunks, device-resident: wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms (union of intervals), idle "
          f"share {1 - busy_ms / wall_ms:.4f}")
    print(f"{'device ms per chunk':>20} {'share of wall':>14} "
          f"{'count':>6}  name")
    for item, (ms, cnt) in sorted(per_name.items(), key=lambda x: -x[1][0]):
        print(f"{ms / n:20.3f} {ms / wall_ms:14.4f} {cnt:6d}  {item[:90]}")

    # 2. the dump alone
    if runner.mode == "fx":
        dump_ms = [_timed(lambda: extract_vis(runner._acc_total(), cfg.n_ants,
                                              cfg.n_pols).contiguous().cpu())
                   for _ in range(3)]
        print(f"[{name} dump] extract_vis + device-to-host copy ms: "
              + ", ".join(f"{t:.3f}" for t in dump_ms))

    # 3. run() fed from numpy: a pageable host-to-device copy per chunk
    host = [c.cpu().numpy() for c in chunks]
    h2d_ms = _timed(lambda: torch.from_numpy(host[0]).to(dev))
    fed_ms = _timed(lambda: run(lambda i: host[i % n], n)) / n
    print(f"[{name} numpy feed] {run.__name__}() per chunk {fed_ms:.3f} ms = "
          f"{samples / fed_ms / 1e6:.3f} Gsamp/s; host-to-device copy of "
          f"one {host[0].nbytes / 1e9:.3f} GB chunk alone {h2d_ms:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_step",
                    help="directory for the traces")
    ap.add_argument("--runs", default="fx64,beam64,fx64_unfused",
                    help="comma-separated runs: a config name, with "
                         "_unfused, _mesh<N> (e.g. fx64_mesh4) or _batched")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in args.runs.split(","):
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        _profile(name, gen, dev, out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
