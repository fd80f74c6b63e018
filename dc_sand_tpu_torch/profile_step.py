"""Where the time of the fx64 production step goes, on one CUDA card.

Run from the repository root::

    python -m dc_sand_tpu_torch.profile_step [--out DIR]

It builds the fx64 production runner (64 ants x 2 pols, 4096 channels,
2048-spectra chunks, one 8192-spectra dump per 4 chunks, coarse and
fractional delay and fringe on, seeded int8 noise made on the card),
warms it with one dump, then prints:

1. a ``torch.profiler`` trace of one dump window (4 chunks) with
   device-resident chunks: device time per kernel or copy name, and the
   device's idle share, ``1 - busy / wall``.  ``busy`` is the union of
   the device intervals in the trace (kernels, copies, memsets), so
   nested host-side ops are not counted twice;
2. the dump alone (``extract_vis`` and the device-to-host copy), host
   clock, three times;
3. ``run()`` fed with numpy chunks, so the pageable host-to-device copy
   of each 2.15 GB chunk is paid, and that copy of one chunk alone.

The trace is written to ``DIR/trace.json`` (default
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

from dc_sand_tpu.config import ChainConfig, get_config
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch.ops.xcorr import extract_vis
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner

__all__ = ["noise_int8", "production_runner", "device_busy_us", "main"]

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


def production_runner(cfg: ChainConfig, gen: torch.Generator, device):
    """The fx runner at ``cfg``'s own cadence with a seeded delay model
    (coarse up to 31 samples, fractional delay and fringe on) and one
    dump window of chunks made with ``gen`` on ``device``:
    ``(runner, chunks)``."""
    rng = np.random.default_rng(6)
    a, p = cfg.n_ants, cfg.n_pols
    dm = DelayModel.zeros(a, p, max_delay=32)
    dm.d0 = rng.uniform(0.0, 31.0, (a, p))
    dm.d1 = rng.uniform(-1e-9, 1e-9, (a, p))
    dm.p0 = rng.uniform(-np.pi, np.pi, (a, p))
    dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    n_chunks = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    chunks = [noise_int8(gen, (a, p, cfg.chunk_samples), device)
              for _ in range(n_chunks)]
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                      delay_model=dm, device=device)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_step",
                    help="directory for trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = get_config("fx64")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    runner, chunks = production_runner(cfg, gen, dev)
    n = len(chunks)
    samples = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    runner.run(lambda i: chunks[i % n], n)            # warm, one dump

    # 1. one dump window under the profiler, device-resident chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = _timed(lambda: runner.run(lambda i: chunks[i % n], n))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    busy_ms = device_busy_us(events) / 1e3
    per_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            per_name[e["name"]][0] += e["dur"] / 1e3
            per_name[e["name"]][1] += 1
    print(f"[trace] {n} chunks, device-resident: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (union of intervals), idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    print(f"{'device ms per chunk':>20} {'share of wall':>14} "
          f"{'count':>6}  name")
    for name, (ms, cnt) in sorted(per_name.items(), key=lambda x: -x[1][0]):
        print(f"{ms / n:20.3f} {ms / wall_ms:14.4f} {cnt:6d}  {name[:90]}")

    # 2. the dump alone
    dump_ms = [_timed(lambda: extract_vis(runner.vis_acc, cfg.n_ants,
                                          cfg.n_pols).contiguous().cpu())
               for _ in range(3)]
    print("[dump] extract_vis + device-to-host copy ms: "
          + ", ".join(f"{t:.3f}" for t in dump_ms))

    # 3. run() fed from numpy: a pageable host-to-device copy per chunk
    host = [c.cpu().numpy() for c in chunks]
    h2d_ms = _timed(lambda: torch.from_numpy(host[0]).to(dev))
    fed_ms = _timed(lambda: runner.run(lambda i: host[i % n], n)) / n
    print(f"[numpy feed] run() per chunk {fed_ms:.3f} ms = "
          f"{samples / fed_ms / 1e6:.3f} Gsamp/s; host-to-device copy of "
          f"one {host[0].nbytes / 1e9:.2f} GB chunk alone {h2d_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
