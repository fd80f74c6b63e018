"""Device-memory bandwidth microbenchmarks.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.membench`: what the card's
memory delivers for the access patterns the pipeline uses (streaming copy,
triad, int8 read -> float32 write, the F-engine's input conversion, and a
transpose, the local corner-turn), so that roofline shares elsewhere rest
on a measured ceiling.  The JAX package runs these as XLA ops, no Pallas
kernel, so here each is one plain PyTorch op writing into a preallocated
output (one read and one write pass per element).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dc_sand_tpu_torch.bench.harness import BenchResult, time_cuda
from dc_sand_tpu_torch.ops._dispatch import default_device

__all__ = ["bench_membench", "bench_h2d", "PATTERNS"]

PATTERNS = ("copy", "triad", "int8_upcast", "transpose")


def bench_membench(pattern: str, *, mb: float = 256.0, iters: int = 64,
                   device=None) -> BenchResult:
    """Bandwidth of ``pattern`` over a working set of about ``mb`` MB."""
    dev = default_device(device)
    n = int(mb * 1e6 / 4)
    n -= n % (8 * 128)
    if pattern == "copy":
        x = torch.ones((n,), device=dev)
        y = torch.empty_like(x)
        fn = lambda: y.copy_(x)  # noqa: E731
        bytes_moved = 2 * n * 4
    elif pattern == "triad":
        x = torch.ones((n,), device=dev)
        y = torch.empty_like(x)
        one = torch.ones((), device=dev)
        fn = lambda: torch.add(one, x, alpha=2.0, out=y)  # noqa: E731
        bytes_moved = 2 * n * 4
    elif pattern == "int8_upcast":
        x = torch.ones((4 * n,), dtype=torch.int8, device=dev)
        y = torch.empty((4 * n,), device=dev)
        fn = lambda: torch.mul(x, 0.5, out=y)  # noqa: E731
        bytes_moved = 4 * n * 1 + 4 * n * 4
    elif pattern == "transpose":
        # both orientations read, one written: the largest 1024-aligned
        # square side with side^2 float32 <= mb
        side = int((mb * 1e6 / 4) ** 0.5)
        side = max(side - side % 1024, 1024)
        x = torch.ones((side, side), device=dev)
        y = torch.empty_like(x)
        fn = lambda: torch.add(x.t(), x, out=y)  # noqa: E731
        bytes_moved = 3 * side * side * 4
    else:
        raise ValueError(f"unknown pattern {pattern!r}; choose {PATTERNS}")
    wall = time_cuda(fn, warmup=2, iters=iters, device=dev)
    return BenchResult(
        name=f"membench_{pattern}",
        metric=f"{pattern} bandwidth", value=bytes_moved / wall / 1e9,
        unit="GB/s", wall_s=wall, bytes_moved=bytes_moved,
    ).finish(dev)


def bench_h2d(mb: float = 64.0, iters: int = 8, device=None) -> BenchResult:
    """Host-to-device feed bandwidth of int8 chunks of ``mb`` MB: from
    pageable numpy memory, as ``jax.device_put`` does in the JAX file (the
    record's value), and, on a card, from pinned memory with
    ``non_blocking`` copies, as the ingest feeds the card
    (``extra["pinned_gb_s"]``, ``extra["pinned_wall_s"]``; None on the
    CPU).  Host clock around the copies and a synchronise."""
    dev = default_device(device)
    n = int(mb * 1e6)
    host = [np.random.default_rng(i).integers(-100, 100, n, dtype=np.int8)
            for i in range(iters)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def per_copy(srcs, **kw) -> float:
        srcs[0].to(dev, copy=True, **kw)       # warm one transfer
        sync()
        t = time.perf_counter()
        outs = [s.to(dev, copy=True, **kw) for s in srcs]
        sync()
        del outs
        return (time.perf_counter() - t) / iters

    wall = per_copy([torch.from_numpy(h) for h in host])
    pinned_wall = None
    if dev.type == "cuda":
        pinned = [torch.from_numpy(h).pin_memory() for h in host]
        pinned_wall = per_copy(pinned, non_blocking=True)
    return BenchResult(
        name="membench_h2d", metric="host->device bandwidth",
        value=n / wall / 1e9, unit="GB/s", wall_s=wall, bytes_moved=n,
        extra={"pinned_gb_s": n / pinned_wall / 1e9 if pinned_wall else None,
               "pinned_wall_s": pinned_wall},
    ).finish(dev)
