"""Collective microbenchmarks over a device mesh's fx axis.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.collectives`: what the
mesh delivers for the collectives the pipeline uses, the corner-turn's
all-to-all, the halo ring, the beam sums and a gather.  The JAX names of
:data:`COLLECTIVES` map to the port's ops:

* ``all_to_all`` -> ``all_to_all_torch``, ``all_to_all_pallas`` -> the
  K7b kernel ``all_to_all``;
* ``ppermute`` -> ``ring_permute_right_torch``, ``ppermute_pallas`` ->
  the K7a kernel ``ring_permute_right``;
* ``psum``, ``psum_scatter`` -> :mod:`dc_sand_tpu_torch.parallel.reduce`;
* ``all_gather`` -> a ``torch.cat`` of the group's shards on every shard.

The byte count is the JAX file's per-shard wire traffic (what leaves or
enters each shard).  The record carries ``devices`` (shards on the fx
axis) beside ``cards`` (distinct devices) and ``link``: shards that share
one card copy through its memory, not over NVLink.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.bench.harness import BenchResult, time_cuda
from dc_sand_tpu_torch.parallel import (FX_AXIS, all_to_all,
                                        all_to_all_torch, psum, psum_scatter,
                                        ring_permute_right,
                                        ring_permute_right_torch)

__all__ = ["bench_collective", "COLLECTIVES"]

COLLECTIVES = ("all_to_all", "ppermute", "psum", "psum_scatter",
               "all_gather", "all_to_all_pallas", "ppermute_pallas")


def _all_gather(xs, mesh) -> list:
    outs = [None] * len(xs)
    for group in mesh.groups(FX_AXIS):
        for j in group:
            outs[j] = torch.cat([xs[s].to(xs[j].device) for s in group])
    return outs


def bench_collective(op: str, mesh, *, mb_per_chip: float = 16.0,
                     iters: int = 32) -> BenchResult:
    """Achieved per-shard wire bandwidth of ``op`` over ``mesh``'s fx
    axis, float32 ``(n_rows, 1024)`` a shard."""
    d = mesh.shape[FX_AXIS]
    n_rows = max(d, int(mb_per_chip * 1e6 / (4 * 1024)))
    n_rows -= n_rows % d
    local_bytes = n_rows * 1024 * 4
    ops = {
        "all_to_all": (lambda xs: all_to_all_torch(xs, mesh, FX_AXIS),
                       local_bytes * (d - 1) / d),
        "all_to_all_pallas": (lambda xs: all_to_all(xs, mesh, FX_AXIS),
                              local_bytes * (d - 1) / d),
        "ppermute": (lambda xs: ring_permute_right_torch(xs, mesh, FX_AXIS),
                     local_bytes),
        "ppermute_pallas": (lambda xs: ring_permute_right(xs, mesh, FX_AXIS),
                            local_bytes),
        # reduce-scatter + all-gather
        "psum": (lambda xs: psum(xs, mesh, FX_AXIS),
                 local_bytes * 2 * (d - 1) / d),
        # the EP beam reduction: half a psum's wire
        "psum_scatter": (lambda xs: psum_scatter(xs, mesh, FX_AXIS),
                         local_bytes * (d - 1) / d),
        "all_gather": (lambda xs: _all_gather(xs, mesh),
                       local_bytes * (d - 1)),
    }
    if op not in ops:
        raise ValueError(f"unknown collective {op!r}; "
                         f"available: {COLLECTIVES}")
    fn, wire = ops[op]
    devices = mesh.flat_devices
    xs = [torch.zeros((n_rows, 1024), device=dev) for dev in devices]
    first = devices[0]
    others = sorted({dev for dev in devices if dev != first}, key=str)

    def call():
        fn(xs)
        # the first card's stream waits for the others, so that the
        # events on it span the whole collective
        for dev in others:
            torch.cuda.current_stream(first).wait_stream(
                torch.cuda.current_stream(dev))

    wall = time_cuda(call, warmup=2, iters=iters, device=first)
    cards = len(set(devices))
    link = ("host memory" if first.type == "cpu" else "NVLink" if cards > 1
            else "one card's memory")
    return BenchResult(
        name=f"collective_{op}_{d}dev",
        metric=f"{op} per-shard bandwidth", value=wire / wall / 1e9,
        unit="GB/s", wall_s=wall, bytes_moved=wire,
        extra={"devices": d, "cards": cards, "link": link,
               "local_mb": local_bytes / 1e6},
    ).finish(first)
