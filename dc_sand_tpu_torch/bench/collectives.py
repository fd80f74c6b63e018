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

On a mesh over several processes (``bench collectives --distributed``,
the JAX bench's ``--distributed`` over global devices) each rank times its
own part, each call ordered by two rounds of device flags within a node
(and gloo barriers where the mesh spans nodes; in the time), and the
plain versions go over gloo.  The kernels reach a rank of the same node
through its CUDA IPC mappings, a rank of another node over the staged
route (pinned host slots and gloo; the receiver's launch places each
block), and the sums read the mappings or the staged mirrors.  ``link``
says which (``CUDA IPC``, ``staged``, both, or ``gloo`` on the CPU),
``routes`` each other rank's route, and ``processes`` how many ranks share
the mesh.  Two ranks on one card time-slice it: their times are not a
scaling measurement.

The kernels' records (K7b, K7a) carry ``kernel_ms``, CUDA events around
the launches alone (a card's launches of a call, the slowest card's;
``remote_dma.kernel_events``) beside the whole call's time; across
processes ``span_ms``, CUDA events around the call on each card's stream,
its two flag rounds and the waits for the peers in them included (what
events around NCCL's call hold); ``copy_ms``,
the same blocks placed by ``Tensor.copy_`` into the same destinations
(the yardstick; across processes the same route with ``place="copy"``),
and, where senders and
receivers lie on different cards, ``cross_mb`` (the bytes one card sends
to the others in a call, the most over the rank's cards), ``gb_s_per_card``
(those bytes over the call's time) and ``link_bound_ms`` (those bytes at
NVLink's 450 GB/s each way).  Across ranks that each hold one card of
their own and one shard, K7b's block-mode record also carries
``nccl_ms``: NCCL's ``all_to_all_single`` over a ``nccl`` group of the
same ranks on the same shards (bitwise checked against K7b), the library
yardstick (K7a's: NCCL's ring step, ``batch_isend_irecv`` to the right
neighbour and from the left, bitwise K7a), and ``nccl_kernel_ms``, CUDA
events around each call alone on the device (NCCL's handshake with its
peers in it: the kernel's ``span_ms`` is the like measure); where ranks share a card or hold several shards they
stay None and ``nccl_note`` says why.  ``host_us`` is the host's part
of a kernel's call (:func:`host_us`), what bounds the call where the
device's part is shorter.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from dc_sand_tpu_torch.bench.harness import (NVLINK_BYTES_S, BenchResult,
                                             time_cuda)
from dc_sand_tpu_torch.parallel import (FX_AXIS, SharedBuffers, all_shards,
                                        all_to_all, all_to_all_torch, psum,
                                        psum_scatter, ring_permute_right,
                                        ring_permute_right_torch,
                                        uses_shared_buffers)
from dc_sand_tpu_torch.parallel.remote_dma import events_ms, kernel_events

__all__ = ["bench_collective", "cross_bytes", "nccl_all_to_all",
           "nccl_ring_step", "kernel_alone_ms", "host_us", "COLLECTIVES"]

COLLECTIVES = ("all_to_all", "ppermute", "psum", "psum_scatter",
               "all_gather", "all_to_all_pallas", "ppermute_pallas")


def _all_gather(xs, mesh, buffers) -> list:
    every = all_shards(xs, mesh, buffers)
    outs = []
    for x, j in zip(xs, mesh.local_shards):
        group = next(g for g in mesh.groups(FX_AXIS) if j in g)
        outs.append(torch.cat([every[s].to(x.device) for s in group]))
    return outs


def _pairs(op: str, mesh) -> tuple:
    """K7b's or K7a's ``(device, ((src, dst), ...))`` over the fx axis,
    this rank's senders by card."""
    return (mesh.all_to_all_sends(FX_AXIS) if op == "all_to_all_pallas"
            else mesh.ring_sends(FX_AXIS))


def cross_bytes(mesh, sends, block: int) -> int:
    """The most bytes one of this rank's cards sends to other cards (or
    nodes) in one call of K7b or K7a: ``sends`` its pairs by card
    (:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.ring_sends`,
    :meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.all_to_all_sends`),
    ``block`` the bytes a pair moves."""
    flat = mesh.flat_devices
    return max((sum(block for i, j in pairs if flat[i] != flat[j]
                    or mesh.route(i, j) == "staged")
                for _, pairs in sends), default=0)


def _copy_blocks(op: str, mesh, xs) -> tuple:
    """One process: ``(outs, fn)``, ``fn`` placing K7b's or K7a's blocks
    into ``outs`` with ``Tensor.copy_``, the kernel's yardstick."""
    d = mesh.shape[FX_AXIS]
    pos = {i: k for g in mesh.groups(FX_AXIS) for k, i in enumerate(g)}
    outs = [torch.empty_like(x) for x in xs]

    def fn():
        for _, pairs in _pairs(op, mesh):
            for i, j in pairs:
                if op == "all_to_all_pallas":
                    outs[j].view(d, -1)[pos[i]].copy_(
                        xs[i].view(d, -1)[pos[j]])
                else:
                    outs[j].copy_(xs[i])

    return outs, fn


def kernel_alone_ms(fn, calls: int, warmup: int = 2,
                    span: bool = False) -> float:
    """K7b's or K7a's kernel ms a call with CUDA events around its
    launches alone (``remote_dma.kernel_events``), over ``calls`` calls of
    ``fn`` after ``warmup``: what the whole call's time holds beside the
    ordering around the launches.  ``span``: the events around the call
    on the device instead, its flag rounds included."""
    for _ in range(warmup):
        fn()
    with kernel_events(span) as events:
        for _ in range(calls):
            fn()
    return events_ms(events, calls)


def host_us(fn, calls: int, devices) -> float:
    """The host's microseconds a call of ``fn`` over ``calls`` calls
    enqueued back to back after one warm-up call, ``devices`` synchronised
    before and after, outside the time: the wrapper's own part of a call,
    which bounds it where the device's part is shorter."""
    cards = {dev for dev in devices if dev.type == "cuda"}
    fn()
    for dev in cards:
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    for dev in cards:
        torch.cuda.synchronize(dev)
    return us


def _nccl_note(mesh, xs):
    """Why NCCL cannot stand beside K7b or K7a on ``mesh``, or None where
    every rank holds one shard on a card of its own (collective: every
    rank reaches the same verdict from the global mesh)."""
    if not mesh.multiprocess or xs[0].device.type != "cuda":
        return "one process or the CPU"
    if len(mesh.local_shards) != 1:
        return (f"{len(mesh.local_shards)} shards a rank; NCCL's collectives "
                "move one block a rank")
    cards = [(mesh.node_of(mesh.process_of(k)), str(dev))
             for k, dev in enumerate(mesh.flat_devices)]
    if len(set(cards)) != len(cards):
        return "ranks share a card"
    return None


def _nccl_time(xs, call, out, want, iters: int, what: str) -> tuple:
    """``(ms, None, kernel ms)`` of ``call`` on a ``nccl`` group it takes:
    back-to-back calls, then CUDA events around each call alone (its
    handshake with the peers in it); ``out`` bitwise ``want`` after."""
    dev = xs[0].device
    with torch.cuda.device(dev):
        group = dist.new_group(backend="nccl")
        try:
            wall = time_cuda(lambda: call(group), warmup=2, iters=iters,
                             device=dev)
            pairs = []
            for _ in range(iters):
                pairs.append([torch.cuda.Event(enable_timing=True)
                              for _ in range(2)])
                pairs[-1][0].record()
                call(group)
                pairs[-1][1].record()
            torch.cuda.synchronize(dev)
            alone = sum(a.elapsed_time(b) for a, b in pairs) / iters
            out.zero_()
            call(group)
            torch.cuda.synchronize(dev)
            if not torch.equal(out, want):
                raise RuntimeError(f"NCCL's {what} != the kernel's output "
                                   "on the same shards")
        finally:
            dist.destroy_process_group(group)
    return wall * 1e3, None, alone


def nccl_all_to_all(mesh, xs, got, iters: int) -> tuple:
    """``(ms, note, kernel ms)``: NCCL's ``all_to_all_single`` on this
    rank's shard over a ``nccl`` group of every rank, timed over
    back-to-back calls and with CUDA events around each call alone (its
    handshake with the peers in it), where
    every rank holds one shard on a card of its own (``note`` None), its
    output bitwise K7b's ``got``; else ``(None, why, None)``.
    Collective: every rank reaches the same verdict from the global
    mesh."""
    note = _nccl_note(mesh, xs)
    if note:
        return None, note, None
    out = torch.empty_like(xs[0])
    return _nccl_time(xs, lambda group: dist.all_to_all_single(
        out, xs[0], group=group), out, got[0], iters, "all_to_all_single")


def nccl_ring_step(mesh, axis: str, xs, got, iters: int) -> tuple:
    """``(ms, note, kernel ms)``: NCCL's ring step over ``axis``, K7a's
    second yardstick: ``batch_isend_irecv`` on a ``nccl`` group of every
    rank, this rank's shard sent to its right neighbour's rank and its
    left neighbour's received, timed as :func:`nccl_all_to_all` is, where
    every rank holds one shard on a card of its own, its output bitwise
    K7a's ``got``; else ``(None, why, None)``.  Collective."""
    note = _nccl_note(mesh, xs)
    if note:
        return None, note, None
    d = mesh.local_shards[0]
    ring = next(g for g in mesh.groups(axis) if d in g)
    k = len(ring)
    right = mesh.process_of(ring[(ring.index(d) + 1) % k])
    left = mesh.process_of(ring[(ring.index(d) - 1) % k])
    out = torch.empty_like(xs[0])

    def call(group):
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, xs[0], right, group=group),
                dist.P2POp(dist.irecv, out, left, group=group)]):
            work.wait()

    return _nccl_time(xs, call, out, got[0], iters, "ring step")


def bench_collective(op: str, mesh, *, mb_per_chip: float = 16.0,
                     iters: int = 32) -> BenchResult:
    """Achieved per-shard wire bandwidth of ``op`` over ``mesh``'s fx
    axis, float32 ``(n_rows, 1024)`` a shard."""
    d = mesh.shape[FX_AXIS]
    n_rows = max(d, int(mb_per_chip * 1e6 / (4 * 1024)))
    n_rows -= n_rows % d
    local_bytes = n_rows * 1024 * 4
    if op not in COLLECTIVES:
        raise ValueError(f"unknown collective {op!r}; "
                         f"available: {COLLECTIVES}")
    devices = mesh.local_devices
    first = devices[0]
    # across processes: the shards' buffers every rank reaches
    shared = (SharedBuffers(mesh, (n_rows, 1024), torch.float32)
              if uses_shared_buffers(mesh) else None)
    ops = {
        "all_to_all": (lambda xs: all_to_all_torch(xs, mesh, FX_AXIS),
                       local_bytes * (d - 1) / d),
        "all_to_all_pallas": (lambda xs: all_to_all(xs, mesh, FX_AXIS,
                                                    out=shared),
                              local_bytes * (d - 1) / d),
        "ppermute": (lambda xs: ring_permute_right_torch(xs, mesh, FX_AXIS),
                     local_bytes),
        "ppermute_pallas": (lambda xs: ring_permute_right(xs, mesh, FX_AXIS,
                                                          out=shared),
                            local_bytes),
        # reduce-scatter + all-gather
        "psum": (lambda xs: psum(xs, mesh, FX_AXIS, buffers=shared),
                 local_bytes * 2 * (d - 1) / d),
        # the EP beam reduction: half a psum's wire
        "psum_scatter": (lambda xs: psum_scatter(xs, mesh, FX_AXIS,
                                                 buffers=shared),
                         local_bytes * (d - 1) / d),
        "all_gather": (lambda xs: _all_gather(xs, mesh, shared),
                       local_bytes * (d - 1)),
    }
    fn, wire = ops[op]
    # distinct values a shard, so that a yardstick's output is checkable
    xs = [(torch.arange(n_rows * 1024, device=dev) % 4096 + 4096 * k)
          .float().reshape(n_rows, 1024)
          for k, dev in zip(mesh.local_shards, devices)]
    others = sorted({dev for dev in devices if dev != first}, key=str)

    def spanned(run):
        """``run``, then the first card's stream waits for the others, so
        that the events on it span the whole collective."""
        def go():
            run()
            for dev in others:
                torch.cuda.current_stream(first).wait_stream(
                    torch.cuda.current_stream(dev))
        return go

    wall = time_cuda(spanned(lambda: fn(xs)), warmup=2, iters=iters,
                     device=first)
    cards = len(set(devices))
    extra = {"devices": d, "cards": cards, "processes": mesh.process_count,
             "local_mb": local_bytes / 1e6}
    kernel = op.endswith("_pallas")

    if mesh.multiprocess:
        routes = mesh.routes()
        extra["routes"] = {str(r): how for r, how in routes.items()}
        extra["link"] = (" + ".join(name for how, name in (
            ("ipc", "CUDA IPC"), ("staged", "staged"))
            if how in routes.values()) if shared is not None else "gloo")
        if shared is not None and kernel:
            copy_op = all_to_all if op == "all_to_all_pallas" else \
                ring_permute_right
            extra["copy_ms"] = time_cuda(
                spanned(lambda: copy_op(xs, mesh, FX_AXIS, out=shared,
                                        place="copy")),
                warmup=2, iters=iters, device=first) * 1e3
    else:
        extra["link"] = ("host memory" if first.type == "cpu" else "NVLink"
                         if cards > 1 else "one card's memory")
        if kernel:
            _, copy_fn = _copy_blocks(op, mesh, xs)
            extra["copy_ms"] = time_cuda(spanned(copy_fn), warmup=2,
                                         iters=iters, device=first) * 1e3
    if kernel:
        extra["host_us"] = host_us(lambda: fn(xs), iters, devices)
    if kernel and first.type == "cuda":
        extra["kernel_ms"] = kernel_alone_ms(lambda: fn(xs), iters)
        if shared is not None:
            extra["span_ms"] = kernel_alone_ms(lambda: fn(xs), iters,
                                               span=True)
    if kernel:
        cross = cross_bytes(mesh, _pairs(op, mesh), local_bytes // d
                            if op == "all_to_all_pallas" else local_bytes)
        if cross:
            extra["cross_mb"] = cross / 1e6
            extra["gb_s_per_card"] = cross / wall / 1e9
            extra["link_bound_ms"] = cross / NVLINK_BYTES_S * 1e3
    if kernel and mesh.multiprocess:
        got = fn(xs)
        (extra["nccl_ms"], extra["nccl_note"],
         extra["nccl_kernel_ms"]) = (
            nccl_all_to_all(mesh, xs, got, iters)
            if op == "all_to_all_pallas"
            else nccl_ring_step(mesh, FX_AXIS, xs, got, iters))
        if extra["nccl_note"]:
            print(f"collectives: no NCCL yardstick: {extra['nccl_note']}",
                  file=sys.stderr, flush=True)
    procs = mesh.process_count
    return BenchResult(
        name=f"collective_{op}_{d}dev" + (f"_{procs}proc" if procs > 1
                                          else ""),
        metric=f"{op} per-shard bandwidth", value=wire / wall / 1e9,
        unit="GB/s", wall_s=wall, bytes_moved=wire, extra=extra,
    ).finish(first)
