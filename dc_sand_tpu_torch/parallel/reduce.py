"""Sums over a mesh axis: ``psum`` and ``psum_scatter`` on shard lists.

The JAX package leaves these reductions to XLA (``lax.psum`` and
``lax.psum_scatter`` in ``models/pipeline.py``), with no Pallas kernel, so
here they are plain PyTorch: the group's shards are added in shard order
on the device of the shard that receives the result.  ``psum`` and
``psum_scatter`` add in the same order, so a scattered block equals the
matching slice of the all-reduced tensor bitwise.

On a mesh over several processes each rank passes its own shards and gets
its own results.  The other ranks' shards come from :func:`all_shards`:
on the card the peers' persistent buffers (``buffers``, a
:class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers`), read through
their CUDA IPC mappings within a node and from local mirrors, filled over
the staged route (:mod:`.staged`), across nodes; on the CPU a gloo
all-gather, or with ``buffers`` (peers all on other nodes) the staged
route's mirrors.  A shard of another node crosses once a reader, and
``psum_scatter`` fetches only the reader's blocks of it.  A rank that
holds several cards reads its other cards' buffers directly (a copy to
the reader's card, ordered after their writes by the buffers' rounds).
The adds run in the same shard order on the reader's card, so the sums
are bitwise the one-process mesh's on every route.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["psum", "psum_scatter", "all_shards"]


def _sum(parts, device):
    total = parts[0].to(device)
    for x in parts[1:]:
        total = total + x.to(device)
    return total


def _group(mesh, axis: str, j: int) -> list:
    return next(g for g in mesh.groups(axis) if j in g)


def all_shards(xs, mesh, buffers=None, need=None) -> list:
    """Every shard's tensor, in shard order, from this rank's ``xs``.

    In one process it is ``xs``.  Over several processes with ``buffers``
    they hold the shards: this rank's ``xs`` are copied into its own
    buffers (after every rank's reads of the last round) unless they are
    those buffers; the peers' of this node come back as IPC views,
    readable once :meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.
    done` has ordered this rank's stream after their writes, and other
    nodes' as the mirrors :meth:`~dc_sand_tpu_torch.parallel.ipc.
    SharedBuffers.fetch` fills with what ``need(rank)`` says each reader
    reads (None: every shard whole).  Without ``buffers`` on the CPU the
    shards are all-gathered over gloo (every rank holds as many shards, of
    one shape)."""
    if not mesh.multiprocess:
        return list(xs)
    if buffers is not None:
        if any(x is not b for x, b in zip(xs, buffers.local)):
            buffers.ready()
            for b, x in zip(buffers.local, xs):
                b.copy_(x)
        buffers.done()
        if buffers.staged is not None:
            buffers.fetch(need or (lambda rank: dict.fromkeys(
                range(mesh.size))))
        return list(buffers.views)
    if any(x.is_cuda for x in xs):
        raise ValueError("a multi-process sum on the card reads the peers' "
                         "shared buffers: pass buffers=")
    stacked = torch.stack(list(xs))
    every = [torch.empty_like(stacked) for _ in range(mesh.process_count)]
    dist.all_gather(every, stacked)
    out = [None] * mesh.size
    for rank, block in enumerate(every):
        for k, d in enumerate(mesh.shards_of(rank)):
            out[d] = block[k]
    return out


def psum(xs, mesh, axis: str, *, buffers=None) -> list:
    """All-reduce over ``axis``: every shard of a group gets the group's
    sum.  The sum is formed once per group and per device (shards on one
    device share one tensor; treat it as read-only).  ``buffers``: see
    :func:`all_shards`."""
    def need(rank):
        return {s: None for j in mesh.shards_of(rank)
                for s in _group(mesh, axis, j)}

    every = all_shards(xs, mesh, buffers, need)
    outs = []
    done = {}
    for k, j in enumerate(mesh.local_shards):
        group = _group(mesh, axis, j)
        key = (group[0], xs[k].device)
        if key not in done:
            done[key] = _sum([every[s] for s in group], xs[k].device)
        outs.append(done[key])
    return outs


def psum_scatter(xs, mesh, axis: str, dim: int = 0, *,
                 buffers=None) -> list:
    """Reduce-scatter over ``axis`` (``tiled=True``): shard ``my`` of a
    group gets block ``my`` along ``dim`` of the group's sum.
    ``buffers``: see :func:`all_shards`."""
    n = len(mesh.groups(axis)[0])
    size = xs[0].shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not scatter "
                         f"over {n} shards")
    blk = size // n

    def need(rank):
        # of each shard of a group, the blocks of the reader's shards in it
        lo, hi = {}, {}
        for j in mesh.shards_of(rank):
            group = _group(mesh, axis, j)
            for s in group:
                lo[s] = min(lo.get(s, n), group.index(j))
                hi[s] = max(hi.get(s, -1), group.index(j))
        return {s: (dim, lo[s] * blk, (hi[s] - lo[s] + 1) * blk) for s in lo}

    every = all_shards(xs, mesh, buffers, need)
    outs = []
    for k, j in enumerate(mesh.local_shards):
        group = _group(mesh, axis, j)
        my = group.index(j)
        outs.append(_sum([every[s].narrow(dim, my * blk, blk)
                          for s in group], xs[k].device))
    return outs
