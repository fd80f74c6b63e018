"""Sums over a mesh axis: ``psum`` and ``psum_scatter`` on shard lists.

The JAX package leaves these reductions to XLA (``lax.psum`` and
``lax.psum_scatter`` in ``models/pipeline.py``), with no Pallas kernel, so
here they are plain PyTorch: the group's shards are added in shard order
on the device of the shard that receives the result.  ``psum`` and
``psum_scatter`` add in the same order, so a scattered block equals the
matching slice of the all-reduced tensor bitwise.

On a mesh over several processes each rank passes its own shards and gets
its own results.  The other ranks' shards come from :func:`all_shards`:
on the card the peers' persistent buffers read through their CUDA IPC
mappings (``buffers``, a :class:`~dc_sand_tpu_torch.parallel.ipc.
SharedBuffers`), on the CPU a gloo all-gather.  The adds run in the same
shard order on the local device, so the sums are bitwise the one-process
mesh's.
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


def all_shards(xs, mesh, buffers=None) -> list:
    """Every shard's tensor, in shard order, from this rank's ``xs``.

    In one process it is ``xs``.  Over several processes on the card,
    ``buffers`` holds the shards: this rank's ``xs`` are copied into its
    own buffers (after every rank's reads of the last round) unless they
    are those buffers, and the peers' come back as IPC views, readable
    once :meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.done` has
    ordered this rank's stream after their writes.  On the CPU the shards
    are all-gathered over gloo (every rank holds as many shards, of one
    shape)."""
    if not mesh.multiprocess:
        return list(xs)
    if buffers is not None:
        if any(x is not b for x, b in zip(xs, buffers.local)):
            buffers.ready()
            for b, x in zip(buffers.local, xs):
                b.copy_(x)
        buffers.done()
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
    every = all_shards(xs, mesh, buffers)
    outs = []
    done = {}
    for k, j in enumerate(mesh.local_shards):
        group = next(g for g in mesh.groups(axis) if j in g)
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
    every = all_shards(xs, mesh, buffers)
    outs = []
    for k, j in enumerate(mesh.local_shards):
        group = next(g for g in mesh.groups(axis) if j in g)
        n = len(group)
        size = xs[k].shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not scatter "
                             f"over {n} shards")
        blk = size // n
        my = group.index(j)
        outs.append(_sum([every[s].narrow(dim, my * blk, blk)
                          for s in group], xs[k].device))
    return outs
