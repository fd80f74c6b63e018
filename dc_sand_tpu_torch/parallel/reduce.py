"""Sums over a mesh axis: ``psum`` and ``psum_scatter`` on shard lists.

The JAX package leaves these reductions to XLA (``lax.psum`` and
``lax.psum_scatter`` in ``models/pipeline.py``), with no Pallas kernel, so
here they are plain PyTorch: the group's shards are added in shard order
on the device of the shard that receives the result.  ``psum`` and
``psum_scatter`` add in the same order, so a scattered block equals the
matching slice of the all-reduced tensor bitwise.
"""

from __future__ import annotations

__all__ = ["psum", "psum_scatter"]


def _sum(parts, device):
    total = parts[0].to(device)
    for x in parts[1:]:
        total = total + x.to(device)
    return total


def psum(xs, mesh, axis: str) -> list:
    """All-reduce over ``axis``: every shard of a group gets the group's
    sum.  The sum is formed once per group and per device (shards on one
    device share one tensor; treat it as read-only)."""
    outs = [None] * len(xs)
    for group in mesh.groups(axis):
        done = {}
        for j in group:
            dev = xs[j].device
            if dev not in done:
                done[dev] = _sum([xs[s] for s in group], dev)
            outs[j] = done[dev]
    return outs


def psum_scatter(xs, mesh, axis: str, dim: int = 0) -> list:
    """Reduce-scatter over ``axis`` (``tiled=True``): shard ``my`` of a
    group gets block ``my`` along ``dim`` of the group's sum."""
    outs = [None] * len(xs)
    for group in mesh.groups(axis):
        n = len(group)
        size = xs[group[0]].shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not scatter "
                             f"over {n} shards")
        blk = size // n
        for my, j in enumerate(group):
            outs[j] = _sum([xs[s].narrow(dim, my * blk, blk) for s in group],
                           xs[j].device)
    return outs
