"""Overlap-save halo exchange (C14) over the time axis.

The halo is each shard's trailing samples (or frames), sent one step right
around the ring by the peer-copy kernel K7a
(:func:`~dc_sand_tpu_torch.parallel.remote_dma.ring_permute_right`):
:func:`ring_tails`.  The streaming SP step sends frames with it and
gives the stream head, time shard 0, the carried history in place of what
the ring brings; :func:`halo_exchange_left` is the sample-form counterpart
of :func:`dc_sand_tpu.parallel.halo_exchange_left` (``impl="pallas"``
route) on top of it, the stream head taking zeros.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.parallel.mesh import TIME_AXIS
from dc_sand_tpu_torch.parallel.remote_dma import ring_permute_right

__all__ = ["ring_tails", "halo_exchange_left"]


def ring_tails(xs, n: int, mesh, axis: str = TIME_AXIS,
               dim: int = -1, out=None) -> list:
    """Each shard's last ``n`` entries along ``dim``, sent one step right
    around the ring over ``axis`` (K7a): shard k of each group receives
    shard k-1's, the group's first shard its last shard's.  On a
    multi-process mesh they land in the receivers' halo buffers ``out`` (a
    :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` of a tail's
    shape; required on the card, and on the CPU the staged route's
    bookkeeping): through the IPC mapping of a receiver of this node, or
    over the staged route, placed by the receiver's own K7a launch, for a
    receiver of another node.  With ``time_local`` the time ring stays
    inside each rank."""
    tails = [x.narrow(dim, x.shape[dim] - n, n).contiguous() for x in xs]
    return ring_permute_right(tails, mesh, axis, out=out)


def halo_exchange_left(xs, halo_len: int, mesh,
                       axis: str = TIME_AXIS, out=None) -> list:
    """Prepend the left neighbour's trailing ``halo_len`` samples.

    ``xs``: per shard ``(..., t_local)`` -> per shard ``(..., halo_len +
    t_local)``.  The first shard of each group along ``axis`` gets zeros,
    the cold-start FIR history of the whole stream.  ``out``: the halo
    buffers of :func:`ring_tails`."""
    if xs[0].shape[-1] < halo_len:
        raise ValueError(
            f"time shard holds {xs[0].shape[-1]} samples < halo "
            f"{halo_len}; each shard needs at least (taps-1)*fft_size "
            "samples for overlap-save")
    halos = ring_tails(xs, halo_len, mesh, axis, out=out)
    heads = {group[0] for group in mesh.groups(axis)}
    for h, d in zip(halos, mesh.local_shards):
        if d in heads:
            h.zero_()
    return [torch.cat([h, x], dim=-1) for h, x in zip(halos, xs)]
