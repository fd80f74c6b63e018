"""Peer-copy collectives K7a and K7b over a mesh's shard lists.

PyTorch counterpart of :mod:`dc_sand_tpu.parallel.remote_dma`.  Both ops
take and return lists of per-shard tensors in the mesh's shard order
(:class:`~dc_sand_tpu_torch.parallel.mesh.Mesh`) and act within each group
of shards along ``axis``, as the JAX ops do inside ``shard_map``:

* :func:`ring_permute_right` (K7a): every shard's block moves to its right
  neighbour, shard 0 receiving shard n-1's (``lax.ppermute`` with the full
  ring);
* :func:`all_to_all` (K7b): the leading axis is cut into n row-blocks and
  output row-block s holds shard s's row-block ``my`` (``lax.all_to_all``
  with ``split_axis=concat_axis=0, tiled=True``).

On CUDA tensors they launch ``csrc/remote_dma.cu`` on the sender's
device and current stream, each launch adding one to the op's
``launches``: the all-to-all once per sending shard, the ring step once
per CARD that holds a sender (the blocks of all its senders ride in one
launch; on one card the whole ring is one launch).  The senders first
wait for the receivers' streams (their outputs are allocated there), and
every receiver's stream then waits for each of its senders, which takes
the place of the TPU kernels' DMA semaphores.  Shards on different cards
need peer access, which is enabled once per pair; a pair without it
raises.  No ``copy_``, ``cat`` or NCCL stands in for the kernel.  On CPU
tensors they run the plain versions (``*_torch``): index arithmetic and
``.to(device)`` copies.
"""

from __future__ import annotations

import contextlib

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["ring_permute_right", "ring_permute_right_torch", "all_to_all",
           "all_to_all_torch"]

# (sender, receiver) card pairs whose peer access is on: like the CUDA
# state it mirrors, it holds for the whole process
_peers_enabled = set()


def _check(xs, mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size}")
    x0 = xs[0]
    for x in xs:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError("every shard must have one shape and dtype, got "
                             f"{tuple(x.shape)} {x.dtype} and "
                             f"{tuple(x0.shape)} {x0.dtype}")


def _impl(impl: str, xs) -> str:
    got = {resolve_impl(impl, x) for x in xs}
    if len(got) != 1:
        raise ValueError("the shards of a collective must all be CUDA or "
                         "all CPU tensors")
    return got.pop()


def _enable_peer(src: torch.device, dst: torch.device) -> None:
    if src == dst or (src, dst) in _peers_enabled:
        return
    if not torch.cuda.can_device_access_peer(src.index, dst.index):
        raise RuntimeError(f"{src} cannot write to {dst}: no peer access "
                           "between these cards")
    with torch.cuda.device(src):
        _build.check(_build.library().dcs_enable_peer(dst.index),
                     "dcs_enable_peer")
    _peers_enabled.add((src, dst))


def _launch_all(xs, outs, sends, entry) -> None:
    """``sends[i]``: the shards sender ``i`` writes to.  Calls
    ``entry(i, stream)`` once per sender, after its stream has waited for
    its receivers' (where their outputs were allocated), and makes every
    receiver's stream wait for its senders after."""
    streams = [torch.cuda.current_stream(x.device) for x in xs]
    for i, dsts in sends.items():
        for j in dsts:
            _enable_peer(xs[i].device, outs[j].device)
            if streams[j] != streams[i]:
                streams[i].wait_stream(streams[j])
    for i in sends:
        with torch.cuda.device(xs[i].device):
            entry(i, streams[i].cuda_stream)
    for i, dsts in sends.items():
        for j in dsts:
            if streams[j] != streams[i]:
                streams[j].wait_stream(streams[i])


def _peers(ptrs) -> _build.Peers:
    if len(ptrs) > _build.MAX_PEERS:
        raise ValueError(f"the peer-copy kernel takes at most "
                         f"{_build.MAX_PEERS} shards a group, got {len(ptrs)}")
    p = _build.Peers()
    for k, ptr in enumerate(ptrs):
        p.dst[k] = ptr
    return p


def _contiguous(xs) -> None:
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("the peer-copy kernel takes contiguous shards")


def ring_permute_right(xs, mesh, axis: str, *, impl: str = "auto") -> list:
    """One ring step over ``axis`` (K7a): shard k of each group receives
    shard k-1's block, shard 0 shard n-1's.  Returns new tensors, each on
    its receiver's device."""
    _check(xs, mesh)
    if _impl(impl, xs) == "torch":
        return ring_permute_right_torch(xs, mesh, axis)
    _contiguous(xs)
    outs = [torch.empty_like(x) for x in xs]
    nbytes = xs[0].numel() * xs[0].element_size()
    lib = _build.library()
    waits = []
    current = torch.cuda.current_device()
    for dev, pairs in mesh.ring_sends(axis):
        stream = torch.cuda.current_stream(dev)
        for i, j in pairs:
            if xs[i].device != dev:
                raise ValueError(f"shard {i} lies on {xs[i].device}, its "
                                 f"mesh device is {dev}")
            to = outs[j].device
            if to != dev:
                _enable_peer(dev, to)
                waits.append((torch.cuda.current_stream(to), stream))
                stream.wait_stream(waits[-1][0])
        # switching the device costs as much host time as the launch
        with (torch.cuda.device(dev) if dev.index != current
              else contextlib.nullcontext()):
            for at in range(0, len(pairs), _build.MAX_PEERS):
                part = pairs[at:at + _build.MAX_PEERS]
                arg = _build.Pairs()
                for k, (i, j) in enumerate(part):
                    arg.src[k] = xs[i].data_ptr()
                    arg.dst[k] = outs[j].data_ptr()
                _build.check(lib.dcs_ring(arg, len(part), nbytes,
                                          stream.cuda_stream), "dcs_ring")
                ring_permute_right.launches += 1
    for receiver, sender in waits:
        receiver.wait_stream(sender)
    return outs


ring_permute_right.launches = 0


def ring_permute_right_torch(xs, mesh, axis: str) -> list:
    """Plain version of :func:`ring_permute_right`."""
    _check(xs, mesh)
    outs = [None] * len(xs)
    for group in mesh.groups(axis):
        for k, src in enumerate(group):
            dst = group[(k + 1) % len(group)]
            outs[dst] = xs[src].to(xs[dst].device, copy=True)
    return outs


def _rows(xs, n: int) -> int:
    if xs[0].dim() == 0 or xs[0].shape[0] % n:
        raise ValueError(f"leading dim {tuple(xs[0].shape)[:1]} not "
                         f"divisible by {n} shards")
    return xs[0].shape[0] // n


def all_to_all(xs, mesh, axis: str, *, impl: str = "auto") -> list:
    """Direct-send all-to-all on the leading axis over ``axis`` (K7b):
    output row-block s of shard ``my`` is shard s's row-block ``my``.
    Returns new tensors, each on its receiver's device."""
    _check(xs, mesh)
    groups = mesh.groups(axis)
    _rows(xs, len(groups[0]))
    if _impl(impl, xs) == "torch":
        return all_to_all_torch(xs, mesh, axis)
    _contiguous(xs)
    outs = [torch.empty_like(x) for x in xs]
    n = len(groups[0])
    block = xs[0].numel() * xs[0].element_size() // n
    where = {}
    for group in groups:
        peers = _peers([outs[j].data_ptr() for j in group])
        for my, i in enumerate(group):
            where[i] = (group, my, peers)

    def entry(i, stream):
        _, my, peers = where[i]
        _build.check(_build.library().dcs_all_to_all(
            xs[i].data_ptr(), peers, n, my, block, stream), "dcs_all_to_all")
        all_to_all.launches += 1

    _launch_all(xs, outs, {i: g for i, (g, _, _) in where.items()}, entry)
    return outs


all_to_all.launches = 0


def all_to_all_torch(xs, mesh, axis: str) -> list:
    """Plain version of :func:`all_to_all`."""
    _check(xs, mesh)
    outs = [None] * len(xs)
    for group in mesh.groups(axis):
        rows = _rows(xs, len(group))
        for my, j in enumerate(group):
            dev = xs[j].device
            outs[j] = torch.cat([xs[s][my * rows:(my + 1) * rows].to(dev)
                                 for s in group])
    return outs
