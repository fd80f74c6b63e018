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
  with ``split_axis=concat_axis=0, tiled=True``).  With ``rows > 1`` each
  row-block is ``rows`` rows, and the output interleaves the senders'
  rows: viewed ``(rows, n, C)``, its ``[q, s]`` is shard s's row q of
  row-block ``my``.  That is the corner-turn's pitched mode
  (:mod:`.corner_turn`): the blocks land straight in the receiver's CMAC
  operand.

On CUDA tensors they launch ``csrc/remote_dma.cu`` on each sending card's
current stream, ONE launch per card that holds a sender (its pairs of
sender and receiver ride in one launch, 16 at most; a card with more pairs
launches once per 16), each launch adding one to the op's ``launches``: on
one card a 4-shard all-to-all, or a whole ring, is one launch.  A card's
stream first waits for its receivers' streams on other cards (their
outputs are allocated there), and each such receiver's stream then waits
for it, which takes the place of the TPU kernels' DMA semaphores.  Shards
on different cards need peer access, which is enabled once per pair; a
pair without it raises.  No ``copy_``, ``cat`` or NCCL stands in for the
kernel.  On CPU tensors they run the plain versions (``*_torch``): index
arithmetic and ``.to(device)`` copies.

On a mesh over several processes (:func:`~dc_sand_tpu_torch.parallel.mesh.
build_global_mesh`) each rank passes and gets back its own shards only.
On the card the destinations are the receivers' persistent buffers
(``out``, a :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers`: the
peers' are CUDA IPC mappings), and each rank launches the same kernel once
for its own senders, its counter counting its launches; ``out.ready()``
before and ``out.done()`` after order the writes against every rank's
reads in place of the stream waits.  The plain versions copy to the host
and send the blocks between ranks over gloo (``batch_isend_irecv``), the
receiver interleaving them: bitwise the one-process result over the same
global mesh.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl

__all__ = ["ring_permute_right", "ring_permute_right_torch", "all_to_all",
           "all_to_all_torch"]

# (sender, receiver) card pairs whose peer access is on: like the CUDA
# state it mirrors, it holds for the whole process
_peers_enabled = set()


def _check(xs, mesh) -> None:
    if len(xs) != len(mesh.local_shards):
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size} "
                         f"({len(mesh.local_shards)} in this process)")
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


def _contiguous(xs) -> None:
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("the peer-copy kernel takes contiguous shards")


def _launch_by_card(sends, xs, outs, launch) -> None:
    """``sends``: ``(device, ((src, dst), ...))`` per card that holds a
    sender, with the shard pairs whose sender sits on it; ``xs`` and
    ``outs`` map shard numbers to tensors.  Each card's
    stream first waits for its receivers' streams on other cards, then
    ``launch(pairs, stream)`` runs once per
    :data:`~dc_sand_tpu_torch._build.MAX_PEERS` pairs on it, and every such
    receiver's stream waits for it after."""
    waits = []
    current = torch.cuda.current_device()
    for dev, pairs in sends:
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
                launch(pairs[at:at + _build.MAX_PEERS], stream.cuda_stream)
    for receiver, sender in waits:
        receiver.wait_stream(sender)


def _pairs(ptrs) -> _build.Pairs:
    """(source, destination) pointers -> the kernel's by-value argument."""
    arg = _build.Pairs()
    for k, (src, dst) in enumerate(ptrs):
        arg.src[k] = src
        arg.dst[k] = dst
    return arg


def ring_permute_right(xs, mesh, axis: str, *, out=None,
                       impl: str = "auto") -> list:
    """One ring step over ``axis`` (K7a): shard k of each group receives
    shard k-1's block, shard 0 shard n-1's.  Returns new tensors, each on
    its receiver's device; on a multi-process mesh on the card,
    ``out.local`` after the kernel wrote into ``out`` (a
    :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` of the shards'
    shape, required there and refused elsewhere)."""
    _check(xs, mesh)
    if _impl(impl, xs) == "torch":
        return ring_permute_right_torch(xs, mesh, axis)
    _contiguous(xs)
    _out_for(mesh, out)
    loc = _local_index(mesh)
    xs_g = {d: xs[k] for d, k in loc.items()}
    outs = (out.views if out is not None
            else {d: torch.empty_like(xs_g[d]) for d in loc})
    nbytes = xs[0].numel() * xs[0].element_size()
    lib = _build.library()

    def launch(pairs, stream):
        arg = _pairs((xs_g[i].data_ptr(), outs[j].data_ptr())
                     for i, j in pairs)
        _build.check(lib.dcs_ring(arg, len(pairs), nbytes, stream), "dcs_ring")
        ring_permute_right.launches += 1

    if out is not None:
        return _launch_shared(mesh.ring_sends(axis), out, launch)
    _launch_by_card(mesh.ring_sends(axis), xs_g, outs, launch)
    return [outs[d] for d in mesh.local_shards]


ring_permute_right.launches = 0


def ring_permute_right_torch(xs, mesh, axis: str) -> list:
    """Plain version of :func:`ring_permute_right`."""
    _check(xs, mesh)
    loc = _local_index(mesh)
    moves = {}
    for group in mesh.groups(axis):
        for k, src in enumerate(group):
            moves[(src, group[(k + 1) % len(group)])] = 0
    got = _exchange(xs, mesh, moves, lambda x, _: x)
    return [got[(s, d)].to(xs[loc[d]].device, copy=True)
            for (s, d) in sorted(got, key=lambda sd: loc[sd[1]])]


def _block(xs, n: int, rows: int) -> int:
    """Elements of a row-block; raises unless n row-blocks of ``rows``
    rows each cut the shards."""
    if xs[0].dim() == 0 or xs[0].shape[0] % n:
        raise ValueError(f"leading dim {tuple(xs[0].shape)[:1]} not "
                         f"divisible by {n} shards")
    block = xs[0].numel() // n
    if rows < 1 or block % rows:
        raise ValueError(f"a row-block of {block} elements does not cut "
                         f"into {rows} rows")
    return block


def all_to_all(xs, mesh, axis: str, *, rows: int = 1, out=None,
               impl: str = "auto") -> list:
    """Direct-send all-to-all on the leading axis over ``axis`` (K7b):
    output row-block s of shard ``my`` is shard s's row-block ``my``; with
    ``rows > 1``, each row-block cut into ``rows`` rows, the receivers'
    outputs interleave the senders' rows (module docstring).  Returns new
    tensors of the shards' shape, each on its receiver's device; on a
    multi-process mesh on the card, ``out.local`` after the kernel wrote
    into ``out`` (a :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers`
    of the shards' size, required there and refused elsewhere)."""
    _check(xs, mesh)
    groups = mesh.groups(axis)
    n = len(groups[0])
    block = _block(xs, n, rows)
    if _impl(impl, xs) == "torch":
        return all_to_all_torch(xs, mesh, axis, rows=rows)
    _contiguous(xs)
    _out_for(mesh, out)
    loc = _local_index(mesh)
    xs_g = {d: xs[k] for d, k in loc.items()}
    outs = (out.views if out is not None
            else {d: torch.empty_like(xs_g[d]) for d in loc})
    esize = xs[0].element_size()
    row_bytes = block // rows * esize
    pitch = n * row_bytes if rows > 1 else row_bytes
    pos = {i: k for group in groups for k, i in enumerate(group)}
    by_dev = {}
    for group in groups:
        for i in group:
            if i in loc:
                by_dev.setdefault(xs_g[i].device, []).extend(
                    (i, j) for j in group)
    lib = _build.library()

    def launch(pairs, stream):
        # sender i's row-block pos[j] -> receiver j, its rows from pos[i]
        arg = _pairs((xs_g[i].data_ptr() + pos[j] * block * esize,
                      outs[j].data_ptr() + pos[i] * row_bytes)
                     for i, j in pairs)
        _build.check(lib.dcs_all_to_all(arg, len(pairs), rows, row_bytes,
                                        pitch, stream), "dcs_all_to_all")
        all_to_all.launches += 1

    if out is not None:
        return _launch_shared(tuple(by_dev.items()), out, launch)
    _launch_by_card(tuple(by_dev.items()), xs_g, outs, launch)
    return [outs[d] for d in mesh.local_shards]


all_to_all.launches = 0


def all_to_all_torch(xs, mesh, axis: str, *, rows: int = 1) -> list:
    """Plain version of :func:`all_to_all`."""
    _check(xs, mesh)
    groups = mesh.groups(axis)
    n = len(groups[0])
    _block(xs, n, rows)
    loc = _local_index(mesh)
    pos = {i: k for group in groups for k, i in enumerate(group)}
    moves = {(s, j): pos[j] for group in groups for j in group for s in group}
    got = _exchange(xs, mesh, moves, lambda x, r: x.reshape(n, rows, -1)[r])
    outs = []
    for j in mesh.local_shards:
        group = next(g for g in groups if j in g)
        x = xs[loc[j]]
        parts = [got[(s, j)].to(x.device) for s in group]
        outs.append(torch.stack(parts, 1).reshape(x.shape))
    return outs


def _local_index(mesh) -> dict:
    """Shard number -> its index in this process's shard lists."""
    return {d: k for k, d in enumerate(mesh.local_shards)}


def _out_for(mesh, out) -> None:
    if mesh.multiprocess and out is None:
        raise ValueError("on a multi-process mesh the kernel writes into "
                         "the receivers' shared buffers: pass out= (a "
                         "parallel.ipc.SharedBuffers)")
    if out is not None and not mesh.multiprocess:
        raise ValueError("out= is for a multi-process mesh; in one process "
                         "the outputs are allocated on their receivers")


def _launch_shared(sends, out, launch) -> list:
    """The kernel over a multi-process mesh: ``sends`` holds this rank's
    senders on its one card; ``out.ready()`` before the launches and
    ``out.done()`` after order them against every rank's use of the
    buffers."""
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        out.ready()
        for card, pairs in sends:
            if card != dev:
                raise ValueError(f"a sender lies on {card}, the rank's card "
                                 f"is {dev}")
            for at in range(0, len(pairs), _build.MAX_PEERS):
                launch(pairs[at:at + _build.MAX_PEERS], stream.cuda_stream)
        out.done()
    return list(out.local)


def _exchange(xs, mesh, moves: dict, cut) -> dict:
    """``(src, dst) -> cut(xs of src, moves[(src, dst)])`` for every move
    whose receiver is this rank's; a move between ranks goes through the
    host and gloo's point-to-point sends (one tag a move)."""
    loc = _local_index(mesh)
    got, ops = {}, []
    for (s, d), arg in moves.items():
        if d not in loc and s not in loc:
            continue
        if s in loc and d in loc:
            got[(s, d)] = cut(xs[loc[s]], arg)
            continue
        tag = s * mesh.size + d
        if s in loc:
            ops.append(dist.P2POp(
                dist.isend, cut(xs[loc[s]], arg).cpu().contiguous(),
                mesh.process_of(d), tag=tag))
        else:
            like = cut(xs[0], arg)
            buf = torch.empty(like.shape, dtype=like.dtype)
            got[(s, d)] = buf
            ops.append(dist.P2POp(dist.irecv, buf, mesh.process_of(s),
                                  tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got
