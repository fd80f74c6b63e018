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

K7b keeps the TPU kernel's schedule (``_a2a_kernel``): each sender's
pairs come in its symmetric order (:meth:`~dc_sand_tpu_torch.parallel.
mesh.Mesh.all_to_all_sends`), the pairs to other cards first, pair after
pair, and the pairs that stay on the sending card (an HBM copy) last, on
a CTA range of their own.  :func:`kernel_events` records CUDA events
around the launches alone (the kernel's time without the ordering around
it) or, across processes, around the whole call on the device, its flag
rounds included (what events around NCCL's call hold).

On a mesh over several processes (:func:`~dc_sand_tpu_torch.parallel.mesh.
build_global_mesh`) each rank passes and gets back its own shards only.
On the card the destinations are the receivers' persistent buffers
(``out``, a :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers`), and
the route of each pair of ranks is the mesh's
(:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.routes`):

* within a rank of several cards the sender's card writes into the
  receiver's card by peer access, as in one process;
* within a node the sender's launch writes into the receiver's buffer
  through a CUDA IPC mapping opened in the sending card's own context
  (:meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.target`), each
  rank launching the kernel once a card of its own that holds a sender,
  on that card's stream: every byte crosses NVLink once;
* across nodes (:mod:`.staged`) the sender copies each block, contiguous
  in its shard, whole from the card into a pinned host slot, the slots
  cross in gloo point-to-point sends, the receiver copies each slot whole
  back onto the card (a copy-engine transfer into its landing buffer),
  and the RECEIVER launches the same kernel on the receiving shard's
  card with the landed block as the source and its own buffer, at the
  sender's row offset and pitch, as the destination: the kernel, not a
  ``copy_``, places every block.

Every launch adds one to the op's ``launches`` (a receiver's launch across
nodes to its ``staged_launches`` as well); ``out.ready()`` before and
``out.done()`` after order the writes against every rank's reads in place
of the stream waits (device flags within a node, :mod:`.ipc`).  K7a's
rounds within a node are its ring's pairs only, as ``_ring_kernel``'s
semaphores are: a card waits only on its ring neighbours in other
ranks, its launch (``ring_rows``) writes each such receiver's ``sent``
flag itself once its stores have landed, and a pair inside a rank takes
a stream wait and no flag (``ring_permute_right.flag_rounds`` counts the
rounds that took one).  On CPU
tensors with ``out`` (a mesh whose peers are all on other nodes) the same
staged bookkeeping runs with the kernel's plain version
(:func:`place_rows_torch`) placing the blocks.  The plain
versions copy to the host and send the blocks between ranks over gloo
(``batch_isend_irecv``), the receiver interleaving them: bitwise the
one-process result over the same global mesh.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.parallel.staged import as_bytes

__all__ = ["ring_permute_right", "ring_permute_right_torch", "all_to_all",
           "all_to_all_torch", "place_rows_torch", "kernel_events",
           "events_ms"]

# (sender, receiver) card pairs whose peer access is on: like the CUDA
# state it mirrors, it holds for the whole process
_peers_enabled = set()

_events = None      # while kernel_events() is active: (span, the list)


@contextlib.contextmanager
def kernel_events(span: bool = False):
    """While active, each card's launches of K7a and K7b in a call are
    bracketed by a pair of CUDA events on its stream, after whatever the
    stream waits for; with ``span``, on a multi-process mesh, the events
    bracket the whole call on each card's stream instead, from before
    the flag round that precedes the writes (``out.ready()``) to after
    the one that follows them (``out.done()``), waits for the peers
    included.  Yields the list of ``(card, start, end)`` that
    :func:`events_ms` reads."""
    global _events
    got = []
    _events = (span, got)
    try:
        yield got
    finally:
        _events = None


def events_ms(events, calls: int) -> float:
    """The kernel's ms a call from :func:`kernel_events`' list over
    ``calls`` calls: each card's launches summed, the slowest card's."""
    per = {}
    for card, start, end in events:
        end.synchronize()
        per[card] = per.get(card, 0.0) + start.elapsed_time(end)
    return max(per.values()) / calls


@contextlib.contextmanager
def _bracket(cards, span):
    """Events on each of ``cards``' current streams around the body, where
    :func:`kernel_events` is active and ``span`` is its kind (None: either
    kind)."""
    if _events is None or span not in (None, _events[0]):
        yield
        return
    starts = []
    for card in cards:
        starts.append((card, torch.cuda.Event(enable_timing=True)))
        starts[-1][1].record(torch.cuda.current_stream(card))
    yield
    for card, start in starts:
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(card))
        _events[1].append((card, start, end))


def _remote_first(items, is_local) -> list:
    """Chunks of up to MAX_PEERS items: the items to other cards first, in
    their order, then those that stay on the card."""
    ordered = ([x for x in items if not is_local(x)]
               + [x for x in items if is_local(x)])
    return [ordered[at:at + _build.MAX_PEERS]
            for at in range(0, len(ordered), _build.MAX_PEERS)]


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
    :data:`~dc_sand_tpu_torch._build.MAX_PEERS` pairs on it (those to other
    cards first), and every such receiver's stream
    waits for it after."""
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
        # switching the device costs as much host time as the launch; in
        # one process the launches are the whole call
        with (torch.cuda.device(dev) if dev.index != current
              else contextlib.nullcontext()), _bracket([dev], None):
            for chunk in _remote_first(
                    pairs, lambda ij: outs[ij[1]].device == dev):
                launch(chunk, stream.cuda_stream)
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
                       impl: str = "auto", place: str = "kernel") -> list:
    """One ring step over ``axis`` (K7a): shard k of each group receives
    shard k-1's block, shard 0 shard n-1's.  Returns new tensors, each on
    its receiver's device; on a multi-process mesh,
    ``out.local`` after the kernel wrote into ``out`` (a
    :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` of the shards'
    shape, required on the card there and refused in one process; on the
    CPU it takes the staged route's bookkeeping).  ``place="copy"`` (with
    ``out``): the same route with each block placed by ``Tensor.copy_``
    (:func:`place_rows_torch`) in place of the launch, the yardstick the
    benches time beside the kernel."""
    _check(xs, mesh)
    plain = _impl(impl, xs) == "torch"
    if plain and (out is None or xs[0].is_cuda):
        return ring_permute_right_torch(xs, mesh, axis)
    _contiguous(xs)
    _out_for(mesh, out)
    loc = _local_index(mesh)
    xs_g = {d: xs[k] for d, k in loc.items()}
    nbytes = xs[0].numel() * xs[0].element_size()
    lib = _build.library() if not plain else None

    def launch(pairs, stream, staged=False, flags=None):
        _build.check(lib.dcs_ring(_pairs(pairs), len(pairs), nbytes,
                                  _ring_flags(flags), stream), "dcs_ring")
        ring_permute_right.launches += 1
        ring_permute_right.staged_launches += staged

    if out is not None:
        ring = tuple((g[k], g[(k + 1) % len(g)]) for g in mesh.groups(axis)
                     for k in range(len(g)))
        before = out.flagged_rounds
        got = _launch_shared(mesh, out, xs_g, mesh.ring_sends(axis), ring,
                             lambda i, j: (0, 0), (1, nbytes, nbytes),
                             _launcher(launch, plain, place), paired=True)
        ring_permute_right.flag_rounds += out.flagged_rounds - before
        return got
    outs = {d: torch.empty_like(xs_g[d]) for d in loc}
    _launch_by_card(mesh.ring_sends(axis), xs_g, outs,
                    lambda pairs, st: launch(
                        [(xs_g[i].data_ptr(), outs[j].data_ptr())
                         for i, j in pairs], st))
    return [outs[d] for d in mesh.local_shards]


ring_permute_right.launches = 0
ring_permute_right.staged_launches = 0     # of them, receivers' across nodes
ring_permute_right.flag_rounds = 0         # its rounds that took a flag word


def _ring_flags(flags) -> _build.RingFlags:
    """``(per-pair flag addresses, counters, value)`` or None -> the
    kernel's by-value signals (no flag: a plain copy)."""
    arg = _build.RingFlags()
    if flags is not None:
        addrs, count, value = flags
        for k, addr in enumerate(addrs):
            arg.flag[k] = addr
        arg.count, arg.value = count, value
    return arg


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
               impl: str = "auto", place: str = "kernel") -> list:
    """Direct-send all-to-all on the leading axis over ``axis`` (K7b):
    output row-block s of shard ``my`` is shard s's row-block ``my``; with
    ``rows > 1``, each row-block cut into ``rows`` rows, the receivers'
    outputs interleave the senders' rows (module docstring).  Returns new
    tensors of the shards' shape, each on its receiver's device; on a
    multi-process mesh, ``out.local`` after the kernel wrote into ``out``
    (a :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` of the
    shards' size, required on the card there and refused in one process;
    on the CPU it takes the staged route's bookkeeping).  ``place``: as
    :func:`ring_permute_right`'s."""
    _check(xs, mesh)
    groups = mesh.groups(axis)
    n = len(groups[0])
    block = _block(xs, n, rows)
    plain = _impl(impl, xs) == "torch"
    if plain and (out is None or xs[0].is_cuda):
        return all_to_all_torch(xs, mesh, axis, rows=rows)
    _contiguous(xs)
    _out_for(mesh, out)
    loc = _local_index(mesh)
    xs_g = {d: xs[k] for d, k in loc.items()}
    esize = xs[0].element_size()
    row_bytes = block // rows * esize
    pitch = n * row_bytes if rows > 1 else row_bytes
    pos = {i: k for group in groups for k, i in enumerate(group)}
    sends = mesh.all_to_all_sends(axis)
    lib = _build.library() if not plain else None

    def launch(pairs, stream, staged=False):
        _build.check(lib.dcs_all_to_all(_pairs(pairs), len(pairs), rows,
                                        row_bytes, pitch, stream),
                     "dcs_all_to_all")
        all_to_all.launches += 1
        all_to_all.staged_launches += staged

    def offsets(i, j):
        # sender i's row-block pos[j] -> receiver j, its rows from pos[i]
        return pos[j] * block * esize, pos[i] * row_bytes

    if out is not None:
        return _launch_shared(mesh, out, xs_g, sends,
                              [(i, j) for g in groups for i in g for j in g],
                              offsets, (rows, row_bytes, pitch),
                              _launcher(launch, plain, place))
    outs = {d: torch.empty_like(xs_g[d]) for d in loc}

    def by_card(pairs, stream):
        launch([(xs_g[i].data_ptr() + offsets(i, j)[0],
                 outs[j].data_ptr() + offsets(i, j)[1]) for i, j in pairs],
               stream)

    _launch_by_card(sends, xs_g, outs, by_card)
    return [outs[d] for d in mesh.local_shards]


all_to_all.launches = 0
all_to_all.staged_launches = 0     # of them, receivers' across nodes


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


def place_rows_torch(src: torch.Tensor, dst: torch.Tensor, offset: int,
                     rows: int, row_bytes: int, pitch: int) -> None:
    """Plain version of one pair of the peer-copy kernel: ``rows`` rows of
    ``row_bytes`` from the contiguous bytes ``src`` into the contiguous
    ``dst`` from byte ``offset`` on, ``pitch`` bytes apart."""
    flat = as_bytes(dst)
    flat.as_strided((rows, row_bytes), (pitch, 1),
                    flat.storage_offset() + offset).copy_(
        src.view(rows, row_bytes))


def staged_round(mesh, out, xs_g, sends, pairs, offsets, nbytes) -> list:
    """The exchange of a kernel's blocks between nodes (:mod:`.staged`):
    each block of this rank's senders (``sends``, as
    :func:`_launch_by_card` takes them) whose receiver lies on another node
    goes out of its pinned slot, and each block of ``pairs`` whose
    receiver is this rank's and whose sender another node's comes in.
    Returns ``(slot view, receiver, byte offset)`` for those; call
    ``out.staged.release()`` once they are placed."""
    n = mesh.size
    loc = _local_index(mesh)
    outgoing = [(i * n + j, mesh.process_of(j),
                 as_bytes(xs_g[i])[offsets(i, j)[0]:][:nbytes])
                for _, ps in sends for i, j in ps if out.remote(j)]
    incoming = [(i, j) for i, j in pairs if j in loc and out.remote(i)]
    got = out.staged.round(outgoing, [(i * n + j, mesh.process_of(i), nbytes)
                                      for i, j in incoming])
    return [(got[i * n + j], j, offsets(i, j)[1]) for i, j in incoming]


def _launch_shared(mesh, out, xs_g, sends, pairs, offsets, geometry,
                   launch, paired: bool = False) -> list:
    """The kernel over a multi-process mesh: ``sends`` holds this rank's
    senders grouped by their card (:meth:`~dc_sand_tpu_torch.parallel.
    mesh.Mesh.ring_sends`), ``pairs`` every (sender, receiver) pair of the
    op, ``offsets(i, j)`` the byte offsets of a pair's block in the
    sender's shard and in the receiver's buffer, ``geometry`` the rows,
    row bytes and destination pitch of a block.  Pairs whose receiver is
    on this node launch on the sender's card, one launch a card on its
    own stream, into this rank's own buffers (on another card by peer
    access) or into a peer's through its mapping in that card's context
    (:meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.target`);
    pairs across nodes go through :func:`staged_round`, land on the
    receiver's card and launch there.  With ``launch`` None (the CPU, or
    the ``copy_`` yardstick) :func:`place_rows_torch` stands for each
    launch, from the slots, and counts none.  ``out.ready()`` before and
    ``out.done()`` after order the writes against every rank's, and every
    card's, use of the buffers; ``paired`` (K7a) passes them ``pairs``,
    so that within a node a card waits only on the cards it is paired
    with and each launch signals its receivers itself
    (:meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.ready`)."""
    rows, row_bytes, _ = geometry
    nbytes = rows * row_bytes
    for card, ps in sends:
        for i, _ in ps:
            if xs_g[i].device != card:
                raise ValueError(f"shard {i} lies on {xs_g[i].device}, its "
                                 f"mesh device is {card}")
    # each block launches on its sender's card, which writes every
    # receiver of the node directly: the source is read in place (a whole
    # shard, K7a's block, as it is)
    here = {}
    for card, ps in sends:
        for i, j in ps:
            if not out.remote(j):
                src, (at, dst_at) = xs_g[i], offsets(i, j)
                if at or nbytes != src.numel() * src.element_size():
                    src = as_bytes(src)[at:][:nbytes]
                here.setdefault(card, []).append((src, j, dst_at))
    round_pairs = pairs if paired else None
    with _bracket(out.cards if out.cuda else [], True):
        out.ready(round_pairs)
        for card, blocks in here.items():
            _place(out, card, blocks, geometry, launch, signal=paired)
        if out.staged is not None:
            blocks = staged_round(mesh, out, xs_g, sends, pairs, offsets,
                                  nbytes)
            cards = [out.views[j].device for _, j, _ in blocks]
            if launch is not None:
                blocks = [(d, j, off) for d, (_, j, off) in zip(
                    out.staged.land([b for b, _, _ in blocks], cards),
                    blocks)]
            for card in dict.fromkeys(cards):
                _place(out, card, [b for b, c in zip(blocks, cards)
                                   if c == card], geometry, launch,
                       staged=True)
            out.staged.release()
        out.done(round_pairs)
    return list(out.local)


def _launcher(launch, plain: bool, place: str):
    """The kernel's launch, or None where :func:`place_rows_torch` places
    the blocks: on the CPU, or with ``place="copy"``."""
    if place not in ("kernel", "copy"):
        raise ValueError(f"place is 'kernel' or 'copy', got {place!r}")
    return None if plain or place == "copy" else launch


def _place(out, card, blocks, geometry, launch, staged: bool = False,
           signal: bool = False) -> None:
    """``(source, receiver, byte offset)`` blocks (a source's bytes, each
    on ``card``) into ``out``'s buffers, launched on ``card``'s current
    stream: the kernel's ``launch`` (up to
    :data:`~dc_sand_tpu_torch._build.MAX_PEERS` pairs a launch, those to
    other cards first, each destination at its address in ``card``'s
    context; ``staged`` counts them as the receiver's launches across
    nodes), or with ``launch`` None its plain version.  ``signal`` (K7a):
    the launch writes the ``sent`` flags of its receivers in other ranks
    (:meth:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers.ring_flags`),
    all of them in one launch; the plain version's stream writes them
    after its copies."""
    if not blocks:
        return
    if launch is None:
        # a copy into a peer's view must run on the view's card, where its
        # address is valid: a source on another card goes there first (the
        # torch copy runs on the source's card)
        for src, j, off in blocks:
            to = out.views[j].device
            if src.is_cuda and src.device != to:
                src = src.to(to)
            place_rows_torch(as_bytes(src), out.views[j], off, *geometry)
        if signal and out.cuda:
            stream = torch.cuda.current_stream(card)
            for to in {out.views[j].device for _, j, _ in blocks} - {card}:
                stream.wait_stream(torch.cuda.current_stream(to))
            out.signal_sent(card, [j for _, j, _ in blocks])
        return
    mine = out.mesh.rank
    local = {}
    for src, j, _ in blocks:
        if src.device != card:
            raise ValueError(f"a block's source lies on {src.device}, its "
                             f"launch on {card}")
        own = out.mesh.process_of(j) == mine
        if own:
            _enable_peer(card, out.views[j].device)
        local[j] = own and out.views[j].device == card
    if signal and len(blocks) > _build.MAX_PEERS:
        raise ValueError(f"K7a signals its receivers from one launch a "
                         f"card: {len(blocks)} blocks on {card}, at most "
                         f"{_build.MAX_PEERS}")
    ptrs = [(src.data_ptr(), out.target(j, card) + off, local[j], j)
            for src, j, off in blocks]
    # switching the device costs as much host time as the launch
    with (torch.cuda.device(card) if card.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(card)
        with _bracket([card], False):
            for chunk in _remote_first(ptrs, lambda p: p[2]):
                pairs = [p[:2] for p in chunk]
                if signal:
                    launch(pairs, stream.cuda_stream, staged,
                           out.ring_flags(card, [p[3] for p in chunk]))
                else:
                    launch(pairs, stream.cuda_stream, staged)


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
