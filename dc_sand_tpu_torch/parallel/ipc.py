"""Card buffers that every rank of a multi-process mesh can address.

The TPU kernels K7a and K7b (``dc_sand_tpu/parallel/remote_dma.py``) copy
into another chip's memory by its device id and signal DMA semaphores.
Across processes on Hopper the counterpart is a CUDA IPC mapping: each
rank allocates its shards' buffers of one role once (the corner-turn's
CMAC operand, the halo, the partial beams, the accumulator), exports
their IPC handles, and every other rank of its node maps them into its
own address space (lazy peer access), so that a kernel of one process
writes into, or a sum reads from, the memory of another.

The semaphores are device flags, ordered on the cards with the host
taking no part.  Each card of each rank has a small ``uint32`` flag
buffer of its own allocation (:class:`FlagPlan` lays out its slots: one a
writing card of the mesh and kind), exported and mapped like the data
buffers into the context of every card of the node's other ranks.  Two
kinds of round stand for the semaphores:

* ``consumed`` (:meth:`SharedBuffers.ready`): after the work that reads
  the buffers (the CMAC, the halo's use, a sum), so that a writer waits
  before it overwrites them;
* ``sent`` (:meth:`SharedBuffers.done`): after the work that writes them,
  so that a reader waits before it reads.

Each round of a kind carries the next number of a sequence that every
rank counts alike (every rank calls its collectives in the same order):
each card's stream writes it into its slot of every peer card's buffer
(``cuStreamWriteValue32``, whose default memory barrier makes the
kernel's NVLink stores visible first), then waits until every peer
card's slot in its own buffer reads at least that number
(``cuStreamWaitValue32``, ">=" in the driver's cyclic comparison).  A
peer that is a round ahead satisfies the wait as well, so no slot is
reset and no wait can pass on a stale round.  The waits are stream
operations, not a spinning kernel, so ranks that time-slice one card
still take turns.  A card without the driver's stream memory operations
raises: nothing falls back to a host barrier.  Within a rank, cards
order each other with stream waits.

K7a's semaphores are pairwise, as the TPU kernel's one ``send_sem`` and
``recv_sem`` pair a copy's two ends: its ``ready`` and ``done`` take the
ring's (sender, receiver) pairs (:meth:`FlagPlan.paired`).  A card then
writes a ``consumed`` word only into the cards that write into it, waits
only on the cards it writes into, and before it reads waits only on its
senders' ``sent`` words, which the kernel writes itself once its stores
have landed (``ring_rows`` of ``csrc/remote_dma.cu``: put with signal,
the counterpart of the DMA engine signalling ``recv_sem``; a failed
launch raises, and nothing writes them in its place).  A word that a
launched kernel never writes is not caught on the main path: the
receiver's stream waits on it for good, so the call hangs rather than
raises.  :meth:`SharedBuffers.check_signals`, after the cards are
synchronised, is the check that raises (``chip_smoke.py`` and the card
tests call it).  A pair inside a
rank takes no word: stream waits order it, card to card, so a ring that
stays inside each rank (``time_local``) takes no flag at all.  Every
rank numbers each round all the same, so the sequence stays aligned.
K7b, the sums, and every round of a mesh that spans nodes keep the
node-wide rounds above.

The mapping reaches the processes of one node only.  A rank of another
node (:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.routes`, from the node
map of :func:`~dc_sand_tpu_torch.parallel.distributed.init_distributed`)
gets the staged role instead (:mod:`.staged`): no handle is opened for
it, and :attr:`SharedBuffers.views` holds, for each of its shards, a
local mirror that :meth:`SharedBuffers.fetch` fills for readers (None
until a read needs it); a writer sends its blocks there through
:attr:`SharedBuffers.staged`, and the receiver places them into its own
buffer.  Where the mesh has such a rank every round also takes a gloo
barrier, as before the flags; their host time adds up in
:attr:`SharedBuffers.barrier_s` (count :attr:`SharedBuffers.barriers`),
which within a node stays at 0.  On CPU tensors a mesh whose peers are
all on other nodes takes the staged role (the CPU tests hold its
bookkeeping); IPC and the flags are the card's.

A rank may hold several cards (:func:`~dc_sand_tpu_torch.parallel.
distributed.local_cards`): each shard's buffer lies on its own card.  On
the H100 machine an IPC handle is used only in the context of the card
that uses it, as NCCL does (a mapping opened in another card's context
faults when written).  So every mapping is the port's own,
``dcs_ipc_open`` of ``csrc/remote_dma.cu`` in the context of the card
that uses it, once a handle and card (PyTorch's ``rebuild_cuda_tensor``
keeps one mapping a handle for the whole process, on the exporter's
device index):

* :attr:`SharedBuffers.views` maps a peer's k-th shard into this rank's
  k-th card, for the readers, wrapped as a tensor on that card through
  a DLPack capsule (:func:`pointer_view`);
* a card that writes into a peer's shard gets its own mapping of it
  (:meth:`SharedBuffers.target`), so that K7b and K7a launch on the
  sender's card and every byte crosses NVLink once;
* a peer card's flag buffer is mapped into each of this rank's cards.

None depends on the exporter's card index, so the ranks of a node need
not number the cards alike.  Two processes on one card time-slice it:
they run correctly, not side by side.  A handle that will not open
raises, and so does a staged exchange that fails; neither route stands
in for the other.  Peers' buffers stay mapped until :func:`close_all`,
which every rank calls before it exits (the exporter keeps its memory
alive until then); a view of a peer's buffer is not used after it.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time

import torch
import torch.distributed as dist

from dc_sand_tpu_torch._build import MAX_PEERS
from dc_sand_tpu_torch.parallel.staged import StagedRoute

__all__ = ["SharedBuffers", "FlagPlan", "close_all", "uses_shared_buffers",
           "stream_memops", "pointer_view", "shard_places"]

_OPEN = []      # every SharedBuffers of this process, held until close_all
_MEMOPS = {}    # card -> (stream memory operations, remote-write flush)
_CAPSULES = []  # every pointer_view's DLPack structures (read at its free)
_MAPS = {}      # (IPC handle, card) -> its mapping in the card's context
HANDLE_BYTES = 64   # sizeof(cudaIpcMemHandle_t)
CONSUMED, SENT = 0, 1


def _check_alloc_conf() -> None:
    """Raise when the caching allocator's expandable segments are on:
    their memory cannot be exported with ``cudaIpcGetMemHandle``."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + "," + \
        os.environ.get("PYTORCH_ALLOC_CONF", "")
    if "expandable_segments:true" in conf.replace(" ", "").lower():
        raise RuntimeError(
            "PYTORCH_CUDA_ALLOC_CONF sets expandable_segments:True, whose "
            "memory CUDA IPC cannot export; unset it for a multi-process "
            "mesh on the card")


def _lib():
    from dc_sand_tpu_torch import _build
    return _build.library()


def _check(err: int, what: str) -> None:
    from dc_sand_tpu_torch import _build
    _build.check(err, what)


def stream_memops(card: torch.device) -> tuple:
    """``(memops, flush)``: the driver's
    ``CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1`` and
    ``CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES`` of ``card``, once a
    write and a ">=" wait on a word of its memory have run on its stream
    (checked once a card and process).  Raises where the driver lacks the
    stream memory operations or they fail: the device flags need them,
    and nothing stands in for them.

    The run, not the first attribute, decides: on the H100 machine (CUDA
    12.8 driver) both attributes read 0 while the ``_v2`` entry points run
    (the first reports the legacy v1 ones, which a CUDA 12 driver leaves
    off).  The waits take no flush: the order of the writes comes from the
    writer's side, whose flag write follows a system-wide memory barrier
    (``cuStreamWriteValue32``'s default), so a reader that sees the flag
    sees the kernel's stores before it."""
    if card not in _MEMOPS:
        word = torch.zeros(1, dtype=torch.int32, device=card)
        memops, flush = ctypes.c_int(-1), ctypes.c_int(-1)
        with torch.cuda.device(card):
            err = _lib().dcs_memops_probe(
                card.index, ctypes.byref(memops), ctypes.byref(flush),
                word.data_ptr(), torch.cuda.current_stream(card).cuda_stream)
            if err == 0:
                torch.cuda.synchronize(card)
        if err != 0 or word.item() != 1:
            raise RuntimeError(
                f"{card}: the driver's stream memory operations "
                f"(cuStreamWriteValue32 / cuStreamWaitValue32) failed "
                f"(error {err}); the device flags that order the ranks of "
                "a node need them")
        _MEMOPS[card] = (memops.value, flush.value)
    return _MEMOPS[card]


def _current(card: torch.device):
    """``card`` made the current device, unless it is."""
    if card.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(card)


def _export(t: torch.Tensor) -> tuple:
    """``(handle, offset)``: the IPC handle of the allocation that holds
    ``t`` and ``t``'s byte offset in it."""
    handle = ctypes.create_string_buffer(HANDLE_BYTES)
    offset = ctypes.c_longlong()
    with torch.cuda.device(t.device):
        _check(_lib().dcs_ipc_handle(t.data_ptr(), handle,
                                     ctypes.byref(offset)), "dcs_ipc_handle")
    return handle.raw, offset.value


def _ipc_open(handle: bytes, card: torch.device, what: str) -> int:
    """A peer's allocation mapped into ``card``'s context, the card whose
    kernels and streams use it (not the exporter's device index); its
    address.  Mapped once a handle and card for the process (two buffers
    may share an allocation), until :func:`close_all`."""
    if (handle, card) not in _MAPS:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(card):
            err = _lib().dcs_ipc_open(handle, ctypes.byref(ptr))
        if err != 0:
            raise RuntimeError(f"{what} did not open through CUDA IPC in "
                               f"{card}'s context: CUDA error {err}")
        _MAPS[(handle, card)] = ptr.value
    return _MAPS[(handle, card)]


class _DLDevice(ctypes.Structure):
    _fields_ = [("device_type", ctypes.c_int32),
                ("device_id", ctypes.c_int32)]


class _DLDataType(ctypes.Structure):
    _fields_ = [("code", ctypes.c_uint8), ("bits", ctypes.c_uint8),
                ("lanes", ctypes.c_uint16)]


class _DLTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("device", _DLDevice),
                ("ndim", ctypes.c_int32), ("dtype", _DLDataType),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("strides", ctypes.POINTER(ctypes.c_int64)),
                ("byte_offset", ctypes.c_uint64)]


class _DLManagedTensor(ctypes.Structure):
    _fields_ = [("dl_tensor", _DLTensor), ("manager_ctx", ctypes.c_void_p),
                ("deleter", ctypes.c_void_p)]


def _dlpack(address: int, nbytes: int, device: torch.device):
    """The DLPack description of the ``nbytes`` bytes at ``address`` as a
    1-D uint8 tensor on ``device`` (``kDLCPU`` 1, ``kDLCUDA`` 2), with no
    deleter: the memory is not the tensor's."""
    shape = (ctypes.c_int64 * 1)(nbytes)
    managed = _DLManagedTensor()
    managed.dl_tensor = _DLTensor(
        address, _DLDevice(2 if device.type == "cuda" else 1,
                           device.index or 0),
        1, _DLDataType(1, 8, 1), shape, None, 0)
    return managed, shape


def pointer_view(address: int, nbytes: int, device: torch.device
                 ) -> torch.Tensor:
    """The ``nbytes`` bytes at ``address`` as a uint8 tensor that names
    ``device`` (a peer's buffer mapped into that card's context by
    ``dcs_ipc_open``), through a DLPack capsule: PyTorch takes the device
    from the capsule, not from the pointer.  The memory stays the
    mapper's; the capsule's structures are kept for the process, since
    PyTorch reads them when the tensor is freed."""
    managed, shape = _dlpack(address, nbytes, device)
    _CAPSULES.append((managed, shape))
    new = ctypes.pythonapi.PyCapsule_New
    new.restype = ctypes.py_object
    new.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p]
    return torch.from_dlpack(new(ctypes.addressof(managed), b"dltensor",
                                 None))


def uses_shared_buffers(mesh) -> bool:
    """True when the collectives of ``mesh`` go through
    :class:`SharedBuffers`: a multi-process mesh on the card, or on the
    CPU one whose peers are all on other nodes (the staged route's
    bookkeeping).  Otherwise (one process, or CPU ranks of one node) the
    plain versions run, over gloo across processes."""
    if not mesh.multiprocess:
        return False
    return (mesh.local_devices[0].type == "cuda"
            or set(mesh.routes().values()) == {"staged"})


def _cards_of(mesh, rank: int) -> list:
    """The distinct devices of ``rank``'s shards, in the order of their
    first shard, as that rank named them (its ``Mesh.local_cards``)."""
    flat = mesh.flat_devices
    return list(dict.fromkeys(flat[d] for d in mesh.shards_of(rank)))


def shard_places(mesh) -> dict:
    """Each shard of ``mesh`` -> ``(its rank, the index of its card among
    that rank's cards)``: how :class:`FlagPlan` names a card."""
    cards = [_cards_of(mesh, r) for r in range(mesh.process_count)]
    flat = mesh.flat_devices
    return {d: (mesh.process_of(d), cards[mesh.process_of(d)].index(flat[d]))
            for d in range(mesh.size)}


class FlagPlan:
    """The slots of one role's device flags, for one rank: pure
    bookkeeping, no device.  Every card of every rank has a flag buffer
    of ``2 * width`` words, ``width`` the cards of the whole mesh; the word
    of kind ``which`` (:data:`CONSUMED` or :data:`SENT`) written by card
    ``k`` of rank ``r`` is ``which * width + base[r] + k``.  Each card of
    this rank writes its slot of every card of ``peers`` (the ranks of its
    node) and waits on those peer cards' slots in its own buffer.
    :meth:`next` numbers a kind's rounds, alike on every rank.

    ``counts``: the number of cards of each rank, in rank order."""

    def __init__(self, counts, rank: int, peers):
        self.counts = list(counts)
        self.rank = rank
        self.peers = sorted(peers)
        self.width = sum(self.counts)
        self.base = [sum(self.counts[:r]) for r in range(len(self.counts))]
        self.seq = [0, 0]

    def slot(self, which: int, rank: int, k: int) -> int:
        """The word that card ``k`` of ``rank`` writes, of kind
        ``which``."""
        return which * self.width + self.base[rank] + k

    def signals(self, which: int, k: int) -> list:
        """``(peer rank, its card, word)``: where this rank's card ``k``
        writes a round of kind ``which``."""
        return [(r, c, self.slot(which, self.rank, k)) for r in self.peers
                for c in range(self.counts[r])]

    def waits(self, which: int) -> list:
        """The words of a card's own buffer that it waits on in a round of
        kind ``which``: every peer card's."""
        return [self.slot(which, r, c) for r in self.peers
                for c in range(self.counts[r])]

    def next(self, which: int) -> int:
        """The number of the next round of kind ``which`` (1, 2, ...; the
        driver's ">=" is cyclic, so it may wrap)."""
        self.seq[which] = self.upcoming(which)
        return self.seq[which]

    def upcoming(self, which: int) -> int:
        """The number that :meth:`next` will give, without taking it (what
        K7a's kernel writes before the round that waits on it)."""
        return (self.seq[which] + 1) & 0xFFFFFFFF

    def paired(self, which: int, pairs, where) -> tuple:
        """K7a's round of kind ``which`` over its ``(sender, receiver)``
        shard ``pairs``, as ``_ring_kernel``'s semaphores pair a copy's two
        ends: ``(signals, waits)``, dicts from a card of this rank (its
        index) to what it writes, ``(peer rank, its card, word)``, and to
        the words of its own buffer that it waits on.  The word's writer is
        the receiver in a :data:`CONSUMED` round (its sender waits before it
        overwrites) and the sender in a :data:`SENT` round (its receiver
        waits before it reads), at the writer's slot, so each word keeps one
        writer.  Only a pair whose ends lie in this rank and in one of
        ``peers`` takes a word; a pair inside a rank takes none.
        ``where(d)``: ``(rank, card index)`` of shard ``d``."""
        peers = set(self.peers)
        signals, waits = {}, {}
        for i, j in pairs:
            ends = (where(j), where(i)) if which == CONSUMED else \
                (where(i), where(j))
            (rw, cw), (rr, cr) = ends
            word = self.slot(which, rw, cw)
            if rw == self.rank and rr in peers:
                signals.setdefault(cw, set()).add((rr, cr, word))
            elif rr == self.rank and rw in peers:
                waits.setdefault(cr, set()).add(word)
        return ({k: sorted(v) for k, v in signals.items()},
                {k: sorted(v) for k, v in waits.items()})


class SharedBuffers:
    """One persistent buffer of ``shape`` and ``dtype`` per shard of a
    multi-process ``mesh``, zeroed, each on its shard's card (a rank may
    hold several: :attr:`cards`), with the buffers of every rank of its
    node mapped in, device flags to order them, and a staged route to the
    ranks of other nodes.

    :attr:`local` lists this rank's buffers in :attr:`Mesh.local_shards`
    order; :attr:`views` has one tensor per shard of the mesh (this rank's
    own, on whichever of its cards, its node's peers' IPC mappings, other
    nodes' mirrors).  A peer's k-th shard's view is mapped into this
    rank's k-th card (mod their count), whose device it names; a kernel
    that writes into a shard takes its address in the sender's card from
    :meth:`target`.  Collective: every rank builds it with the same
    arguments, in the same order as its other collectives.
    """

    barrier_s = 0.0     # host seconds in the barriers, all instances
    barriers = 0
    flag_rounds = 0     # rounds ordered by device flags, all instances

    def __init__(self, mesh, shape, dtype: torch.dtype):
        if not mesh.multiprocess:
            raise ValueError("SharedBuffers spans the ranks of a "
                             "multi-process mesh")
        routes = mesh.routes()
        ipc = sorted(r for r, how in routes.items() if how == "ipc")
        staged = sorted(r for r, how in routes.items() if how == "staged")
        self.cards = mesh.local_cards
        kinds = {d.type for d in self.cards}
        # the CPU takes the staged route's bookkeeping only
        if kinds != {"cuda"} and (ipc or kinds != {"cpu"}):
            raise ValueError(f"the IPC route is the card's, got "
                             f"{[str(d) for d in self.cards]}")
        self.cuda = kinds == {"cuda"}
        if self.cuda:
            for dev in self.cards:
                if not torch.cuda.is_available() or dev.index >= \
                        torch.cuda.device_count():
                    raise RuntimeError(f"rank {mesh.rank}: its card {dev} "
                                       "is not present")
            if ipc:
                _check_alloc_conf()
        self.mesh, self.device = mesh, self.cards[0]
        self.local = [torch.zeros(tuple(shape), dtype=dtype, device=dev)
                      for dev in mesh.local_devices]
        self.plan = None        # FlagPlan where the node has other ranks
        self._own_flags = {}    # card -> its flag buffer's address
        self._maps = {}         # (shard, card) -> a peer shard's address
        self._peer_flags = {}   # (card, rank, its card) -> mapped in card's
        self._counts = {}       # card -> K7a's counters (ring_rows)
        self._plans = {}        # K7a's pairs -> their rounds (_paired_round)
        self._active = None     # the pairs of the K7a call in progress
        self._last_sent = None  # (seq, {card: words}) of its last SENT wait
        self.flagged_rounds = 0  # this instance's rounds that took a flag
        self.waited = {}        # card -> flag words it waited on, here
        self._events = {}       # (card, other card) -> an event reused
        mine = None
        if ipc:
            counts = [len(_cards_of(mesh, r))
                      for r in range(mesh.process_count)]
            self.plan = FlagPlan(counts, mesh.rank, ipc)
            flags = []
            for dev in self.cards:
                stream_memops(dev)
                ptr, handle = ctypes.c_void_p(), \
                    ctypes.create_string_buffer(HANDLE_BYTES)
                with torch.cuda.device(dev):
                    _check(_lib().dcs_flags_alloc(
                        8 * self.plan.width, ctypes.byref(ptr), handle),
                        "dcs_flags_alloc")
                self._own_flags[dev] = ptr.value
                flags.append(handle.raw)
            mine = ([_export(t) for t in self.local], flags)
            for dev in self.cards:
                torch.cuda.synchronize(dev)
        every = [None] * mesh.process_count
        dist.all_gather_object(every, mine)
        self.views = [None] * mesh.size
        for d, t in zip(mesh.local_shards, self.local):
            self.views[d] = t
        self._raw = {}          # a peer's shard -> (handle, offset)
        peer_flags = {}         # (rank, card k) -> flag handle
        nbytes = self.local[0].numel() * self.local[0].element_size()
        for rank in ipc:
            raw, flags = every[rank]
            shards = mesh.shards_of(rank)
            if len(raw) != len(shards):
                raise ValueError(f"rank {rank} exported {len(raw)} "
                                 f"buffers for {len(shards)} shards")
            for k, (d, h) in enumerate(zip(shards, raw)):
                self._raw[d] = h
                # the peer's k-th shard on this rank's k-th card (mod)
                on = self.cards[k % len(self.cards)]
                self.views[d] = pointer_view(self.target(d, on), nbytes,
                                             on).view(dtype).view(shape)
            peer_flags.update({(rank, k): h for k, h in enumerate(flags)})
        self._signal, self._wait = {}, {}
        if self.plan is not None:
            # each card writes into every peer card's buffer through a
            # mapping of its own context, and waits on its own buffer
            for k, dev in enumerate(self.cards):
                mapped = {}
                for key, h in peer_flags.items():
                    mapped[key] = _ipc_open(h, dev, f"rank {key[0]}'s flags "
                                            f"of its card {key[1]}")
                    self._peer_flags[(dev, *key)] = mapped[key]
                self._counts[dev] = torch.zeros(MAX_PEERS,
                                                dtype=torch.int32, device=dev)
                self.waited[dev] = 0
                for which in (CONSUMED, SENT):
                    sig = [mapped[(r, c)] + 4 * w
                           for r, c, w in self.plan.signals(which, k)]
                    own = self._own_flags[dev]
                    wait = [own + 4 * w for w in self.plan.waits(which)]
                    self._signal[(dev, which)] = (
                        (ctypes.c_ulonglong * len(sig))(*sig), len(sig))
                    self._wait[(dev, which)] = (
                        (ctypes.c_ulonglong * len(wait))(*wait), len(wait))
        self._remote = frozenset(d for r in staged for d in mesh.shards_of(r))
        self.staged = StagedRoute(self.cards) if staged else None
        self._where = shard_places(mesh)
        # K7a's rounds are its ring's pairs where every peer shares the node
        self._pairwise = self.plan is not None and self.staged is None
        _OPEN.append(self)

    def target(self, d: int, card: torch.device) -> int:
        """The address at which ``card``'s kernels write, or its streams
        read, shard ``d``'s buffer: this rank's own (another of its cards
        by peer access), or a peer's of this node mapped into ``card``'s
        own context (at the first use, kept until :func:`close_all`)."""
        if self.mesh.process_of(d) == self.mesh.rank:
            return self.views[d].data_ptr()
        if (d, card) not in self._maps:
            handle, offset = self._raw[d]
            self._maps[(d, card)] = _ipc_open(
                handle, card, f"rank {self.mesh.process_of(d)}'s buffer of "
                f"shard {d}") + offset
        return self._maps[(d, card)]

    def remote(self, d: int) -> bool:
        """True when shard ``d`` lies on another node (the staged role)."""
        return d in self._remote

    def _round(self, which: int, pairs=None) -> None:
        """One round of kind ``which``: the flags within the node, a gloo
        barrier where the mesh has ranks on other nodes, then each card's
        stream waits for the rank's other cards'.  With K7a's ``pairs``
        (:meth:`_paired`) the round is :meth:`_paired_round`."""
        if pairs is not None:
            self._paired_round(which, pairs)
            return
        streams = ([torch.cuda.current_stream(dev) for dev in self.cards]
                   if self.cuda else [])
        lib = _lib() if self.plan is not None else None
        if lib is not None:
            seq = self.plan.next(which)
            for dev, stream in zip(self.cards, streams):
                addrs, n = self._signal[(dev, which)]
                # the driver checks the addresses in the current context
                with _current(dev):
                    _check(lib.dcs_signal(stream.cuda_stream, addrs, n, seq),
                           "dcs_signal")
        if self.staged is not None:
            t = time.perf_counter()
            dist.barrier()
            SharedBuffers.barrier_s += time.perf_counter() - t
            SharedBuffers.barriers += 1
        if lib is not None:
            for dev, stream in zip(self.cards, streams):
                addrs, n = self._wait[(dev, which)]
                with _current(dev):
                    _check(lib.dcs_wait(stream.cuda_stream, addrs, n, seq),
                           "dcs_wait")
                self.waited[dev] += n
            self.flagged_rounds += 1
            SharedBuffers.flag_rounds += 1
        for stream in streams:
            # the rank's other cards: a card writes into, or reads, another's
            for other in streams:
                if other is not stream:
                    stream.wait_stream(other)

    def _paired_plan(self, pairs: tuple) -> dict:
        """K7a's rounds over ``pairs``, by kind, for each card of this rank:
        ``(signal addresses, their count, wait addresses, the words waited
        on, the rank's cards whose streams it waits for)``, kept per
        pairs."""
        if pairs not in self._plans:
            rank, got = self.mesh.rank, {}
            for which in (CONSUMED, SENT):
                signals, waits = self.plan.paired(which, pairs,
                                                  self._where.__getitem__)
                per = {}
                for k, dev in enumerate(self.cards):
                    sig = [self._peer_flags[(dev, r, c)] + 4 * w
                           for r, c, w in signals.get(k, ())]
                    words = waits.get(k, [])
                    wait = [self._own_flags[dev] + 4 * w for w in words]
                    # inside the rank, card to card: the sender's stream
                    # waits for its receiver's before it writes (consumed),
                    # the receiver's for its sender's before it reads (sent)
                    deps = set()
                    for i, j in pairs:
                        (ri, ci), (rj, cj) = self._where[i], self._where[j]
                        if ri == rank == rj and ci != cj:
                            me, other = (ci, cj) if which == CONSUMED \
                                else (cj, ci)
                            if me == k:
                                deps.add(other)
                    per[dev] = ((ctypes.c_ulonglong * len(sig))(*sig),
                                len(sig),
                                (ctypes.c_ulonglong * len(wait))(*wait),
                                words, [self.cards[c] for c in sorted(deps)])
                got[which] = per
            self._plans[pairs] = got
        return self._plans[pairs]

    def _paired_round(self, which: int, pairs: tuple) -> None:
        """K7a's round of kind ``which`` (:meth:`FlagPlan.paired`): each
        card writes only the words of the cards of other ranks that it is
        paired with, and waits only on theirs; a pair inside the rank is
        ordered by a stream wait, card to card, or by the stream of its
        one card.  A ``consumed`` round's words are stream writes; a
        ``sent`` round's the kernel wrote (:meth:`ring_flags`), so here
        only the waits are left.  Every rank numbers the round, flagged or
        not, so that the sequence stays aligned."""
        plan = self._paired_plan(pairs)[which]
        seq = self.plan.next(which)
        lib = _lib()
        streams = {dev: torch.cuda.current_stream(dev) for dev in self.cards}
        flagged = False
        for dev in self.cards:
            sig, n_sig = plan[dev][:2]
            flagged = flagged or n_sig > 0
            if which == CONSUMED and n_sig:
                with _current(dev):
                    _check(lib.dcs_signal(streams[dev].cuda_stream, sig,
                                          n_sig, seq), "dcs_signal")
        for dev in self.cards:
            _, _, wait, words, deps = plan[dev]
            if words:
                flagged = True
                with _current(dev):
                    _check(lib.dcs_wait(streams[dev].cuda_stream, wait,
                                        len(words), seq), "dcs_wait")
                self.waited[dev] += len(words)
            for other in deps:
                # an event of its own a pair of cards, recorded anew each
                # round (a wait takes the event as it stands when enqueued)
                ev = self._events.get((dev, other))
                if ev is None:
                    ev = self._events[(dev, other)] = torch.cuda.Event()
                ev.record(streams[other])
                streams[dev].wait_event(ev)
        if which == SENT:
            self._last_sent = (seq, {dev: plan[dev][3] for dev in self.cards})
        if flagged:
            self.flagged_rounds += 1
            SharedBuffers.flag_rounds += 1

    def ring_flags(self, card: torch.device, receivers):
        """Within K7a's paired round (between :meth:`ready` and :meth:`done`
        with its pairs), K7a's signals for a launch on ``card`` of blocks
        for shards ``receivers``: ``(flags, counters, value)``, for each
        receiver in order the address in ``card``'s context of the word
        the launch writes once its block has landed (``card``'s ``sent``
        slot in the buffer of the receiver's card; None for this rank's
        own), the card's counters and the number of the ``sent`` round the
        launch completes.  None outside such a round."""
        if self._active is None:
            return None
        rank = self.mesh.rank
        word = 4 * self.plan.slot(SENT, rank, self.cards.index(card))
        flags = []
        for j in receivers:
            rj, cj = self._where[j]
            flags.append(None if rj == rank
                         else self._peer_flags[(card, rj, cj)] + word)
        return (flags, self._counts[card].data_ptr(),
                self.plan.upcoming(SENT))

    def signal_sent(self, card: torch.device, receivers) -> None:
        """Write, on ``card``'s stream, the ``sent`` words that its launch
        for ``receivers`` would write: the ``copy_`` yardstick, which has no
        kernel to signal (K7a itself never takes this path)."""
        got = self.ring_flags(card, receivers)
        flags = sorted({f for f in got[0] if f is not None}) if got else []
        if flags:
            with _current(card):
                _check(_lib().dcs_signal(
                    torch.cuda.current_stream(card).cuda_stream,
                    (ctypes.c_ulonglong * len(flags))(*flags), len(flags),
                    got[2]), "dcs_signal")

    def check_signals(self) -> None:
        """After the cards are synchronised: raise unless K7a's kernel
        signals landed, every counter back at 0 and every ``sent`` word
        that this rank's cards last waited on at least that round's
        number (the stream waits passed on them)."""
        for dev in self.cards:
            torch.cuda.synchronize(dev)
        for dev, count in self._counts.items():
            if int(count.count_nonzero()):
                raise RuntimeError(f"rank {self.mesh.rank}: K7a's counters "
                                   f"on {dev} read {count.tolist()}, not 0")
        if self._last_sent is None:
            return
        seq, words = self._last_sent
        for dev in self.cards:
            flags = pointer_view(self._own_flags[dev], 8 * self.plan.width,
                                 dev).view(torch.int32).cpu()
            for w in words[dev]:
                got = int(flags[w]) & 0xFFFFFFFF
                if (got - seq) & 0xFFFFFFFF >= 1 << 31:
                    raise RuntimeError(
                        f"rank {self.mesh.rank}: {dev}'s sent word {w} reads "
                        f"{got}, behind round {seq}")

    def _paired(self, pairs):
        """``pairs`` as a tuple where K7a's paired rounds apply (a mesh
        within one node), else None (a node-wide round)."""
        return tuple(pairs) if pairs is not None and self._pairwise else None

    def ready(self, pairs=None) -> None:
        """Before writing into any rank's buffers: each of this rank's
        cards signals that its reads so far are done (``consumed``), and
        its stream waits for every peer card's signal of the same round
        and for the rank's other cards'.  K7a passes its ``(sender,
        receiver)`` shard ``pairs`` (:meth:`_paired_round`): then a card
        signals only the cards that write into it and waits only on those
        it writes into, and its launch signals ``sent`` itself
        (:meth:`ring_flags`).  Each of the buffers written in such a round
        is read by its own rank only."""
        self._active = self._paired(pairs)
        self._round(CONSUMED, self._active)

    def done(self, pairs=None) -> None:
        """After the writes: each card signals ``sent``, and its stream
        waits for every peer card's writes of the round and for the
        rank's other cards' before it reads; with K7a's ``pairs`` only for
        its senders' (their kernels signalled)."""
        self._round(SENT, self._paired(pairs))
        self._active = None

    def fetch(self, need) -> None:
        """Fill the mirrors of the other nodes' shards that this rank
        reads, after :meth:`done`.  ``need(rank)`` gives what reader
        ``rank`` reads: ``{shard: region}``, a region None for the whole
        shard or ``(dim, start, length)``.  This rank sends each reader of
        another node its regions of this rank's shards (each crosses once
        a reader) and receives its own; the mirrors fill on the current
        stream.  Collective: every rank calls it with the same ``need``."""
        mesh = self.mesh
        mine = {d: k for k, d in enumerate(mesh.local_shards)}
        n = mesh.process_count
        outgoing = []
        for r, how in mesh.routes().items():
            if how == "staged":
                outgoing += [(s * n + r, r,
                              _region(self.local[mine[s]], reg).contiguous())
                             for s, reg in need(r).items() if s in mine]
        land, incoming = [], []
        for s, reg in need(mesh.rank).items():
            if s in self._remote:
                if self.views[s] is None:
                    self.views[s] = torch.zeros_like(self.local[0])
                view = _region(self.views[s], reg)
                land.append((s * n + mesh.rank, view))
                incoming.append((s * n + mesh.rank, mesh.process_of(s),
                                 view.numel() * view.element_size()))
        got = self.staged.round(outgoing, incoming)
        for tag, view in land:
            view.copy_(got[tag].view(view.dtype).view(view.shape),
                       non_blocking=True)
        self.staged.release()


def _region(x: torch.Tensor, region) -> torch.Tensor:
    return x if region is None else x.narrow(*region)


def close_all() -> None:
    """Unmap every peer's buffers and flags once every rank's cards have
    finished with them: synchronise each card, drop the views and close
    this process's mappings in their cards' contexts, then a barrier,
    after which each exporter frees its flags and may free its memory.
    Collective."""
    if not _OPEN:
        return
    for dev in dict.fromkeys(d for bufs in _OPEN if bufs.cuda
                             for d in bufs.cards):
        torch.cuda.synchronize(dev)
    own = []
    for bufs in _OPEN:
        own += list(bufs._own_flags.items())
        bufs.views = None
        bufs._maps, bufs._own_flags = {}, {}
        bufs._peer_flags, bufs._counts, bufs._plans = {}, {}, {}
        bufs._events = {}
        bufs.plan = None
        bufs.staged = None
    _OPEN.clear()
    for (_, card), ptr in _MAPS.items():
        with torch.cuda.device(card):
            _check(_lib().dcs_ipc_close(ptr), "dcs_ipc_close")
    _MAPS.clear()
    dist.barrier()
    for card, ptr in own:
        with torch.cuda.device(card):
            _check(_lib().dcs_free(ptr), "dcs_free")
