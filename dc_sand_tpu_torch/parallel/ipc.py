"""Card buffers that every rank of a multi-process mesh can address.

The TPU kernels K7a and K7b (``dc_sand_tpu/parallel/remote_dma.py``) copy
into another chip's memory by its device id and signal DMA semaphores.
Across processes on Hopper the counterpart is a CUDA IPC mapping: each
rank allocates its shards' buffers of one role once (the corner-turn's
CMAC operand, the halo, the partial beams, the accumulator), exports
their IPC handles (``torch.multiprocessing.reductions.reduce_tensor``),
and every other rank maps them into its own address space (lazy peer
access), so that a kernel of one process writes into, or a sum reads from,
the memory of another.  Two interprocess events a rank and role stand for
the semaphores:

* ``consumed``: recorded on the rank's stream after the work that reads
  its buffers (the CMAC, the halo's use, a sum), so that a writer waits
  before it overwrites them;
* ``sent``: recorded after the work that writes them, so that a reader
  waits before it reads.

A wait on an IPC event waits for its most recent ``record`` at the time
the wait is issued, so each :meth:`SharedBuffers.ready` and
:meth:`SharedBuffers.done` is a record, a gloo barrier, and a wait on
every peer's event of that kind.  The barriers' host time adds up in
:attr:`SharedBuffers.barrier_s` (count :attr:`SharedBuffers.barriers`).

The mapping reaches the processes of one node only.  A rank of another
node (:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.routes`, from the node
map of :func:`~dc_sand_tpu_torch.parallel.distributed.init_distributed`)
gets the staged role instead (:mod:`.staged`): no handle is opened for
it, and :attr:`SharedBuffers.views` holds, for each of its shards, a
local mirror that :meth:`SharedBuffers.fetch` fills for readers (None
until a read needs it); a writer sends its blocks there through
:attr:`SharedBuffers.staged`, and the receiver places them into its own
buffer.  The barrier rounds stay as they are for both routes.  On CPU
tensors a mesh whose peers are all on other nodes takes the staged role
(the CPU tests hold its bookkeeping); IPC is the card's.

A rank may hold several cards (:func:`~dc_sand_tpu_torch.parallel.
distributed.local_cards`): each shard's buffer lies on its own card, each
card has its pair of events, and a round records on every card's stream
and makes each wait for every peer card's events and for the rank's own
other cards' streams (between two cards of one rank the kernels write by
peer access, with no IPC).  On the H100 machine an IPC handle is used
only in the context of the card that uses it, as NCCL does:

* a peer's events are opened in this rank's first card's context and
  waited on from its stream, which the rank's other streams then wait
  for (an event opened in the context of the peer's card index and
  waited on from another card's stream crashes the process);
* a peer's buffer is mapped into the context of the one card of this
  rank whose kernels write into it (a mapping opened in another card's
  context faults when written).

Neither depends on the exporter's card index, so the ranks of a node
need not number the cards alike.  Two processes on one
card time-slice it: they run correctly, not side by side.  A handle that
will not open raises, and so does a staged exchange that fails; neither
route stands in for the other.  Peers' buffers stay mapped until
:func:`close_all`, which every rank calls before it exits
(the exporter keeps its memory alive until then).
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from dc_sand_tpu_torch.parallel.staged import StagedRoute

__all__ = ["SharedBuffers", "close_all", "uses_shared_buffers"]

_OPEN = []      # every SharedBuffers of this process, held until close_all


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


def _open(args: tuple, rank: int, shard: int, on: torch.device):
    """Map a peer's buffer into card ``on``'s context, the card whose
    kernels write into it (with CUDA's lazy peer access), as NCCL
    maps its peers' buffers: a mapping opened in another card's context
    is not addressable from ``on`` (on the H100 machine the write faults),
    which is why ``rebuild_cuda_tensor``'s own choice, the exporter's
    device index, is replaced.  The tensor then names ``on`` as its
    device.  The exporter synchronised its card before exporting, so the
    producer's event is not waited on."""
    import inspect
    from torch.multiprocessing.reductions import rebuild_cuda_tensor
    names = list(inspect.signature(rebuild_cuda_tensor).parameters)
    args = list(args)
    args[names.index("storage_device")] = on.index
    args[names.index("event_sync_required")] = False
    try:
        return rebuild_cuda_tensor(*args)
    except RuntimeError as err:
        raise RuntimeError(f"rank {rank}'s buffer of shard {shard} did not "
                           f"open through CUDA IPC: {err}") from err


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


class SharedBuffers:
    """One persistent buffer of ``shape`` and ``dtype`` per shard of a
    multi-process ``mesh``, zeroed, each on its shard's card (a rank may
    hold several: :attr:`cards`), with the buffers of every rank of its
    node mapped in and a staged route to the ranks of other nodes.

    :attr:`local` lists this rank's buffers in :attr:`Mesh.local_shards`
    order; :attr:`views` has one tensor per shard of the mesh (this rank's
    own, on whichever of its cards, its node's peers' IPC mappings, other
    nodes' mirrors).  A peer's k-th shard is mapped into this rank's k-th
    card (mod their count), whose device its view names: the kernels that
    write into it launch there (:func:`~dc_sand_tpu_torch.parallel.
    remote_dma._launch_shared`), reading their sources on the rank's
    other cards by peer access.  Each card of the rank has its pair of
    interprocess events.  Collective: every rank builds it with the same
    arguments, in the same order as its other collectives.
    """

    barrier_s = 0.0     # host seconds in the barriers, all instances
    barriers = 0

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
        self._events = {}       # card -> (consumed, sent)
        mine = None
        if ipc:
            from torch.multiprocessing.reductions import reduce_tensor
            handles = []
            for dev in self.cards:
                # an event is made on the current device when its handle is
                with torch.cuda.device(dev):
                    ev = (torch.cuda.Event(interprocess=True),
                          torch.cuda.Event(interprocess=True))
                    handles.append((bytes(ev[0].ipc_handle()),
                                    bytes(ev[1].ipc_handle())))
                self._events[dev] = ev
            mine = ([reduce_tensor(t)[1] for t in self.local], handles)
            for dev in self.cards:
                torch.cuda.synchronize(dev)
        every = [None] * mesh.process_count
        dist.all_gather_object(every, mine)
        self.views = [None] * mesh.size
        for d, t in zip(mesh.local_shards, self.local):
            self.views[d] = t
        self._peers = []        # (consumed, sent) of every peer card
        for rank in ipc:
            tensors, events = every[rank]
            shards = mesh.shards_of(rank)
            if len(tensors) != len(shards):
                raise ValueError(f"rank {rank} exported {len(tensors)} "
                                 f"buffers for {len(shards)} shards")
            for k, (d, h) in enumerate(zip(shards, tensors)):
                # the peer's k-th shard on this rank's k-th card (mod)
                self.views[d] = _open(h, rank, d,
                                      self.cards[k % len(self.cards)])
            # opened in, and waited on from, this rank's first card
            self._peers += [tuple(torch.cuda.Event.from_ipc_handle(
                self.cards[0], h) for h in pair) for pair in events]
        self._remote = frozenset(d for r in staged for d in mesh.shards_of(r))
        self.staged = StagedRoute(self.cards) if staged else None
        _OPEN.append(self)

    def remote(self, d: int) -> bool:
        """True when shard ``d`` lies on another node (the staged role)."""
        return d in self._remote

    def _round(self, which: int) -> None:
        streams = ([torch.cuda.current_stream(dev) for dev in self.cards]
                   if self.cuda else [])
        for dev, stream in zip(self.cards, streams):
            if dev in self._events:
                self._events[dev][which].record(stream)
        t = time.perf_counter()
        dist.barrier()
        SharedBuffers.barrier_s += time.perf_counter() - t
        SharedBuffers.barriers += 1
        for events in self._peers:
            streams[0].wait_event(events[which])
        for stream in streams:
            # the rank's other cards (and through the first, the peers'):
            # a card writes into, or reads, another's
            for other in streams:
                if other is not stream:
                    stream.wait_stream(other)

    def ready(self) -> None:
        """Before writing into any rank's buffers: this rank's reads so
        far are recorded as done on each of its cards, and each card's
        stream waits for every peer card's and for the rank's other
        cards'."""
        self._round(0)

    def done(self) -> None:
        """After the writes: recorded as sent on each card, and each
        card's stream waits for every peer card's writes and for the
        rank's other cards' before it reads."""
        self._round(1)

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
    """Unmap every peer's buffers once every rank's cards have finished
    with them: synchronise each, drop the mappings, then a barrier, after
    which each exporter may free its memory.  Collective."""
    if not _OPEN:
        return
    for dev in dict.fromkeys(d for bufs in _OPEN if bufs.cuda
                             for d in bufs.cards):
        torch.cuda.synchronize(dev)
    for bufs in _OPEN:
        bufs.views = None
        bufs._peers = []
        bufs.staged = None
    _OPEN.clear()
    dist.barrier()
