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

Two processes on one card time-slice it: they run correctly, not side by
side.  A handle that will not open raises, and so does a staged exchange
that fails; neither route stands in for the other.  Peers' buffers stay
mapped until :func:`close_all`, which every rank calls before it exits
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


def _open(args: tuple, rank: int, shard: int) -> torch.Tensor:
    from torch.multiprocessing.reductions import rebuild_cuda_tensor
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
    multi-process ``mesh``, zeroed, on this rank's device, with the
    buffers of every rank of its node mapped in and a staged route to the
    ranks of other nodes.

    :attr:`local` lists this rank's buffers in :attr:`Mesh.local_shards`
    order; :attr:`views` has one tensor per shard of the mesh (this rank's
    own, its node's peers' IPC mappings, other nodes' mirrors).
    Collective: every rank builds it with the same arguments, in the same
    order as its other collectives.
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
        devs = set(mesh.local_devices)
        dev = next(iter(devs))
        # the CPU takes the staged route's bookkeeping only
        if len(devs) != 1 or dev.type != "cuda" and (ipc or
                                                     dev.type != "cpu"):
            raise ValueError(f"the IPC route takes one card a rank, got "
                             f"{sorted(str(d) for d in devs)}")
        if dev.type == "cuda":
            if not torch.cuda.is_available() or dev.index >= \
                    torch.cuda.device_count():
                raise RuntimeError(f"rank {mesh.rank}: its card {dev} is "
                                   "not present")
            if ipc:
                _check_alloc_conf()
        self.mesh, self.device = mesh, dev
        self.local = [torch.zeros(tuple(shape), dtype=dtype, device=dev)
                      for _ in mesh.local_shards]
        mine = None
        if ipc:
            from torch.multiprocessing.reductions import reduce_tensor
            with torch.cuda.device(dev):
                self._consumed = torch.cuda.Event(interprocess=True)
                self._sent = torch.cuda.Event(interprocess=True)
                mine = ([reduce_tensor(t)[1] for t in self.local],
                        bytes(self._consumed.ipc_handle()),
                        bytes(self._sent.ipc_handle()))
                torch.cuda.synchronize(dev)
        every = [None] * mesh.process_count
        dist.all_gather_object(every, mine)
        self.views = [None] * mesh.size
        for d, t in zip(mesh.local_shards, self.local):
            self.views[d] = t
        self._peers = []
        for rank in ipc:
            handles, consumed, sent = every[rank]
            shards = mesh.shards_of(rank)
            if len(handles) != len(shards):
                raise ValueError(f"rank {rank} exported {len(handles)} "
                                 f"buffers for {len(shards)} shards")
            for d, h in zip(shards, handles):
                self.views[d] = _open(h, rank, d)
            self._peers.append(
                (torch.cuda.Event.from_ipc_handle(dev, consumed),
                 torch.cuda.Event.from_ipc_handle(dev, sent)))
        self._remote = frozenset(d for r in staged for d in mesh.shards_of(r))
        self.staged = StagedRoute(dev) if staged else None
        _OPEN.append(self)

    def remote(self, d: int) -> bool:
        """True when shard ``d`` lies on another node (the staged role)."""
        return d in self._remote

    def _round(self, which: int) -> None:
        stream = None
        if self._peers:
            stream = torch.cuda.current_stream(self.device)
            (self._consumed, self._sent)[which].record(stream)
        t = time.perf_counter()
        dist.barrier()
        SharedBuffers.barrier_s += time.perf_counter() - t
        SharedBuffers.barriers += 1
        for peer in self._peers:
            stream.wait_event(peer[which])

    def ready(self) -> None:
        """Before writing into any rank's buffers: this rank's reads so
        far are recorded as done, and its stream waits for every peer's."""
        self._round(0)

    def done(self) -> None:
        """After the writes: recorded as sent, and this rank's stream
        waits for every peer's writes before it reads."""
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
    """Unmap every peer's buffers once every rank's card has finished with
    them: synchronise, drop the mappings, then a barrier, after which each
    exporter may free its memory.  Collective."""
    if not _OPEN:
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for bufs in _OPEN:
        bufs.views = None
        bufs._peers = []
        bufs.staged = None
    _OPEN.clear()
    dist.barrier()
