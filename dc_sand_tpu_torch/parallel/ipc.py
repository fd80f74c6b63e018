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

The mapping reaches the processes of one node only
(:func:`~dc_sand_tpu_torch.parallel.distributed.init_distributed` refuses
others), and two processes on one card time-slice it: they run
correctly, not side by side.  A handle that will not open raises;
nothing falls back to gloo on the card.  Peers' buffers stay mapped until
:func:`close_all`, which every rank calls before it exits (the exporter
keeps its memory alive until then).
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

__all__ = ["SharedBuffers", "close_all"]

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


class SharedBuffers:
    """One persistent buffer of ``shape`` and ``dtype`` per shard of a
    multi-process ``mesh``, zeroed, on this rank's card, with every other
    rank's mapped in.

    :attr:`local` lists this rank's buffers in :attr:`Mesh.local_shards`
    order; :attr:`views` has one tensor per shard of the mesh (this rank's
    own, the peers' IPC mappings).  Collective: every rank builds it with
    the same arguments, in the same order as its other collectives.
    """

    barrier_s = 0.0     # host seconds in the barriers, all instances
    barriers = 0

    def __init__(self, mesh, shape, dtype: torch.dtype):
        from torch.multiprocessing.reductions import reduce_tensor
        if not mesh.multiprocess:
            raise ValueError("SharedBuffers spans the ranks of a "
                             "multi-process mesh")
        devs = set(mesh.local_devices)
        dev = next(iter(devs))
        if len(devs) != 1 or dev.type != "cuda":
            raise ValueError(f"the IPC route takes one card a rank, got "
                             f"{sorted(str(d) for d in devs)}")
        if not torch.cuda.is_available() or dev.index >= \
                torch.cuda.device_count():
            raise RuntimeError(f"rank {mesh.rank}: its card {dev} is not "
                               "present")
        _check_alloc_conf()
        self.mesh, self.device = mesh, dev
        self.local = [torch.zeros(tuple(shape), dtype=dtype, device=dev)
                      for _ in mesh.local_shards]
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
        self._peers = []
        for rank, (handles, consumed, sent) in enumerate(every):
            shards = mesh.shards_of(rank)
            if len(handles) != len(shards):
                raise ValueError(f"rank {rank} exported {len(handles)} "
                                 f"buffers for {len(shards)} shards")
            for k, (d, h) in enumerate(zip(shards, handles)):
                self.views[d] = (self.local[k] if rank == mesh.rank
                                 else _open(h, rank, d))
            if rank != mesh.rank:
                self._peers.append(
                    (torch.cuda.Event.from_ipc_handle(dev, consumed),
                     torch.cuda.Event.from_ipc_handle(dev, sent)))
        _OPEN.append(self)

    def _round(self, own: torch.cuda.Event, which: int) -> None:
        stream = torch.cuda.current_stream(self.device)
        own.record(stream)
        t = time.perf_counter()
        dist.barrier()
        SharedBuffers.barrier_s += time.perf_counter() - t
        SharedBuffers.barriers += 1
        for peer in self._peers:
            stream.wait_event(peer[which])

    def ready(self) -> None:
        """Before writing into any rank's buffers: this rank's reads so
        far are recorded as done, and its stream waits for every peer's."""
        self._round(self._consumed, 0)

    def done(self) -> None:
        """After the writes: recorded as sent, and this rank's stream
        waits for every peer's writes before it reads."""
        self._round(self._sent, 1)


def close_all() -> None:
    """Unmap every peer's buffers once every rank's card has finished with
    them: synchronise, drop the mappings, then a barrier, after which each
    exporter may free its memory.  Collective."""
    if not _OPEN:
        return
    torch.cuda.synchronize()
    for bufs in _OPEN:
        bufs.views = None
        bufs._peers = []
    _OPEN.clear()
    dist.barrier()
