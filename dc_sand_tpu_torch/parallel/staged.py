"""The staged route: blocks between ranks on different nodes, through
pinned host memory and gloo.

CUDA IPC (:mod:`.ipc`) maps a peer's card memory only within a node.
Between nodes a block crosses as the JAX package's collectives cross
DCN: off the sender's card, over the network, onto the receiver's.  One
:class:`StagedRoute` serves one role of a
:class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` (the CMAC operand,
the halo, the partial beams, the accumulators):

* **sender**: each block bound for another node is copied whole from its
  card into this rank's pinned send slot for that peer, on that card's
  copy stream of the route, after the work that produced it (the copy
  stream waits for the card's current stream); the host waits for those
  copies, since gloo reads the slot from the host;
* **transfer**: one :func:`torch.distributed.batch_isend_irecv` of every
  move, one tag a move (``sender shard * mesh size + receiver``, the tags
  of ``remote_dma._exchange``), issued in tag order on every rank;
* **receiver**: the block lands in its pinned receive slot.  For the
  peer-copy kernels the receiver copies the slot whole onto the
  receiving shard's card, a copy-engine transfer into that card's landing
  buffer (:meth:`StagedRoute.land`), and its K7b or K7a launch places the block
  from there into its own buffer at the sender's offset and pitch; for
  the sums a host-to-device copy fills a mirror.  The landing copy, not
  the kernel reading the slot across the bus through its device address,
  is the source on purpose: on the H100 both move the fx64 corner-turn's
  blocks at the bus rate, but the copy engine leaves the SMs free during
  the transfer, where the kernel would hold them for all of it, and the
  kernel then reads HBM for a fraction of a millisecond (PERF.md §6).
  The cost is a device buffer of the received bytes.

The slots are double-buffered per peer and direction and alternate each
round (:meth:`StagedRoute.release` flips them), so the card may still be
reading one round's receive slot while the next round's bytes land in the
other.  A receive slot is not refilled before the work that read it has
finished: :meth:`StagedRoute.release` records an event after that work,
and the round that reuses the slot waits for it.

On CPU tensors the route runs with plain host tensors, no pinning and no
copy stream, so that the CPU tests hold its bookkeeping.  Nothing falls
back to it: a pair of ranks takes it exactly when the node map says they
are on different nodes (:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.
routes`), and a failed exchange raises.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["StagedRoute", "as_bytes"]

_ALIGN = 256    # byte alignment of each move in a slot: the kernel's 16-byte path


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of the contiguous tensor ``x`` as a 1-D uint8 view."""
    if not x.is_contiguous():
        raise ValueError("the staged route moves contiguous blocks")
    return x.reshape(-1).view(torch.uint8)


class StagedRoute:
    """Pinned send and receive slots per remote peer of one rank's role,
    double-buffered, and a copy stream and a landing buffer per card of
    the rank (module docstring); on the CPU, plain host slots and no
    stream.  ``devices``: the rank's cards (one device, or several)."""

    sent_bytes = 0      # every route of this process, for the traces
    received_bytes = 0
    seconds = 0.0       # host seconds in round()
    rounds = 0

    def __init__(self, devices):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.cuda = self.device.type == "cuda"
        self.streams = ({d: torch.cuda.Stream(d) for d in self.devices}
                        if self.cuda else {})
        self._slots = {}        # (peer, "send" | "recv", turn) -> uint8
        self._guards = {}       # (peer, turn) -> events after its last read
        self._landing = {}      # card -> the device landing buffer of land()
        self._turn = 0
        self._read = ()         # the peers whose receive slots this round fills

    def _slot(self, peer: int, kind: str, nbytes: int) -> torch.Tensor:
        key = (peer, kind, self._turn)
        buf = self._slots.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=self.cuda)
            self._slots[key] = buf
        return buf

    def _layout(self, moves, kind: str) -> dict:
        """``{tag: (peer, view)}``: each peer's moves at aligned offsets of
        its slot of ``kind``, in tag order."""
        at, spans = {}, {}
        for tag, peer, nbytes in sorted(moves):
            off = at.get(peer, 0)
            spans[tag] = (peer, off, nbytes)
            at[peer] = off + -(-nbytes // _ALIGN) * _ALIGN
        slots = {peer: self._slot(peer, kind, n) for peer, n in at.items()}
        return {tag: (peer, slots[peer][off:off + n])
                for tag, (peer, off, n) in spans.items()}

    def round(self, outgoing, incoming) -> dict:
        """One exchange of this role.  ``outgoing``: ``(tag, peer,
        block)`` for each block this rank sends (a contiguous tensor on its
        device); ``incoming``: ``(tag, peer, nbytes)`` for each block it
        receives.  Every move is outgoing on its sender and incoming on
        its receiver under one tag.  Returns ``{tag: uint8 view of the
        received bytes}`` in this rank's receive slots, valid until the
        round after the next; call :meth:`release` once the reads of them
        are queued."""
        t0 = time.perf_counter()
        incoming = list(incoming)
        self._read = tuple(sorted({p for _, p, _ in incoming}))
        for peer in self._read:    # before the slot is refilled or replaced
            for guard in self._guards.pop((peer, self._turn), ()):
                guard.synchronize()
        sends = self._layout([(t, p, b.numel() * b.element_size())
                              for t, p, b in outgoing], "send")
        recvs = self._layout(incoming, "recv")
        blocks = {t: b for t, _, b in outgoing}
        if self.cuda and sends:
            # each block off its own card, on that card's copy stream
            used = {blocks[tag].device for tag in sends}
            for dev in used:
                self.streams[dev].wait_stream(torch.cuda.current_stream(dev))
            for tag, (_, view) in sends.items():
                with torch.cuda.stream(self.streams[blocks[tag].device]):
                    view.copy_(as_bytes(blocks[tag]), non_blocking=True)
            for dev in used:
                self.streams[dev].synchronize()
        else:
            for tag, (_, view) in sends.items():
                view.copy_(as_bytes(blocks[tag]))
        ops = sorted([(tag, dist.isend, peer, view)
                      for tag, (peer, view) in sends.items()]
                     + [(tag, dist.irecv, peer, view)
                        for tag, (peer, view) in recvs.items()],
                     key=lambda op: op[0])
        if ops:
            for work in dist.batch_isend_irecv(
                    [dist.P2POp(fn, view, peer, tag=tag)
                     for tag, fn, peer, view in ops]):
                work.wait()
        StagedRoute.sent_bytes += sum(v.numel() for _, v in sends.values())
        StagedRoute.received_bytes += sum(v.numel()
                                          for _, v in recvs.values())
        StagedRoute.seconds += time.perf_counter() - t0
        StagedRoute.rounds += 1
        return {tag: view for tag, (_, view) in recvs.items()}

    def release(self) -> None:
        """After the reads of this round's receive slots are queued on
        the cards' current streams: record on each card the events the
        round that reuses them waits for, and flip to the other slots."""
        if self.cuda and self._read:
            for peer in self._read:
                events = []
                for dev in self.devices:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    events.append(event)
                self._guards[(peer, self._turn)] = events
        self._read = ()
        self._turn ^= 1

    def land(self, views, devices=None) -> list:
        """This round's received ``views`` on the cards: each copied whole
        (a host-to-device copy on its card's current stream, from pinned
        memory) into that card's landing buffer of this route, at aligned
        offsets, grown as needed and reused; the device views, in order.
        ``devices``: the card of each view (default the first card).
        Stream order keeps the next round's copies behind the reads of
        this one's."""
        devices = devices or [self.device] * len(views)
        offs, total = [], {}
        for v, dev in zip(views, devices):
            offs.append(total.get(dev, 0))
            total[dev] = offs[-1] + -(-v.numel() // _ALIGN) * _ALIGN
        for dev, need in total.items():
            have = self._landing.get(dev)
            if have is None or have.numel() < need:
                self._landing[dev] = torch.empty(max(need, 1),
                                                 dtype=torch.uint8, device=dev)
        out = []
        for v, dev, off in zip(views, devices, offs):
            dst = self._landing[dev][off:off + v.numel()]
            dst.copy_(v, non_blocking=True)
            out.append(dst)
        return out
