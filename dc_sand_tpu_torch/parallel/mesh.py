"""Device mesh (C13), in one process or over several.

PyTorch counterpart of :mod:`dc_sand_tpu.parallel.mesh`: a ``(time, fx)``
array of torch devices.  The ``fx`` axis shards antennas before the
corner-turn and channels after it; the optional ``time`` axis shards the
sample stream (SP mode, overlap-save halo over a ring).

A mesh over several ``torch.distributed`` ranks
(:func:`build_global_mesh`) also records each shard's process and each
process's node.  A rank holds its own shards only, as a JAX process sees
only its addressable shards: every per-shard list on such a mesh has one
entry per :attr:`Mesh.local_shards`, in shard order.  A rank may hold
several cards (:func:`~dc_sand_tpu_torch.parallel.distributed.
local_cards`), as a JAX process holds its host's chips: its shards are
grouped by card (:attr:`Mesh.local_cards`, and the senders of the
peer-copy kernels by :meth:`Mesh.ring_sends` and
:meth:`Mesh.all_to_all_sends`).
The node map gives every pair of ranks its route (:meth:`Mesh.routes`):
``"ipc"`` within a node (:mod:`.ipc`), ``"staged"`` across nodes
(:mod:`.staged`); :meth:`Mesh.route` gives each pair of shards its own,
``"peer"`` between two cards of one rank.  The process-major layout and
``time_local`` do not depend on it: with ``time_local`` the time ring,
and so the runner's halo, stays inside a rank, card to card, as the JAX
package's ingest-locality layout keeps it off DCN.

Every shard is a tensor of its own, so a device may appear more than
once: four shards on ``cuda:0`` are four allocations, and the peer-copy
kernels (:mod:`.remote_dma`) still do every cross-shard copy.  On several
cards the same kernels write into the peer card's memory.  The CPU tests
build ``build_mesh(["cpu"] * 4)``.  Unlike the JAX package's mesh there
is no fallback: a CUDA device that does not exist raises, it is never
replaced by the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

FX_AXIS = "fx"
TIME_AXIS = "time"

__all__ = ["Mesh", "build_mesh", "build_global_mesh", "FX_AXIS",
           "TIME_AXIS"]


class Mesh:
    """A ``(time, fx)`` array of :class:`torch.device`, with the process
    that holds each shard (``procs``, all 0 in one process), this
    process's rank and every process's node (``nodes``, in rank order;
    None: one node).

    Shards are numbered row-major: shard ``d`` sits at ``(t, f) =
    divmod(d, n_fx)``.  Per-shard tensors travel as lists in that order,
    over :attr:`local_shards` only.
    """

    axis_names = (TIME_AXIS, FX_AXIS)

    def __init__(self, devices: np.ndarray, procs: np.ndarray = None,
                 rank: int = 0, nodes=None):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (time, fx) device array")
        if procs is None:
            procs = np.zeros(devices.shape, dtype=int)
        self.devices = devices
        self.procs = procs
        self.rank = rank
        self.shape = {TIME_AXIS: devices.shape[0], FX_AXIS: devices.shape[1]}
        flat = procs.reshape(-1)
        self.local_shards = tuple(int(d) for d in np.flatnonzero(flat == rank))
        self.process_count = len(set(flat.tolist()))
        if nodes is None:
            nodes = ("",) * self.process_count
        if len(nodes) != self.process_count:
            raise ValueError(f"{len(nodes)} nodes for {self.process_count} "
                             "processes")
        self.nodes = tuple(nodes)
        self._sends = {}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def multiprocess(self) -> bool:
        """True when the shards span several processes."""
        return self.process_count > 1

    @property
    def flat_devices(self) -> list:
        """The shards' devices, in shard order (all of them; another
        rank's device is named as that rank named it)."""
        return list(self.devices.reshape(-1))

    @property
    def local_devices(self) -> list:
        """The devices of :attr:`local_shards`, in that order."""
        flat = self.devices.reshape(-1)
        return [flat[d] for d in self.local_shards]

    @property
    def local_cards(self) -> list:
        """The distinct devices of this rank's shards, in the order of
        their first shard."""
        return list(dict.fromkeys(self.local_devices))

    def route(self, i: int, j: int) -> str:
        """How shard ``i``'s data reaches shard ``j``: ``"local"`` within
        one device of one rank, ``"peer"`` between two cards of one rank
        (peer access), else the route between their ranks
        (:meth:`routes`), ``"ipc"`` or ``"staged"``."""
        pi, pj = self.process_of(i), self.process_of(j)
        if pi == pj:
            flat = self.devices.reshape(-1)
            return "local" if flat[i] == flat[j] else "peer"
        return "ipc" if self.node_of(pi) == self.node_of(pj) else "staged"

    def process_of(self, d: int) -> int:
        """The rank that holds shard ``d``."""
        return int(self.procs.reshape(-1)[d])

    def node_of(self, rank: int) -> str:
        """The node that ``rank`` runs on."""
        return self.nodes[rank]

    def routes(self) -> dict:
        """Each other rank -> how this rank's collectives reach its
        buffers: ``"ipc"`` for a rank of this node (CUDA IPC mappings),
        ``"staged"`` for a rank of another node (pinned host slots and
        gloo).  Decided from the node map alone."""
        mine = self.node_of(self.rank)
        return {r: "ipc" if self.node_of(r) == mine else "staged"
                for r in range(self.process_count) if r != self.rank}

    def shards_of(self, rank: int) -> tuple:
        """The shards that ``rank`` holds, in shard order."""
        return tuple(int(d) for d in
                     np.flatnonzero(self.procs.reshape(-1) == rank))

    def local_block(self) -> tuple:
        """``(time rows, fx columns)`` of this rank's shards, each a
        sorted tuple; raises unless the shards fill that rectangle (every
        layout :func:`build_global_mesh` makes with a shard count that
        divides evenly does)."""
        coords = [self.coords(d) for d in self.local_shards]
        ts = tuple(sorted({t for t, _ in coords}))
        fs = tuple(sorted({f for _, f in coords}))
        if len(coords) != len(ts) * len(fs):
            raise ValueError(f"rank {self.rank}'s shards {self.local_shards} "
                             "do not fill a block of time rows by fx columns")
        return ts, fs

    def coords(self, d: int) -> tuple:
        """``(t, f)`` of shard ``d``."""
        return divmod(d, self.shape[FX_AXIS])

    def groups(self, axis: str) -> list:
        """The shards that a collective over ``axis`` joins: one list per
        coordinate of the other axis, each in ``axis`` order."""
        n_t, n_f = self.shape[TIME_AXIS], self.shape[FX_AXIS]
        if axis == FX_AXIS:
            return [[t * n_f + f for f in range(n_f)] for t in range(n_t)]
        if axis == TIME_AXIS:
            return [[t * n_f + f for t in range(n_t)] for f in range(n_f)]
        raise ValueError(f"unknown mesh axis {axis!r}; axes are "
                         f"{self.axis_names}")

    def ring_sends(self, axis: str) -> tuple:
        """One ring step to the right over ``axis``, grouped by the card
        that sends: a tuple of ``(device, pairs)``, one entry per device
        that holds a sender, ``pairs`` a tuple of ``(src, dst)`` shard
        numbers, shard ``dst`` being ``src``'s right neighbour in its
        group (the last one's is the first).  Every shard is ``src`` once
        and ``dst`` once; on a mesh over several processes the senders are
        this rank's shards only.  Computed once per axis and kept."""
        if axis not in self._sends:
            self._sends[axis] = self._by_card(sorted(
                (src, group[(k + 1) % len(group)])
                for group in self.groups(axis)
                for k, src in enumerate(group)))
        return self._sends[axis]

    def all_to_all_sends(self, axis: str) -> tuple:
        """K7b's pairs over ``axis`` grouped by the card that sends, as
        :meth:`ring_sends` groups the ring's: every ``(src, dst)`` of a
        group, this rank's senders only, each sender's receivers in group
        order.  Computed once per axis and kept."""
        key = ("all_to_all", axis)
        if key not in self._sends:
            self._sends[key] = self._by_card(
                (src, dst) for group in self.groups(axis)
                for src in group for dst in group)
        return self._sends[key]

    def _by_card(self, pairs) -> tuple:
        """``(device, pairs)`` per card that holds one of this rank's
        senders, in the order of the pairs given."""
        flat = self.flat_devices
        local = set(self.local_shards)
        by_dev = {}
        for src, dst in pairs:
            if src in local:
                by_dev.setdefault(flat[src], []).append((src, dst))
        return tuple((dev, tuple(ps)) for dev, ps in by_dev.items())


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"mesh device {dev}: no CUDA device is present")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {dev}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    elif dev.type != "cpu":
        raise ValueError(f"mesh devices are cpu or cuda, got {dev}")
    return dev


def _layout(a: np.ndarray, time_shards: int, time_local: bool):
    n = a.size
    if time_local:
        return a.reshape(n // time_shards, time_shards).T.copy()
    return a.reshape(time_shards, n // time_shards)


def _arrange(devs: list, procs: list, rank: int, time_shards: int,
             time_local: bool, nodes=None) -> Mesh:
    if not devs:
        raise ValueError("build_mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError("a mesh holds CPU or CUDA devices, not both: "
                         f"{[str(d) for d in devs]}")
    n = len(devs)
    if time_shards < 1 or n % time_shards:
        raise ValueError(f"{n} devices not divisible by {time_shards} "
                         "time shards")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(_layout(arr, time_shards, time_local),
                _layout(np.asarray(procs, dtype=int), time_shards,
                        time_local), rank, nodes)


def build_mesh(devices: Sequence, time_shards: int = 1,
               time_local: bool = False) -> Mesh:
    """Build a ``(time, fx)`` mesh over ``devices`` (torch devices or their
    names; one may repeat).  ``time_shards=1`` gives the pure fx layout.

    The layout is time-major: shard ``t * n_fx + f`` is ``devices[t * n_fx
    + f]``.  ``time_local=True`` is the JAX package's ingest-locality
    layout: the time axis runs within each contiguous block of
    ``time_shards`` devices, shard ``(t, f)`` on ``devices[f * time_shards
    + t]``, so that one process's devices split its antennas' stream in
    time (the multi-process SP runner needs it)."""
    devs = [_device(d) for d in devices]
    return _arrange(devs, [0] * len(devs), 0, time_shards, time_local)


def build_global_mesh(local_devices: Sequence, time_shards: int = 1,
                      time_local: bool = False) -> Mesh:
    """The mesh over every rank's devices: each rank passes its own
    ``local_devices`` and they are gathered process-major (rank 0's
    first), as ``jax.devices()`` orders a pod's, then laid out as
    :func:`build_mesh` does, with the node map of
    :func:`~dc_sand_tpu_torch.parallel.distributed.node_map`.  Collective:
    every rank of the process group calls it.  Without a process group
    (or with one rank) it is :func:`build_mesh`."""
    import torch.distributed as dist
    from dc_sand_tpu_torch.parallel.distributed import node_map
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return build_mesh(local_devices, time_shards, time_local)
    mine = [str(_device(d)) for d in local_devices]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if len({len(x) for x in every}) != 1:
        raise ValueError(f"every rank must bring as many devices: {every}")
    rank = dist.get_rank()
    devs, procs = [], []
    for r, names in enumerate(every):
        devs += [_device(x) if r == rank else torch.device(x) for x in names]
        procs += [r] * len(names)
    return _arrange(devs, procs, rank, time_shards, time_local, node_map())
