"""Device mesh (C13), in one process.

PyTorch counterpart of :mod:`dc_sand_tpu.parallel.mesh`: a ``(time, fx)``
array of torch devices.  The ``fx`` axis shards antennas before the
corner-turn and channels after it; the optional ``time`` axis shards the
sample stream (SP mode, overlap-save halo over a ring).

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

__all__ = ["Mesh", "build_mesh", "FX_AXIS", "TIME_AXIS"]


class Mesh:
    """A ``(time, fx)`` array of :class:`torch.device`.

    Shards are numbered row-major: shard ``d`` sits at ``(t, f) =
    divmod(d, n_fx)``.  Per-shard tensors travel as lists in that order.
    """

    axis_names = (TIME_AXIS, FX_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (time, fx) device array")
        self.devices = devices
        self.shape = {TIME_AXIS: devices.shape[0], FX_AXIS: devices.shape[1]}
        self._ring_sends = {}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat_devices(self) -> list:
        """The shards' devices, in shard order."""
        return list(self.devices.reshape(-1))

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
        and ``dst`` once.  Computed once per axis and kept."""
        if axis not in self._ring_sends:
            flat = self.flat_devices
            by_dev = {}
            for group in self.groups(axis):
                for k, src in enumerate(group):
                    by_dev.setdefault(flat[src], []).append(
                        (src, group[(k + 1) % len(group)]))
            self._ring_sends[axis] = tuple(
                (dev, tuple(sorted(pairs))) for dev, pairs in by_dev.items())
        return self._ring_sends[axis]


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


def build_mesh(devices: Sequence, time_shards: int = 1) -> Mesh:
    """Build a ``(time, fx)`` mesh over ``devices`` (torch devices or their
    names; one may repeat).  ``time_shards=1`` gives the pure fx layout.

    The layout is time-major: shard ``t * n_fx + f`` is ``devices[t * n_fx
    + f]``.  A caller that wants another arrangement orders the list."""
    devs = [_device(d) for d in devices]
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
    return Mesh(arr.reshape(time_shards, n // time_shards))
