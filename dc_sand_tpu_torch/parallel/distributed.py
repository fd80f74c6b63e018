"""Several processes on one node: ``torch.distributed`` ranks (C15).

PyTorch counterpart of :mod:`dc_sand_tpu.parallel.distributed`.  Every rank
runs the same program: :func:`init_distributed` first (from the launcher's
environment or explicit arguments), then
:func:`~dc_sand_tpu_torch.parallel.mesh.build_global_mesh` over each rank's
own devices, gathered process-major into one ``(time, fx)`` mesh.  The
runner then feeds each rank only its own antennas
(:func:`local_antenna_range`).

The process group is gloo: it carries the control plane (the exchange of
CUDA IPC handles, barriers, small host gathers) and, on the CPU, the data
of the plain collectives.  On the card the data crosses between processes
through CUDA IPC mappings of the peers' buffers
(:mod:`dc_sand_tpu_torch.parallel.ipc`), which reach the processes of one
node only: ranks on different hosts are refused by name.

    RANK=0 WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python -m dc_sand_tpu_torch.cli verify fx4 --distributed --mesh 4
    torchrun --nproc-per-node 2 -m dc_sand_tpu_torch.cli verify fx4 \\
        --distributed --mesh 4
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "local_antenna_range", "process_index",
           "process_count", "local_rank"]


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its node (the launcher's ``LOCAL_RANK``, else
    the rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None) -> dict:
    """Join the gloo process group (a no-op with one process); returns
    JAX's dict: ``process_index``, ``process_count``, ``local_devices``
    and ``global_devices`` (devices are the cards this rank sees, or 1 on
    the CPU, and their sum over the ranks).

    With no arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun`` sets
    them): nothing set is one process.  ``coordinator`` is ``host:port``
    of rank 0's store; ``init_method`` any ``torch.distributed`` URL
    (``file:///path``, ``tcp://host:port``) in its place.  Ranks on
    different hosts raise: the card path maps peers' memory with CUDA
    IPC, which does not leave the node.
    """
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if (not dist.is_initialized() and num_processes is not None
            and num_processes > 1):
        if process_id is None:
            raise ValueError(f"{num_processes} processes but no rank: pass "
                             "process_id or set RANK")
        if init_method is None:
            if coordinator is None:
                addr = os.environ.get("MASTER_ADDR")
                port = os.environ.get("MASTER_PORT")
                if not (addr and port):
                    raise ValueError(
                        "init_distributed needs a coordinator (host:port), "
                        "an init_method, or MASTER_ADDR and MASTER_PORT")
                coordinator = f"{addr}:{port}"
            init_method = f"tcp://{coordinator}"
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=num_processes, rank=process_id)
        hosts = [None] * num_processes
        dist.all_gather_object(hosts, socket.gethostname())
        if len(set(hosts)) > 1:
            names = ", ".join(f"rank {r} on {h}" for r, h in enumerate(hosts))
            dist.destroy_process_group()
            raise RuntimeError(
                f"ranks on different hosts ({names}): the port's processes "
                "reach each other's card memory through CUDA IPC, which "
                "stays on one node")
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    counts = [local]
    if dist.is_initialized():
        counts = [None] * process_count()
        dist.all_gather_object(counts, local)
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": sum(counts),
    }


def local_antenna_range(n_ants: int) -> Tuple[int, int]:
    """``[start, stop)`` of the antennas this rank ingests: the antenna axis
    cut contiguously over the ranks, as the process-major mesh of
    :func:`~dc_sand_tpu_torch.parallel.mesh.build_global_mesh` lays it."""
    p, n = process_index(), process_count()
    if n_ants % n:
        raise ValueError(f"{n_ants} antennas not divisible over {n} hosts")
    per = n_ants // n
    return p * per, (p + 1) * per
