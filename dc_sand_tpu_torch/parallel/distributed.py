"""Several processes, on one node or across nodes: ``torch.distributed``
ranks (C15).

PyTorch counterpart of :mod:`dc_sand_tpu.parallel.distributed`.  Every rank
runs the same program: :func:`init_distributed` first (from the launcher's
environment or explicit arguments), then
:func:`~dc_sand_tpu_torch.parallel.mesh.build_global_mesh` over each rank's
own devices, gathered process-major into one ``(time, fx)`` mesh.  The
runner then feeds each rank only its own antennas
(:func:`local_antenna_range`).

The process group is gloo: it carries the control plane (the exchange of
CUDA IPC handles, barriers, small host gathers) and, on the CPU, the data
of the plain collectives.  :func:`init_distributed` also gathers every
rank's node (:func:`node_name`), the node map from which the mesh picks a
route per pair of ranks (:meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.
routes`): ranks of one node reach each other's card memory through CUDA
IPC mappings (:mod:`dc_sand_tpu_torch.parallel.ipc`), ranks of different
nodes through pinned host slots and gloo
(:mod:`dc_sand_tpu_torch.parallel.staged`).

    RANK=0 WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python -m dc_sand_tpu_torch.cli verify fx4 --distributed --mesh 4
    torchrun --nproc-per-node 2 -m dc_sand_tpu_torch.cli verify fx4 \\
        --distributed --mesh 4
    torchrun --nnodes 2 --node-rank R --nproc-per-node 2 \\
        --master-addr HOST0 --master-port 29500 \\
        -m dc_sand_tpu_torch.cli verify fx4 --distributed --mesh 4
"""

from __future__ import annotations

import atexit
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "local_antenna_range", "process_index",
           "process_count", "local_rank", "local_world_size", "local_cards",
           "masked_per_rank", "node_name", "node_map"]

_NODES = None   # every rank's node, gathered by init_distributed
_MASKS = None   # every rank's CUDA_VISIBLE_DEVICES, gathered with them


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


def local_world_size() -> int:
    """The number of ranks on this rank's node: the launcher's
    ``LOCAL_WORLD_SIZE``, else this node's ranks in the node map (1
    without a process group)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if not dist.is_initialized():
        return 1
    nodes = node_map()
    return nodes.count(nodes[process_index()])


def local_cards(n_cards: Optional[int] = None,
                n_local: Optional[int] = None,
                rank: Optional[int] = None) -> list:
    """The cards this rank owns, as a JAX process owns its host's chips:
    the ``n_cards`` cards it sees (``torch.cuda.device_count()``) cut in
    contiguous blocks over the ``n_local`` ranks of its node
    (:func:`local_world_size`), rank ``rank`` (:func:`local_rank`) taking
    cards ``[rank * n_cards / n_local, (rank + 1) * n_cards / n_local)``.
    With fewer cards than ranks, rank ``l`` takes card ``l mod n_cards``
    alone (ranks then share a card).  Where the launcher showed each rank
    of the node its own cards (``CUDA_VISIBLE_DEVICES`` differing among
    them, as :func:`init_distributed` gathered it; :func:`masked_per_rank`)
    and neither count is given, the rank takes every card it sees.
    Raises without a card, and where the cards do not divide evenly over
    the ranks."""
    if n_cards is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    if n_local is None and rank is None and masked_per_rank():
        n_local, rank = 1, 0
    n_local = local_world_size() if n_local is None else n_local
    rank = local_rank() if rank is None else rank
    if n_cards < 1:
        raise ValueError("local_cards: no CUDA device is present")
    if not 0 <= rank < n_local:
        raise ValueError(f"local rank {rank} of {n_local} ranks on the node")
    if n_cards < n_local:
        return [torch.device("cuda", rank % n_cards)]
    if n_cards % n_local:
        raise ValueError(f"{n_cards} cards do not divide over the node's "
                         f"{n_local} ranks")
    per = n_cards // n_local
    return [torch.device("cuda", c) for c in range(rank * per,
                                                   (rank + 1) * per)]


def masked_per_rank() -> bool:
    """True when the ranks of this rank's node were each shown cards of
    their own: their ``CUDA_VISIBLE_DEVICES``, gathered by
    :func:`init_distributed`, differ.  False without a process group or
    with one mask on every rank of the node (unset counts as one).
    Raises where the masks differ but two of them name a card in common,
    or one rank has none, for then no split of the cards is the
    launcher's."""
    if _MASKS is None or not dist.is_initialized():
        return False
    nodes = node_map()
    here = nodes[process_index()]
    masks = [m for n, m in zip(nodes, _MASKS) if n == here]
    if len(set(masks)) == 1:
        return False
    cards = [set(filter(None, (c.strip() for c in m.split(","))))
             if m is not None else None for m in masks]
    if None in cards or any(a & b for k, a in enumerate(cards)
                            for b in cards[k + 1:]):
        raise ValueError(
            f"the ranks of node {here} see CUDA_VISIBLE_DEVICES {masks}: "
            "give them one mask, whose cards local_cards splits over them, "
            "or masks that share no card, each rank taking all of its own")
    return True


def node_name(node: Optional[str] = None) -> str:
    """This process's node: ``node`` when given, else the host name, as
    ``host/g`` with torchrun's ``GROUP_RANK`` (its agent's index) where
    that is set, so that two agents on one host (``torchrun --nnodes 2``)
    are two nodes."""
    if node is not None:
        return str(node)
    group = os.environ.get("GROUP_RANK")
    host = socket.gethostname()
    return host if group is None else f"{host}/{group}"


def node_map() -> tuple:
    """Every rank's node, in rank order: the map :func:`init_distributed`
    gathered (gathered here, collectively, when the process group was
    joined some other way); this process's node alone without a process
    group."""
    global _NODES
    if not dist.is_initialized():
        return (node_name(),)
    if _NODES is None or len(_NODES) != dist.get_world_size():
        nodes = [None] * dist.get_world_size()
        dist.all_gather_object(nodes, node_name())
        _NODES = tuple(nodes)
    return _NODES


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None,
                     node: Optional[str] = None) -> dict:
    """Join the gloo process group (a no-op with one process); returns
    JAX's dict: ``process_index``, ``process_count``, ``local_devices``
    and ``global_devices`` (devices are the cards this rank owns,
    :func:`local_cards`, or 1 on the CPU, and their sum over the ranks),
    and beside them ``nodes``,
    every rank's node in rank order (:func:`node_name`; ``node`` names
    this rank's own).

    With no arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun`` sets
    them): nothing set is one process.  ``coordinator`` is ``host:port``
    of rank 0's store; ``init_method`` any ``torch.distributed`` URL
    (``file:///path``, ``tcp://host:port``) in its place.  The node map
    decides each pair's route (:meth:`~dc_sand_tpu_torch.parallel.mesh.
    Mesh.routes`): CUDA IPC within a node, pinned host slots across.
    """
    global _NODES, _MASKS
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
        # leave the group before the interpreter's teardown: a gloo group
        # still alive then can abort the process ("terminate called without
        # an active exception") after all its work is done
        atexit.register(_leave)
    if dist.is_initialized():
        seen = [None] * process_count()
        dist.all_gather_object(seen, (node_name(node),
                                      os.environ.get("CUDA_VISIBLE_DEVICES")))
        _NODES = tuple(n for n, _ in seen)
        _MASKS = tuple(m for _, m in seen)
    local = len(local_cards()) if torch.cuda.is_available() else 1
    counts = [local]
    if dist.is_initialized():
        counts = [None] * process_count()
        dist.all_gather_object(counts, local)
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": sum(counts),
        "nodes": list(node_map()) if dist.is_initialized()
        else [node_name(node)],
    }


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def local_antenna_range(n_ants: int) -> Tuple[int, int]:
    """``[start, stop)`` of the antennas this rank ingests: the antenna axis
    cut contiguously over the ranks, as the process-major mesh of
    :func:`~dc_sand_tpu_torch.parallel.mesh.build_global_mesh` lays it."""
    p, n = process_index(), process_count()
    if n_ants % n:
        raise ValueError(f"{n_ants} antennas not divisible over {n} hosts")
    per = n_ants // n
    return p * per, (p + 1) * per
