"""Start the ranks of a multi-process run on this host, as ``torchrun``
would, and collect what each printed.

    results = run_ranks([sys.executable, "-m", "dc_sand_tpu_torch.cli",
                         "verify", "fx4", "--distributed", "--mesh", "4"], 2)

Each rank gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and ``MASTER_PORT`` (a
free port of this host, unless ``env`` names one), as torchrun sets them,
which :func:`~dc_sand_tpu_torch.parallel.distributed.init_distributed`
and :func:`~dc_sand_tpu_torch.parallel.distributed.local_cards` read.
With ``nodes=n`` the ranks form ``n`` nodes of ``world / n`` consecutive
ranks, as ``torchrun --nnodes n`` agents on this host would start them:
``GROUP_RANK`` (the node), ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` within
it; ranks of different nodes then exchange
through the staged route (:mod:`.staged`), not CUDA IPC.  The ranks' outputs are drained while they run,
so that a rank that fills its pipe cannot stall the others at a barrier;
when one rank fails, the others are stopped at once rather than left
waiting for it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import NamedTuple, Optional, Sequence

__all__ = ["run_ranks", "RankResult", "free_port"]


class RankResult(NamedTuple):
    returncode: int     # -9 for a rank stopped after another failed
    output: str         # its stdout and stderr, interleaved


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world: int, *,
              env: Optional[dict] = None, timeout: float = 600.0,
              cwd: Optional[str] = None, nodes: Optional[int] = None) -> list:
    """Run ``world`` processes of ``argv`` and wait for them; returns a
    :class:`RankResult` per rank.  A rank that exits non-zero, or the
    ``timeout`` in seconds, stops every rank still running.  ``nodes``:
    see the module docstring (None: one node, no ``GROUP_RANK``)."""
    base = dict(os.environ, **(env or {}))
    base.setdefault("MASTER_ADDR", "127.0.0.1")
    base.setdefault("MASTER_PORT", str(free_port()))
    if nodes is not None and (nodes < 1 or world % nodes):
        raise ValueError(f"{world} ranks do not form {nodes} nodes")
    per = world // (nodes or 1)
    procs, outs, readers = [], [], []
    for rank in range(world):
        rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank % per),
                        WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(per))
        if nodes is not None:
            rank_env.update(GROUP_RANK=str(rank // per))
        proc = subprocess.Popen(list(argv), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=rank_env, cwd=cwd)
        chunks = []
        reader = threading.Thread(target=lambda p=proc, c=chunks:
                                  c.extend(p.stdout), daemon=True)
        reader.start()
        procs.append(proc)
        outs.append(chunks)
        readers.append(reader)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p, reader in zip(procs, readers):
            p.wait()
            reader.join()
    return [RankResult(p.returncode, "".join(c)) for p, c in zip(procs, outs)]
