"""The program's own spans in a traced window: the ``record_function``
ranges that ``dc_sand_tpu_torch/utils/spans.py`` opens in the runner
(``runner.chunk``, ``runner.upload``, ``runner.dump.wait``, ...), found
as ``user_annotation`` events on each rank's window thread, each with the
time that thread spent blocked on the card inside it.  A trace of a
program without such spans holds none, and the readers then return
None."""

from __future__ import annotations

import bisect

from benchmark.trace import union_us

# the CUDA runtime calls in which the host waits for the card
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")
CHUNK = "runner.chunk"
UPLOAD = "runner.upload"
DUMP_WAIT = "runner.dump.wait"


def spans(trace, name: str) -> list:
    """``(duration_us, blocked_us)`` of each span ``name`` that starts in
    its rank's window on the window's thread, in order of start within a
    rank, ranks in order: its length, and that thread's time inside the
    :data:`BLOCKING` calls within it."""
    out = []
    for r in trace.ranks:
        lo, hi = r.window
        mine = sorted((a, b) for a, b, n, tid, cat, _ in r.host
                      if n == name and cat == "user_annotation"
                      and tid == r.tid and lo <= a < hi)
        waits = sorted((a, b) for a, b, n, tid, _, _ in r.host
                       if n in BLOCKING and tid == r.tid)
        starts = [w[0] for w in waits]
        for a, b in mine:
            j = bisect.bisect_left(starts, a)
            inside = []
            while j < len(waits) and waits[j][0] < b:
                inside.append((waits[j][0], min(waits[j][1], b)))
                j += 1
            out.append((b - a, union_us(inside)))
    return out


def mean_ms(values_us: list):
    """The mean of ``values_us`` in ms; None for none."""
    return sum(values_us) / len(values_us) / 1e3 if values_us else None
