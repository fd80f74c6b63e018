"""What a ``--trace 1`` run reads from ``torch.profiler``'s Chrome trace,
and the arithmetic of the per-layer metrics over it.

The run records spans of its own around the calls into the program
(``bench.window`` around the traced window, ``bench.dump`` around each
dump); device time is taken from the trace's kernel, copy and memset
events.  The union of device intervals and the idle share are copied
from ``dc_sand_tpu_torch/profile_step.py`` (``_union_us``,
``card_spans_us``, ``idle_share``), so the benchmark keeps them however
the program changes.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "bench.window"
DUMP = "bench.dump"


def union_us(spans, lo: float = float("-inf")) -> float:
    """Length of the union of the intervals ``spans``, from ``lo`` on."""
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    return busy


def merged(spans) -> list:
    """The union of ``spans`` as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclasses.dataclass
class Rank:
    """One process's trace on the host's clock (microseconds): its window,
    its device events ``(name, lo, hi, card, correlation)`` inside it,
    its host events and the window's thread."""
    window: tuple
    device: list
    host: list
    tid: object


def load_rank(path) -> Rank:
    """Read one process's Chrome trace (written by
    ``profile.export_chrome_trace``)."""
    doc = json.loads(Path(path).read_text())
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    events = doc["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"{path}: no {WINDOW} span in the trace")
    w = win[0]
    lo, hi = base + w["ts"], base + w["ts"] + w["dur"]
    device, host = [], []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        a, b = base + e["ts"], base + e["ts"] + e["dur"]
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            if b > lo and a < hi:
                args = e.get("args", {})
                device.append((e["name"], max(a, lo), min(b, hi),
                               int(args.get("device", 0)),
                               args.get("correlation")))
        elif cat in HOST_CATS:
            host.append((a, b, e["name"], e.get("tid"), cat,
                         e.get("args", {}).get("correlation")))
    return Rank((lo, hi), device, host, w.get("tid"))


@dataclasses.dataclass
class Trace:
    """The traced window of a run, one :class:`Rank` a process, with what
    the readers need of the cell: ``cfg`` (the port's ``ChainConfig``),
    ``cards`` (the cards the run used), ``chunks`` and ``dumps`` in the
    traced window (of the whole node)."""
    ranks: list
    cfg: object
    cards: int
    chunks: int
    dumps: int

    @property
    def window_us(self) -> tuple:
        return (min(r.window[0] for r in self.ranks),
                max(r.window[1] for r in self.ranks))

    @property
    def window_s(self) -> float:
        lo, hi = self.window_us
        return (hi - lo) / 1e6

    def busy_s(self) -> float:
        """Seconds in which an operation ran, each card's union of device
        intervals over the span of every rank's window, averaged over the
        cards."""
        lo, hi = self.window_us
        by_card = defaultdict(list)
        for r in self.ranks:
            for _, a, b, card, _ in r.device:
                by_card[card].append((max(a, lo), min(b, hi)))
        return sum(union_us(v) for v in by_card.values()) / 1e6 / max(
            self.cards, 1)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernel_time(self, names) -> tuple:
        """``(launches, seconds)`` of the device events whose name holds
        any of ``names``, over every rank."""
        n, t = 0, 0.0
        for r in self.ranks:
            for name, a, b, _, _ in r.device:
                if any(x in name for x in names):
                    n += 1
                    t += (b - a) / 1e6
        return n, t

    def roofline_pct(self, names, bound_s: float):
        """A kernel's share of its roofline: its launches' bound over
        their time, in percent; None when the trace holds none."""
        n, t = self.kernel_time(names)
        return 100.0 * n * bound_s / t if n and t > 0 else None

    def annotated_device_s(self, span: str) -> list:
        """For each host span named ``span``: the union of the device
        intervals of the operations launched inside it (matched by the
        launch's correlation id), in seconds."""
        out = []
        for r in self.ranks:
            by_corr = defaultdict(list)
            for _, a, b, _, corr in r.device:
                if corr is not None:
                    by_corr[corr].append((a, b))
            spans = sorted((a, b, tid) for a, b, name, tid, cat, _ in r.host
                           if name == span and cat == "user_annotation")
            calls = sorted((a, tid, corr) for a, _, _, tid, cat, corr
                           in r.host if cat == "cuda_runtime"
                           and corr is not None)
            starts = [c[0] for c in calls]
            for a, b, tid in spans:
                j = bisect.bisect_left(starts, a)
                ivals = []
                while j < len(calls) and calls[j][0] <= b:
                    if calls[j][1] == tid:
                        ivals += by_corr.get(calls[j][2], [])
                    j += 1
                out.append(union_us(ivals) / 1e6)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the first rank's cards by the innermost host operation of
        the window's thread at each gap's middle, each ``[[name,
        seconds], ...]``, at most ``top`` of each."""
        ops = defaultdict(float)
        for r in self.ranks:
            for name, a, b, _, _ in r.device:
                ops[name] += (b - a) / 1e6
        r = self.ranks[0]
        lo, hi = r.window
        busy = merged([(a, b) for _, a, b, _, _ in r.device])
        gaps, end = [], lo
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        host = sorted((a, b, name) for a, b, name, tid, _, _ in r.host
                      if tid == r.tid)
        by_what = defaultdict(float)
        stack, k = [], 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (g0 + g1) / 2
            while k < len(host) and host[k][0] <= mid:
                stack.append(host[k])
                k += 1
            stack = [h for h in stack if h[1] > mid]
            what = max(stack, key=lambda h: h[0])[2] if stack else "(none)"
            by_what[what] += (g1 - g0) / 1e6
        rank = lambda d: [[n, s] for n, s in sorted(  # noqa: E731
            d.items(), key=lambda x: -x[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(by_what)}
