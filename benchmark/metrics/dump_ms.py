"""The dump (FXRunner._dump: ops/xcorr.py extract_vis and the pinned
device-to-host copy): device ms a dump, the union of the device
operations launched inside each bench.dump span, averaged over the
dumps of the traced window (none where the trace links no
operation to a dump)."""

from benchmark.trace import DUMP


def read(trace):
    per = [s for s in trace.annotated_device_s(DUMP) if s > 0]
    return 1e3 * sum(per) / len(per) if per else None
