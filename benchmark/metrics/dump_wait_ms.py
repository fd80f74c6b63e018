"""The dump's wait (FXRunner._dump): the mean length of the window's
runner.dump.wait spans, one a dump, the host blocked until the dump's
copy to pinned memory has landed, in ms; None where the trace holds
none (a run without them, or on the CPU)."""

from benchmark.spans import DUMP_WAIT, mean_ms, spans


def read(trace):
    return mean_ms([d for d, _ in spans(trace, DUMP_WAIT)])
