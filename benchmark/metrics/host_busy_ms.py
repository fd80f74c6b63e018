"""The runner's own host work a chunk: over the window's runner.chunk
spans (FXRunner.run, from the feed through the output handoff), the mean
of each span's length less its thread's time blocked on the card inside
it (benchmark/spans.py: BLOCKING), in ms; None where the trace holds no
runner.chunk span."""

from benchmark.spans import CHUNK, mean_ms, spans


def read(trace):
    return mean_ms([d - w for d, w in spans(trace, CHUNK)])
