"""The chunk's upload (FXRunner._step_args: the chunk and its delay
tables cut to the shards and copied to the card, with the synchronise
the copies bring): the mean length of the window's runner.upload spans,
in ms; None where the trace holds none."""

from benchmark.spans import UPLOAD, mean_ms, spans


def read(trace):
    return mean_ms([d for d, _ in spans(trace, UPLOAD)])
