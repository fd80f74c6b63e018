"""chunk_p95_ms: the 95th percentile, over every chunk of the window, of
the interval between consecutive chunk completions, from CUDA events
recorded on the runner's stream as each chunk is handed over."""

from benchmark.harness import p95


def read(run):
    return p95(run["intervals_ms"]) if run.get("intervals_ms") else None
