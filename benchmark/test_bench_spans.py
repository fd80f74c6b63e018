"""The readers of the runner's spans (benchmark/spans.py and the metrics
that use it): on a traced run of each cell at a tiny size on the CPU,
and on hand-made traces whose numbers are known (CPU)."""

import time

import pytest

from benchmark import harness, spec, stream
from benchmark.spans import CHUNK, mean_ms, spans
from benchmark.trace import Rank, Trace

pytest.importorskip("dc_sand_tpu_torch")

SMALL = {"fx64": dict(n_ants=2, n_chans=32, spectra_per_chunk=16,
                      n_spectra_per_acc=64),
         "beam64": dict(n_ants=2, n_chans=32, spectra_per_chunk=16)}
READERS = ("host_busy_ms", "upload_ms", "dump_wait_ms")


@pytest.fixture(scope="module", params=sorted(SMALL))
def traced(request, tmp_path_factory):
    name = request.param
    cs = spec.config(name)
    cfg = harness.chain_config(name, cs).replace(**SMALL[name])
    path = tmp_path_factory.mktemp(name) / "t.json"
    out = stream.run_cell(cfg, cs, spec.traffic("stream"), 2 ** 31 + 5,
                          0.1, path, "cpu", time.time())
    return name, out["trace"]


def test_a_traced_run_reports_the_runner_spans(traced):
    name, trace = traced
    chunk_us = [d for d, _ in spans(trace, CHUNK)]
    assert len(chunk_us) == trace.chunks
    busy = spec.reader(f"host_busy_ms.{name}")(trace)
    upload = spec.reader(f"upload_ms.{name}")(trace)
    assert busy > 0 and upload > 0
    assert busy <= mean_ms(chunk_us)
    assert upload < max(chunk_us) / 1e3
    # the CPU has no dump copy to wait for
    assert spec.reader("dump_wait_ms")(trace) is None


def _trace(host) -> Trace:
    """A one-rank trace of the window (0, 1000) us on thread 1."""
    window = (0.0, 1000.0)
    host = [(0.0, 1000.0, "bench.window", 1, "user_annotation", None)] + [
        (a, b, n, tid, "user_annotation" if n.startswith("runner")
         else "cuda_runtime", None) for a, b, n, tid in host]
    return Trace([Rank(window, [], host, 1)], None, 1, 2, 1)


def test_the_readers_on_known_spans():
    trace = _trace([
        (10, 110, "runner.chunk", 1), (20, 30, "runner.upload", 1),
        (22, 28, "cudaStreamSynchronize", 1),
        (200, 500, "runner.chunk", 1), (210, 250, "runner.upload", 1),
        (215, 245, "cudaStreamSynchronize", 1),
        (300, 320, "cudaLaunchKernel", 1),
        # another thread's wait is not the window's
        (400, 480, "cudaStreamSynchronize", 2),
        (600, 700, "runner.dump", 1), (650, 690, "runner.dump.wait", 1),
        (651, 689, "cudaStreamSynchronize", 1),
        # a span on another thread or outside the window is not read
        (700, 800, "runner.chunk", 2), (1200, 1300, "runner.chunk", 1)])
    assert spec.reader("host_busy_ms.fx64")(trace) == pytest.approx(
        ((100 - 6) + (300 - 30)) / 2 / 1e3)
    assert spec.reader("upload_ms.beam64")(trace) == pytest.approx(
        (10 + 40) / 2 / 1e3)
    assert spec.reader("dump_wait_ms")(trace) == pytest.approx(40 / 1e3)


@pytest.mark.parametrize("reader", READERS)
def test_a_trace_without_runner_spans_reads_none(reader):
    trace = _trace([(10, 110, "aten::copy_", 1),
                    (20, 30, "cudaStreamSynchronize", 1),
                    (300, 400, "bench.dump", 1)])
    assert spec.reader(reader)(trace) is None
