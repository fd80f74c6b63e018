"""The last line of a run: its keys, in order, with the numbers compared
last (CPU)."""

import json
import time

import pytest

from benchmark import harness, run, spec, stream

pytest.importorskip("dc_sand_tpu_torch")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tmp_path, trace):
    bench = spec.load_benchmark()
    cell = spec.cell(bench, "fx64-stream")
    cs = spec.config("fx64")
    cfg = harness.chain_config("fx64", cs).replace(
        n_ants=2, n_chans=32, spectra_per_chunk=16, n_spectra_per_acc=64)
    out = stream.run_cell(cfg, cs, spec.traffic("stream"), 1, 0.1,
                          tmp_path / "t.json" if trace else None, "cpu",
                          time.time())
    out.update(kind="cpu (test)", power="none", memory_peak_bytes=0,
               intervals_ms=[1.0] * 30)
    line = json.loads(json.dumps(run.result(cell, bench, out, bool(trace),
                                            cs["check_limits"])))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert isinstance(line["correct"], bool)
    assert line["attempted"] == out["chunks"]
    assert set(line["checks"]) == set(cs["check_limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "idle_pct.fx64" in names
    else:
        assert names == {"gsamp_s", "chunk_p95_ms", "setup_s"}
