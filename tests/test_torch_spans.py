"""The runner's spans (``dc_sand_tpu_torch/utils/spans.py``): the tree a
profiled run exports, in fx, beam and F-engine mode, in both coarse
modes, on a mesh and in ``run_batched``; that no span is entered
without a profiler; and that a profiled run's dumps, outputs and
counters are bitwise those of a run without one (CPU)."""

import contextlib
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dc_sand_tpu_torch.config import get_config
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.utils import spans
from dc_sand_tpu_torch.windows import pfb_window

N_CHUNKS = 8
# (config, runner keywords): a dump every 4 chunks in fx mode
CASES = {
    "fx": ("fx64", {"coarse_on_host": False}),
    "fx-host-coarse": ("fx64", {"coarse_on_host": True}),
    "fx-mesh2": ("fx64", {"mesh": "cpu2"}),
    "beam": ("beam64", {"coarse_on_host": False}),
    "fengine": ("pfb4k", {}),
}


def _runner(case):
    name, kw = CASES[case]
    kw = dict(kw)
    cfg = get_config(name).replace(n_chans=32, spectra_per_chunk=16,
                                   n_spectra_per_acc=64)
    if cfg.n_ants > 2:
        cfg = cfg.replace(n_ants=2)
    rng = np.random.default_rng(7)
    a, p = cfg.n_ants, cfg.n_pols
    dm = DelayModel.zeros(a, p, max_delay=8)
    dm.d0 = rng.integers(0, 8, (a, p)).astype(float)
    dm.d1 = np.full((a, p), 2e-4)
    dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    weights = rng.normal(size=(max(cfg.n_beams, 1), a, cfg.n_chans, 2))
    if kw.get("mesh") == "cpu2":
        kw["mesh"] = build_mesh(["cpu"] * 2)
    else:
        kw["device"] = "cpu"
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                      delay_model=dm, weights=weights.astype(np.float32),
                      **kw)
    ring = [rng.integers(-40, 40, (a, p, cfg.chunk_samples), dtype=np.int8)
            for _ in range(3)]
    return runner, (lambda i: ring[i % len(ring)])


def _run(case, batched=False):
    """``(dumps, outputs, counters)`` of N_CHUNKS chunks."""
    runner, source = _runner(case)
    outputs = []

    def on_output(i, o):
        outputs.append((i, {k: v.clone() for k, v in o.items()}))

    if batched:
        dumps, counters = runner.run_batched(source, N_CHUNKS)
    else:
        dumps, counters = runner.run(source, N_CHUNKS, on_output=on_output)
    return dumps, outputs, dataclasses.asdict(counters)


def _profiled(tmp_path, fn):
    """``fn()``'s result under the CPU profiler, and the exported runner
    spans as ``{"name", "lo", "hi", "children"}`` trees (ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("runner.")]
    assert len({e["tid"] for e in events}) == 1
    nodes = sorted(({"name": e["name"], "lo": round(e["ts"] * 1e3),
                     "hi": round((e["ts"] + e["dur"]) * 1e3),
                     "children": []} for e in events),
                   key=lambda n: (n["lo"], -n["hi"]))
    roots, stack = [], []
    for n in nodes:
        while stack and stack[-1]["hi"] <= n["lo"]:
            stack.pop()
        if stack:
            assert n["hi"] <= stack[-1]["hi"], "spans overlap"
        (stack[-1]["children"] if stack else roots).append(n)
        stack.append(n)
    return out, roots


def _names(nodes):
    return Counter(n["name"] for n in nodes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree(tmp_path, case):
    """One runner.run holding a runner.chunk a chunk, each with one feed,
    upload and launch (and in beam and F-engine mode one output), and a
    runner.dump every 4 chunks beside the chunks; the CPU has no dump
    wait."""
    (dumps, outputs, _), roots = _profiled(tmp_path, lambda: _run(case))
    assert [r["name"] for r in roots] == ["runner.run"]
    top = roots[0]["children"]
    fx = CASES[case][0] == "fx64"
    assert _names(top) == Counter({"runner.chunk": N_CHUNKS,
                                   "runner.dump": len(dumps)})
    assert len(dumps) == (N_CHUNKS // 4 if fx else 0)
    assert len(outputs) == (0 if fx else N_CHUNKS)
    steps = Counter({"runner.feed": 1, "runner.upload": 1,
                     "runner.launch": 1})
    if not fx:
        steps["runner.output"] = 1
    chunks = [n for n in top if n["name"] == "runner.chunk"]
    for c in chunks:
        assert _names(c["children"]) == steps
        assert [n["name"] for n in c["children"]][:3] == [
            "runner.feed", "runner.upload", "runner.launch"]
    # a dump follows its window's fourth chunk
    order = [n["name"] for n in top]
    for k in range(len(dumps)):
        assert order[5 * k + 4] == "runner.dump"
    for d in (n for n in top if n["name"] == "runner.dump"):
        assert d["children"] == []


def test_run_batched_spans(tmp_path):
    """run_batched off the graph: a feed and an upload a chunk and a dump a
    window, under no runner.run or runner.chunk."""
    (dumps, _, _), roots = _profiled(tmp_path,
                                     lambda: _run("fx", batched=True))
    assert len(dumps) == N_CHUNKS // 4
    assert _names(roots) == Counter({"runner.feed": N_CHUNKS,
                                     "runner.upload": N_CHUNKS,
                                     "runner.dump": len(dumps)})


@pytest.mark.parametrize("case,batched", [
    ("fx", False), ("fx", True), ("beam", False), ("fengine", False)])
def test_no_span_entered_without_a_profiler(monkeypatch, case, batched):
    """With no profiler running the runner never builds a
    record_function: the span is the shared no-op."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _run(case, batched)[2]["chunks_in"] == N_CHUNKS


@pytest.mark.parametrize("case,batched", [
    ("fx", False), ("fx", True), ("fx-mesh2", False), ("beam", False),
    ("fengine", False)])
def test_profiled_run_is_bitwise_the_plain_one(tmp_path, case, batched):
    plain = _run(case, batched)
    traced, _ = _profiled(tmp_path, lambda: _run(case, batched))
    (d0, o0, c0), (d1, o1, c1) = plain, traced
    assert c0 == c1
    assert len(d0) == len(d1)
    for a, b in zip(d0, d1):
        assert (a.n_spectra, a.n_spectra_nominal, a.first_chunk) == (
            b.n_spectra, b.n_spectra_nominal, b.first_chunk)
        np.testing.assert_array_equal(a.vis, b.vis)
    assert [i for i, _ in o0] == [i for i, _ in o1]
    for (_, a), (_, b) in zip(o0, o1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_span_is_the_shared_no_op_without_a_profiler():
    assert spans.span("runner.a") is spans.span("runner.b")
    assert isinstance(spans.span("runner.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        s = spans.span("runner.a")
        assert isinstance(s, torch.profiler.record_function)
    assert isinstance(spans.span("runner.a"), contextlib.nullcontext)
