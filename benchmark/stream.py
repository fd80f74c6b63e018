"""One process on one card (or, in the tests, the CPU): set-up, the
window, the traced window, and the check of the kept answers."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from benchmark import harness, trace as trace_mod
from benchmark.inputs import make_inputs


def run_cell(cfg, cfg_spec: dict, traffic: dict, seed: int, seconds: float,
             trace_path, device, t_start: float, patch=None) -> dict:
    """Run one cell once in this process.  ``cfg`` is the port's
    ``ChainConfig``, ``cfg_spec`` the configuration's file (its
    ``max_delay``, ``check_answers`` and ``check_limits``), ``t_start``
    the epoch second the run began,
    ``trace_path`` None or where the Chrome trace goes; ``patch``, when
    given, is called with the runner before the window (the tests break
    the timed path with it).  Returns the window's numbers, the kept
    answers' check (the program freed first) and, with a trace, the
    :class:`~benchmark.trace.Trace` of the window."""
    device = torch.device(device)
    limits, answers = cfg_spec["check_limits"], cfg_spec["check_answers"]
    inputs = make_inputs(seed, traffic, cfg, cfg_spec["max_delay"], device)
    runner = harness.build_runner(cfg, inputs, traffic, device=device)
    per_call = harness.chunks_per_call(cfg, inputs.ring)
    harness.warm_up(runner, inputs.ring, answers + 1)
    if patch is not None:
        patch(runner)
    window = harness.Window(runner, inputs.ring,
                            harness.Sample(seed, answers))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with _profiled(trace_path, runner) as prof:
        out = window.run(seconds, per_call)
    out["setup_s"] = out.pop("start_epoch") - t_start
    harness.within_delay_budget(cfg, traffic, cfg_spec["max_delay"],
                                runner.chunk_idx)
    out["samples_per_chunk"] = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    if device.type == "cuda":
        out["intervals_ms"] = window.intervals_ms()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        prof.export_chrome_trace(str(trace_path))
        out["trace"] = trace_mod.Trace(
            [trace_mod.load_rank(trace_path)], cfg, 1, out["chunks"],
            out["dumps"])
    answers = window.sample.answers()
    window = runner = None
    harness.free_program()
    t = time.perf_counter()
    per_answer = harness.check(cfg, inputs, answers)
    out["check_s"] = time.perf_counter() - t
    out["readings"] = harness.worst(per_answer)
    out["failed"] = sum(1 for r in per_answer
                        if any(not v <= limits.get(k, float("inf"))
                               for k, v in r.items()))
    out["inputs"] = inputs
    out["answer_chunks"] = [i for i, _ in answers]
    return out


@contextlib.contextmanager
def _profiled(path, runner):
    """``torch.profiler`` over the window with the dumps inside spans of
    their own, when ``path`` is given."""
    if path is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    dump = runner._dump

    def traced_dump(*args, **kw):
        with record_function(trace_mod.DUMP):
            return dump(*args, **kw)

    runner._dump = traced_dump
    acts = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace_mod.WINDOW):
            yield prof
    runner._dump = dump
