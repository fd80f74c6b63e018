"""A cell over several ranks of one host: the run starts one process a
rank through the port's launcher (``parallel/launch.py:run_ranks``), each
rank drives its own runner over the global mesh, feeding its own
antennas of the same seeded ring, and rank 0 checks the node's dumps
once every rank is done with the cards.

The ranks agree on the window's end: after each call (a dump window of
chunks) rank 0 broadcasts whether its clock has passed ``--seconds``.

    python -m benchmark.mesh PAYLOAD_JSON      (one rank; run_cell starts
                                                 them)
"""

from __future__ import annotations

import json
import sys
import time

from benchmark import harness, spec, trace as trace_mod
from benchmark.inputs import make_inputs

RESULT = "RANK_RESULT "


def run_cell(cell: dict, cfg, cfg_spec: dict, traffic: dict, seed: int,
             seconds: float, trace_path, t_start: float,
             device: str = "cuda", patch: str = None) -> dict:
    """Run the cell's ranks and gather their records as one run's.
    ``device="cpu"`` runs the ranks on the CPU (the tests); ``patch``
    (``module:function``) is called with each rank's runner before the
    window, so that a test can break the timed path."""
    import dataclasses
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.parallel.launch import run_ranks
    world = traffic["ranks"]
    if device == "cuda":
        # built once here, so that the ranks load the kernels rather than
        # each building them at once
        _build.library()
    payload = {"cfg": dataclasses.asdict(cfg), "spec": cfg_spec,
               "traffic": traffic, "seed": seed, "seconds": seconds,
               "trace": None if trace_path is None else str(trace_path),
               "device": device, "patch": patch}
    results = run_ranks([sys.executable, "-m", "benchmark.mesh",
                         json.dumps(payload)], world, timeout=300.0,
                        cwd=str(spec.ROOT))
    recs = []
    for r, res in enumerate(results):
        lines = [ln for ln in res.output.splitlines()
                 if ln.startswith(RESULT)]
        if res.returncode != 0 or not lines:
            raise RuntimeError(f"rank {r} of {cell['name']} failed "
                               f"({res.returncode}):\n{res.output[-6000:]}")
        recs.append(json.loads(lines[-1][len(RESULT):]))
    out = dict(recs[0])
    out["setup_s"] = out.pop("start_epoch") - t_start
    out["memory_peak_bytes"] = max(x["memory_peak_bytes"] for x in recs)
    if trace_path is not None:
        out["trace"] = trace_mod.Trace(
            [trace_mod.load_rank(_rank_path(trace_path, r))
             for r in range(world)], cfg, world, out["chunks"],
            out["dumps"])
    return out


def _rank_path(path, rank: int) -> str:
    return f"{path}.rank{rank}"


def rank_main(payload: dict) -> dict:
    """One rank: set-up, the window, its trace and, on rank 0, the check
    of the node's kept dumps."""
    import importlib
    import torch
    import torch.distributed as dist
    from dc_sand_tpu_torch.config import ChainConfig
    from dc_sand_tpu_torch.parallel import build_global_mesh, ipc
    from dc_sand_tpu_torch.parallel.distributed import (init_distributed,
                                                        local_antenna_range,
                                                        local_cards)
    from benchmark import stream
    cfg = ChainConfig(**payload["cfg"])
    traffic, seed = payload["traffic"], payload["seed"]
    max_delay = payload["spec"]["max_delay"]
    answers = payload["spec"]["check_answers"]
    torch.set_num_threads(1)
    init_distributed()
    if payload["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cards = local_cards()
        torch.cuda.set_device(cards[0])
        dev, devs = cards[0], cards
    else:
        dev, devs = torch.device("cpu"), ["cpu"]
    rank = dist.get_rank()
    mesh = build_global_mesh(devs)
    a0, a1 = local_antenna_range(cfg.n_ants)
    inputs = make_inputs(seed, traffic, cfg, max_delay, dev,
                         rows=slice(a0, a1))
    runner = harness.build_runner(cfg, inputs, traffic, mesh=mesh)
    per_call = harness.chunks_per_call(cfg, inputs.ring)
    harness.warm_up(runner, inputs.ring, answers + 1)
    if payload["patch"]:
        mod, _, fn = payload["patch"].partition(":")
        getattr(importlib.import_module(mod), fn)(runner)
    window = harness.Window(runner, inputs.ring, harness.Sample(
        seed, answers if rank == 0 else 1))
    flag = torch.zeros(1, dtype=torch.int32)

    def stop(elapsed: float) -> bool:
        flag[0] = int(elapsed >= payload["seconds"])
        dist.broadcast(flag, 0)
        return bool(flag[0])

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    path = payload["trace"] and _rank_path(payload["trace"], rank)
    with stream._profiled(path, runner) as prof:
        out = window.run(payload["seconds"], per_call, stop)
    dist.barrier()
    harness.within_delay_budget(cfg, traffic, max_delay, runner.chunk_idx)
    out["samples_per_chunk"] = cfg.n_ants * cfg.n_pols * cfg.chunk_samples
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        out["intervals_ms"] = window.intervals_ms()
    if prof is not None:
        prof.export_chrome_trace(path)
    answers = window.sample.answers() if rank == 0 else []
    window = runner = inputs = None
    ipc.close_all()
    harness.free_program()
    dist.barrier()
    dist.destroy_process_group()
    out["failed"] = 0
    out["readings"] = {}
    out["check_s"] = 0.0
    out["answer_chunks"] = [i for i, _ in answers]
    if rank == 0:
        full = make_inputs(seed, traffic, cfg, max_delay, dev)
        t = time.perf_counter()
        per_answer = harness.check(cfg, full, answers)
        out["check_s"] = time.perf_counter() - t
        out["readings"] = harness.worst(per_answer)
        limits = payload["spec"]["check_limits"]
        out["failed"] = sum(1 for r in per_answer
                            if any(not v <= limits.get(k, float("inf"))
                                   for k, v in r.items()))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = rank_main(json.loads(argv[0]))
    print(RESULT + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
