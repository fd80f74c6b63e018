"""Run one cell of ``BENCHMARK.json`` once, from the repository's root:

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

It makes the cell's inputs from the seed, builds the program, warms it
up, drives it for ``--seconds`` (with ``--trace 1`` under
``torch.profiler``), then compares the kept answers with the plain
reference and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted`` (chunks in the window), ``failed``
(kept answers over a limit), ``metrics`` (the cell's end-to-end metrics,
or its per-layer ones with ``--trace 1``), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``, each number compared beside
its limit; the same numbers end standard error.  It exits non-zero and
prints no result without the cards the cell asks for, and where
``jax``, ``jaxlib``, ``flax`` or ``dc_sand_tpu`` is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dc_sand_tpu")
# one process a card, one thread of host compute: the program's host
# work is small, and idle worker threads only add jitter on a host that
# other jobs share (set before numpy or torch is imported; the ranks of
# a multi-card cell inherit it)
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def forbidden_modules() -> list:
    """The forbidden packages loaded in this process, by whole top-level
    name (``dc_sand_tpu_torch`` is not ``dc_sand_tpu``)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power() -> str:
    """The first card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def caches(root) -> None:
    """Keep every compile cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "benchmark_cache" / sub)


def result(cell: dict, bench: dict, out: dict, trace: bool,
           limits: dict) -> dict:
    """The result line of a run's record ``out``."""
    from benchmark import compare, spec
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        value = spec.reader(m["name"])(out["trace"] if trace else out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = compare.judge(out["readings"], limits)
    device = {"platform": "gpu", "kind": out["kind"], "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": out["power"]}
    line = {"correct": correct, "attempted": out["chunks"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        t = out["trace"]
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        line["breakdown"] = t.breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(THREADS)
    from benchmark import harness, spec
    t_start = harness.process_start()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg_spec = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    caches(spec.ROOT)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.chain_config(cell["config"], cfg_spec)
    limits = cfg_spec["check_limits"]
    trace_path = (spec.ROOT / "build" / "benchmark" /
                  f"{cell['name']}.trace.json") if args.trace else None
    if traffic["ranks"] > 1:
        from benchmark import mesh
        out = mesh.run_cell(cell, cfg, cfg_spec, traffic, args.seed,
                            args.seconds, trace_path, t_start)
    else:
        from benchmark import stream
        out = stream.run_cell(cfg, cfg_spec, traffic, args.seed,
                              args.seconds, trace_path, "cuda", t_start)
    out["kind"] = torch.cuda.get_device_name(0)
    out["power"] = card_power()
    line = result(cell, bench, out, bool(args.trace), limits)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    print(f"card: {out['power']}; the check of {len(out['answer_chunks'])} "
          f"kept answers took {out['check_s']:.1f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
