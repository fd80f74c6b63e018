"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the card, in one process:

    python -m benchmark.readings --workload NAME --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2]

For each seed it runs the cell as ``benchmark.run`` does (a short
window) and prints the program's numbers; for each control seed also the
control's, the chain one precision step below the configuration's (TF32
for its float32: :mod:`benchmark.reference`) in the program's place, on
the same answers.  One JSON line a seed.  The lower reading of a number is
the largest the program gives, the upper the smallest the control gives.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from benchmark import harness, spec, stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg_spec = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.chain_config(cell["config"], cfg_spec)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.time()
        out = stream.run_cell(cfg, cfg_spec, traffic, seed, args.seconds,
                              None, "cuda", t)
        line = {"seed": seed, "program": out["readings"],
                "chunks": out["chunks"], "setup_s": out["setup_s"],
                "answers": out["answer_chunks"]}
        if seed in control:
            tc = time.time()
            line["control"] = harness.worst(harness.check(
                cfg, out["inputs"], [(i, None) for i in
                                     out["answer_chunks"]], "tf32"))
            line["control_s"] = time.time() - tc
        line["seconds"] = time.time() - t
        print(json.dumps(line), flush=True)
        out = None
        harness.free_program()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
