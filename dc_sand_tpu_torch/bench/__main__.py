"""The port's bench entry, live on the card.

Run from the repository root::

    python -m dc_sand_tpu_torch.bench [TARGET] [--out DIR]

With no target it measures the headline and prints ONE JSON line,
``{"metric", "value", "unit", "vs_baseline", "extra"}``: the fused
F-engine's channelized samples/s at 16 streams x 512 spectra x 4096
channels, ``vs_baseline`` its share of the whole array in real time
(``vs_array_realtime``), and in ``extra`` the rate at 1024 channels, the
shares of the H100 bound, the fx64 step at full width, the CMAC at fx64's
chunk and the card's name and power limit.  Every number is measured in
the run; none is read from a file.

With a target (:data:`TARGETS`) it prints each record as a JSON line.
``--out DIR`` saves the records there.  Without a card it exits non-zero
and prints no JSON; ``--device cpu`` runs on the CPU (the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

from dc_sand_tpu_torch.config import get_config

__all__ = ["main", "headline", "TARGETS"]

TARGETS = ("fengine", "pfb", "fx", "beam-step", "runner", "xcorr",
           "beamform", "fft", "membench", "probes", "ingest", "e2e",
           "collectives", "scaling")


def headline(device, *, n_chans: int = 4096, chans_1k: int = 1024,
             n_spectra: int = 512, fx_chans: int = 4096,
             fx_spectra: int = None, iters: int = 192) -> tuple:
    """The headline measurements: ``(line, records)``, ``line`` the JSON
    object the entry prints.  The defaults are the headline's shapes;
    the tests pass smaller ones."""
    from dc_sand_tpu_torch.bench.kernels import bench_xcorr
    from dc_sand_tpu_torch.bench.pipelines import (bench_fengine,
                                                   bench_fx_step)
    if fx_spectra is None:
        fx_spectra = get_config("fx64").spectra_per_chunk
    res = bench_fengine(n_streams=16, n_spectra=n_spectra, n_chans=n_chans,
                        iters=iters, device=device)
    res1k = bench_fengine(n_streams=16, n_spectra=n_spectra,
                          n_chans=chans_1k, iters=iters, device=device)
    xr = bench_xcorr(mode="native", n_chans=fx_chans, n_spectra=fx_spectra,
                     iters=max(1, iters // 6), device=device)
    fx = bench_fx_step(n_chans=fx_chans, n_spectra=fx_spectra,
                       iters=max(1, iters // 24), device=device)
    ex = res.extra
    line = {
        "metric": f"{res.metric} ({n_chans} chans, 16 x {n_spectra} spectra)",
        "value": res.value,
        "unit": res.unit,
        "vs_baseline": ex["vs_array_realtime"],
        "extra": {
            "platform": ex["platform"], "chip": ex["chip"],
            "card": ex.get("card"), "power_limit": ex.get("power_limit"),
            "gsamp_s_1k_chans": res1k.value / 1e9,
            "pct_of_bound": ex.get("pct_of_bound"),
            "pct_of_bound_1k": res1k.extra.get("pct_of_bound"),
            "fx_step_64ant": {
                "gsamp_s": fx.value / 1e9, "ms": fx.wall_s * 1e3,
                "n_chans": fx_chans, "n_spectra": fx_spectra,
                "vs_array_realtime": fx.extra["vs_array_realtime"],
                "pct_of_bound": fx.extra.get("pct_of_bound")},
            "xcorr_baselines_per_s_64ant": {
                "value": xr.value, "unit": xr.unit, "mode": "native",
                "ms": xr.wall_s * 1e3, "n_spectra": fx_spectra,
                "int8_tops": xr.extra.get("int8_tops"),
                "pct_of_bound": xr.extra.get("pct_of_bound")},
        },
    }
    return line, [res, res1k, xr, fx]


def _target(name: str, args, dev) -> list:
    """The records of bench target ``name`` (the JAX CLI's ``bench``
    targets, at its default shapes unless ``--scale`` or ``--spectra``
    say otherwise)."""
    from dc_sand_tpu_torch.bench import (collectives, kernels, membench,
                                         pipelines, probes, scaling)
    sp = {"n_spectra": args.spectra} if args.spectra else {}
    if name in ("fengine", "pfb"):
        return [pipelines.bench_fengine(impl=args.impl,
                                        full_chain=name == "fengine",
                                        n_chans=args.scale or 1024, **sp,
                                        device=dev)]
    if name == "fx":
        return [pipelines.bench_fx_step(n_chans=args.scale or 1024, **sp,
                                        device=dev)]
    if name == "beam-step":
        return [pipelines.bench_beam_step(n_chans=args.scale or 4096, **sp,
                                          device=dev)]
    if name == "runner":
        return pipelines.bench_runner_modes(
            n_chans=args.scale or 1024, device=dev,
            **({"spectra": args.spectra} if args.spectra else {}))
    if name == "xcorr":
        k = args.scale or 4096
        prod_b = args.spectra or get_config("fx64").spectra_per_chunk
        return [kernels.bench_xcorr(n_chans=k, **sp, device=dev),
                kernels.bench_xcorr(n_chans=k, n_spectra=prod_b, device=dev),
                kernels.bench_xcorr(n_chans=k, n_spectra=prod_b,
                                    mode="native", device=dev),
                kernels.bench_xcorr(n_chans=k, **sp, mode="extract",
                                    device=dev)]
    if name == "beamform":
        k = args.scale or 4096
        return [kernels.bench_beamform(n_chans=k, **sp, device=dev),
                kernels.bench_beamform(n_chans=k, **sp, quant_scale=0.25,
                                       device=dev),
                kernels.bench_beamform(n_beams=64, n_chans=k, **sp,
                                       quant_scale=0.25, device=dev)]
    if name == "fft":
        return kernels.bench_fft(n_chans=args.scale or 1024, **sp,
                                 device=dev)
    if name == "membench":
        return [membench.bench_membench(p, device=dev)
                for p in membench.PATTERNS] + [membench.bench_h2d(device=dev)]
    if name == "probes":
        return probes.bench_probes(device=dev)
    if name == "ingest":
        from dc_sand_tpu_torch.bench import ingest_bench as ib
        return [ib.bench_ingest_host(delay_in_ingest=True, zero_copy=True,
                                     n_workers=4, device=dev),
                ib.bench_ingest_host(delay_in_ingest=True, zero_copy=True,
                                     device=dev),
                ib.bench_ingest_host(delay_in_ingest=True, device=dev),
                ib.bench_ingest_host(delay_in_ingest=False, device=dev),
                ib.bench_ingest_udp(device=dev),
                ib.bench_ingest_udp(n_workers=4, device=dev),
                ib.bench_ingest_runner(device=dev)]
    if name == "e2e":
        from dc_sand_tpu_torch.bench import ingest_bench as ib
        kw = dict(spectra=args.spectra or 2048, n_chans=args.scale or 4096,
                  device=dev)
        # the whole chain fed from the host, then the same chunk loop on
        # chunks staged on the card
        return [ib.bench_e2e_atrate(**kw),
                ib.bench_e2e_atrate(feed="device_replay", **kw)]
    # the collectives run on a mesh of --mesh shards, shard i on card
    # (i mod the card count); with --distributed --mesh/world shards a rank
    # on its own card, beside (rank 0) the one-process mesh on that card;
    # the scaling sweep over the cards present
    from dc_sand_tpu_torch.parallel import build_global_mesh, build_mesh
    from dc_sand_tpu_torch.parallel.distributed import (process_count,
                                                        process_index)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if name == "collectives":
        if args.distributed:
            n = args.mesh // process_count()
            mesh = build_global_mesh([dev] * n)
            out = [collectives.bench_collective(op, mesh)
                   for op in collectives.COLLECTIVES]
            if process_index() == 0:
                one = build_mesh([dev] * args.mesh)
                out += [collectives.bench_collective(op, one)
                        for op in ("all_to_all_pallas", "ppermute_pallas")]
            return out
        devs = ([torch.device("cuda", i % n_cards) for i in range(args.mesh)]
                if n_cards else ["cpu"] * args.mesh)
        mesh = build_mesh(devs)
        return [collectives.bench_collective(op, mesh)
                for op in collectives.COLLECTIVES]
    devs = ([torch.device("cuda", i) for i in range(n_cards)] if n_cards
            else ["cpu"] * args.mesh)
    return scaling.bench_scaling(devs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dc_sand_tpu_torch.bench",
        description="The port's benchmarks, measured live on the card.")
    ap.add_argument("target", nargs="?", choices=TARGETS,
                    help="one bench target; none: the headline JSON line")
    ap.add_argument("--out", help="directory to save the records in")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the tests)")
    ap.add_argument("--scale", type=int, help="channels of a target")
    ap.add_argument("--spectra", type=int, help="spectra of a target")
    ap.add_argument("--impl", default="fused", choices=("fused", "unfused"),
                    help="the F-engine path of fengine/pfb")
    ap.add_argument("--mesh", type=int, default=4,
                    help="shards of the collectives' mesh (and CPU devices "
                         "of the scaling sweep)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "to DIR/<target>_trace.json")
    ap.add_argument("--distributed", action="store_true",
                    help="collectives across the torch.distributed ranks "
                         "of the launcher's environment (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT), --mesh shards in all; "
                         "rank 0 prints the records")
    args = ap.parse_args(argv)
    if args.distributed and args.target != "collectives":
        ap.error("--distributed applies to the collectives target")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("dc_sand_tpu_torch.bench: no CUDA device is present; "
                  "nothing measured", file=sys.stderr)
            return 1
        if args.distributed:
            from dc_sand_tpu_torch.parallel.distributed import local_rank
            dev = torch.device("cuda",
                               local_rank() % torch.cuda.device_count())
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if args.distributed:
        from dc_sand_tpu_torch.parallel.distributed import init_distributed
        init_distributed()
    ctx = contextlib.nullcontext()
    if args.profile:
        from dc_sand_tpu_torch.profile_step import chrome_trace
        trace = os.path.join(args.profile,
                             f"{args.target or 'headline'}_trace.json")
        ctx = chrome_trace(trace, cuda=dev.type == "cuda")
    with ctx:
        if args.target is None:
            line, results = headline(dev)
        else:
            results = _target(args.target, args, dev)
    if args.distributed:
        from dc_sand_tpu_torch.parallel import ipc
        from dc_sand_tpu_torch.parallel.distributed import process_index
        ipc.close_all()
        if process_index():
            results = []
    if args.target is None:
        print(json.dumps(line), flush=True)
    else:
        for res in results:
            print(res.to_json(), flush=True)
    if args.profile:
        print(f"dc_sand_tpu_torch.bench: trace written to {trace}",
              file=sys.stderr)
    if args.out:
        for res in results:
            res.save(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
