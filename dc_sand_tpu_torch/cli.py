"""Command line of the port: run / verify / bench / regress / info.

    python -m dc_sand_tpu_torch.cli run fx4 --chunks 8
    python -m dc_sand_tpu_torch.cli run fx64 --batched --checkpoint state
    python -m dc_sand_tpu_torch.cli verify fx64 --production-cadence
    python -m dc_sand_tpu_torch.cli bench runner
    python -m dc_sand_tpu_torch.cli regress build/bench
    python -m dc_sand_tpu_torch.cli info

PyTorch counterpart of :mod:`dc_sand_tpu.cli`, with its subcommands and
output lines.  Every command runs on the current CUDA card and raises
without one; ``--cpu`` runs it on the CPU (the kernels' plain versions).
``--mesh N`` runs the sharded step over N shards, shard i on ``cuda:(i
mod the card count)`` (N CPU shards with ``--cpu``); ``--time-shards``
and ``--beam-parallel`` pick SP and the beam-sharded B-engine on it.
``--impl`` picks the F-engine path: ``fused`` (K1; ``auto`` is the
same) or ``unfused`` (K6 and PyTorch ops).  ``bench`` hands its
arguments to :func:`dc_sand_tpu_torch.bench.__main__.main` (``--cpu``
becomes ``--device cpu``).

``--distributed`` (every subcommand) joins the ``torch.distributed``
ranks of the launcher's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun`` sets them), prints
``distributed: {...}`` and runs over the global mesh of ``--mesh N``
shards (default: one a rank), ``N / world`` on each rank, on
``cuda:(LOCAL_RANK mod the card count)`` or on CPU shards with ``--cpu``;
with ``--time-shards`` the time axis runs within each rank
(``time_local``), as the multi-process runner needs.  Each rank feeds its
own antennas and prints its own lines.  The ranks may span nodes: ranks of
one node reach each other through CUDA IPC, ranks of different nodes over
the staged route (pinned host slots and gloo), as the node map of
``init_distributed`` says::

    torchrun --nproc-per-node 2 -m dc_sand_tpu_torch.cli verify fx4 \
        --distributed --mesh 4
    torchrun --nnodes 2 --node-rank R --nproc-per-node 2 \
        --master-addr HOST0 --master-port 29500 \
        -m dc_sand_tpu_torch.cli verify fx4 --distributed --mesh 4

Not ported: ``--stage2`` and the ``*_interpret`` impls (knobs of the TPU
kernels) and the TPU backend probe.
"""

from __future__ import annotations

import argparse
import logging
import resource
import sys
import time

__all__ = ["main"]


def _add_common(p) -> None:
    p.add_argument("--impl", default="auto",
                   choices=["auto", "fused", "unfused"],
                   help="the F-engine path: fused (K1; auto is the same) "
                        "or unfused (K6, then PyTorch ops)")
    p.add_argument("--scale", type=int, default=None,
                   help="reduce n_chans for quick checks")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--mesh", type=int, default=0,
                   help="run the sharded step over an N-shard mesh")
    p.add_argument("--time-shards", type=int, default=1,
                   help="sequence-parallel: shard each chunk N ways over "
                        "the mesh's time axis")
    p.add_argument("--beam-parallel", action="store_true",
                   help="shard the beams over the mesh's fx axis")
    _add_distributed(p)


def _add_distributed(p) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="several processes: join the torch.distributed "
                        "ranks of the launcher's environment and run over "
                        "the global mesh")


def _placement(args) -> tuple:
    """``(device, mesh)`` of the command, one of them None: the CPU with
    ``--cpu``, else the current card; a mesh with ``--mesh`` or
    ``--time-shards``; with ``--distributed`` the global mesh of
    ``--mesh`` shards over the ranks (:func:`main` joined them), each
    rank's shards spread over its cards
    (:func:`~dc_sand_tpu_torch.parallel.distributed.local_cards`)."""
    import torch
    from dc_sand_tpu_torch.ops._dispatch import default_device
    from dc_sand_tpu_torch.parallel import build_global_mesh, build_mesh
    n = args.mesh or (args.time_shards if args.time_shards > 1 else 0)
    if args.distributed:
        from dc_sand_tpu_torch.parallel.distributed import (local_cards,
                                                            process_count)
        world = process_count()
        if n % world:
            raise ValueError(f"--mesh {n} does not divide over {world} ranks")
        if args.cpu:
            devices = ["cpu"] * (n // world)
        else:
            default_device(None)              # raises without a card
            devices = _spread(n // world, local_cards())
        return None, build_global_mesh(devices, args.time_shards,
                                       time_local=True)
    if args.cpu:
        devices = ["cpu"] * n
    else:
        default_device(None)                  # raises without a card
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(n)]
    if n:
        return None, build_mesh(devices, time_shards=args.time_shards)
    return ("cpu" if args.cpu else None), None


def _spread(n: int, cards) -> list:
    """A rank's ``n`` shards over its ``cards``: shard k on card k mod
    their count."""
    return [cards[k % len(cards)] for k in range(n)]


def _where(device, mesh) -> str:
    """What a result ran on: the card's name and power limit, or the
    CPU."""
    dev = mesh.flat_devices[0] if mesh is not None else device
    if dev == "cpu" or getattr(dev, "type", None) == "cpu":
        return "cpu"
    from dc_sand_tpu_torch.bench.harness import card
    return card()


def cmd_verify(args) -> int:
    from dc_sand_tpu_torch.verify import SNR_BOUND, verify_config
    device, mesh = _placement(args)
    kw = {}
    if args.production_cadence:
        # the config's own cadence (fx64: 2048-spectra chunks, 8192 a
        # dump); golden graded on all pairs among 12 random antennas,
        # whose float64 chain is evaluated one antenna at a time
        kw = dict(spectra_per_chunk=None, n_spectra_per_acc=None,
                  golden_ants=12)
    t = time.perf_counter()
    snrs, counters = verify_config(
        args.config, device=device, mesh=mesh, scale=args.scale,
        time_shards=args.time_shards, beam_parallel=args.beam_parallel,
        fused=args.impl != "unfused", **kw)
    wall = time.perf_counter() - t
    ok = all(v > SNR_BOUND for v in snrs.values())
    for stage, v in snrs.items():
        mark = "PASS" if v > SNR_BOUND else "FAIL"
        print(f"{args.config}:{stage}: {v:.1f} dB [{mark}]")
    if counters:
        print(f"  ({counters})")
    print(f"{args.config}: {'PASS' if ok else 'FAIL'} "
          f"(bound {SNR_BOUND} dB)")
    # ru_maxrss is in KiB on Linux
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    print(f"  ({wall:.1f} s, peak host memory {rss_gb:.2f} GB, on "
          f"{_where(device, mesh)})")
    if args.record:
        from dc_sand_tpu_torch.bench.harness import BenchResult
        vname = args.config + ("_production" if args.production_cadence
                               else "")
        extra = dict(snrs)
        extra.update(impl="unfused" if args.impl == "unfused" else "fused",
                     time_shards=args.time_shards)
        if args.scale:
            extra["n_chans"] = args.scale
        path = BenchResult(
            name=f"verify_{vname}", metric="min stage SNR", unit="dB",
            value=min(snrs.values()), wall_s=wall, extra=extra,
        ).finish(mesh.flat_devices[0] if mesh is not None
                 else device).save(args.record)
        print(f"recorded {path}")
    return 0 if ok else 1


def cmd_run(args) -> int:
    import numpy as np
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import get_config, scaled_for_test
    from dc_sand_tpu_torch.parallel import local_antenna_range
    from dc_sand_tpu_torch.runtime import FXRunner, save_state
    from dc_sand_tpu_torch.windows import pfb_window

    cfg = get_config(args.config)
    if args.scale:
        cfg = scaled_for_test(cfg, n_chans=args.scale)
    if args.time_shards > 1:
        cfg = cfg.replace(time_shards=args.time_shards)
    if args.beam_parallel:
        cfg = cfg.replace(beam_parallel=True)
    device, mesh = _placement(args)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    rng = np.random.default_rng(0)
    weights = (rng.normal(size=(cfg.n_beams, cfg.n_ants, cfg.n_chans, 2))
               .astype(np.float32) if cfg.n_beams else None)
    runner = FXRunner(cfg, window, weights=weights, device=device,
                      mesh=mesh, fused=args.impl != "unfused")
    shape = (cfg.n_ants, cfg.n_pols, cfg.chunk_samples)
    # each rank of a multi-process mesh feeds its own antennas
    a0, a1 = (local_antenna_range(cfg.n_ants)
              if mesh is not None and mesh.multiprocess else (0, cfg.n_ants))

    def source(i):
        # quantize_adc(gaussian_noise(shape, 20, seed=i)), bit for bit
        return golden.gaussian_noise_int8(shape, 20.0, i)[a0:a1]

    run_fn = runner.run_batched if args.batched else runner.run
    dumps, counters = run_fn(source, args.chunks,
                             drop_chunks=args.drop or ())
    print(f"config={cfg.name} hash={cfg.config_hash()} mode={runner.mode}")
    print(f"chunks={counters.chunks_in} dropped={counters.chunks_dropped} "
          f"samples_in={counters.samples_in} "
          f"spectra={counters.spectra_out} dumps={counters.dumps}")
    for i, d in enumerate(dumps):
        print(f"dump {i}: {d.n_spectra}/{d.n_spectra_nominal} spectra, "
              f"|V| mean {abs(d.vis.astype(float)).mean():.1f}")
    if args.checkpoint:
        saved = save_state(runner, args.checkpoint)
        print(f"state saved to {saved}")
    return 0


def cmd_bench(args, rest: list) -> int:
    from dc_sand_tpu_torch.bench.__main__ import main as bench_main
    argv = ([args.target] if args.target else []) + rest
    if args.cpu:
        argv += ["--device", "cpu"]
    if args.distributed:
        argv += ["--distributed"]
    if args.profile:
        argv += ["--profile", args.profile]
    if args.spectra:
        argv += ["--spectra", str(args.spectra)]
    return bench_main(argv)


def cmd_regress(args) -> int:
    from dc_sand_tpu_torch.bench.regress import main as regress_main
    return regress_main(args.dir, check_verify=args.check_verify)


def cmd_info(args) -> int:
    import torch
    from dc_sand_tpu_torch.config import CONFIG_NAMES, get_config
    if torch.cuda.is_available():
        from dc_sand_tpu_torch.bench.harness import card
        print(f"card: {card()}; devices: {torch.cuda.device_count()}")
    else:
        print("card: none (no CUDA device: run the commands with --cpu)")
    for n in CONFIG_NAMES:
        c = get_config(n)
        print(f"  {n}: ants={c.n_ants} pols={c.n_pols} chans={c.n_chans} "
              f"taps={c.n_taps} xengine={c.run_xengine} beams={c.n_beams} "
              f"hash={c.config_hash()}")
    return 0


def main(argv=None) -> int:
    from dc_sand_tpu_torch.bench.__main__ import TARGETS
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(prog="python -m dc_sand_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("verify", help="run a config vs the golden chain")
    pv.add_argument("config")
    pv.add_argument("--record", metavar="DIR",
                    help="write an SNR regression record into DIR")
    pv.add_argument("--production-cadence", action="store_true",
                    help="run the config's real chunk/integration "
                         "cadence (golden compared on a baseline subset)")
    _add_common(pv)
    pv.set_defaults(fn=cmd_verify)

    pr = sub.add_parser("run", help="stream a config through the runner")
    pr.add_argument("config")
    pr.add_argument("--chunks", type=int, default=8)
    pr.add_argument("--drop", type=int, nargs="*",
                    help="fault-inject: drop these chunk indices")
    pr.add_argument("--checkpoint", help="save the state (npz) at the end")
    pr.add_argument("--batched", action="store_true",
                    help="offline replay: one dump window a dispatch, a "
                         "CUDA graph on one card (fx mode, dump-aligned "
                         "--chunks)")
    _add_common(pr)
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="benchmark on the card; other "
                        "arguments go to python -m dc_sand_tpu_torch.bench")
    pb.add_argument("target", nargs="?", choices=TARGETS)
    pb.add_argument("--cpu", action="store_true",
                    help="run on the CPU (--device cpu)")
    pb.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the bench "
                         "into DIR")
    pb.add_argument("--spectra", type=int, default=None,
                    help="spectra per chunk for the step benches (fx, "
                         "beam-step)")
    _add_distributed(pb)
    pb.set_defaults(fn=cmd_bench)

    pg = sub.add_parser("regress",
                        help="compare the newest bench records with the "
                             "ones before them")
    pg.add_argument("dir", help="the directory of records")
    pg.add_argument("--check-verify", action="store_true",
                    help="also fail on a missing or stale verify series")
    pg.set_defaults(fn=cmd_regress)

    pi = sub.add_parser("info", help="the card and the configs")
    pi.set_defaults(fn=cmd_info)

    args, rest = ap.parse_known_args(argv)
    if args.cmd == "bench":
        return cmd_bench(args, rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if not getattr(args, "distributed", False):
        return args.fn(args)
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    info = init_distributed()
    print(f"distributed: {info}", flush=True)
    if not args.mesh:
        args.mesh = info["process_count"] * max(args.time_shards, 1)
    rc = args.fn(args)
    ipc.close_all()
    return rc


if __name__ == "__main__":
    sys.exit(main())
