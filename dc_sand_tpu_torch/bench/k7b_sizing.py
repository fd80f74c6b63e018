"""K7b's tile shape for NVLink stores, timed on the cards.

``python -m dc_sand_tpu_torch.bench.k7b_sizing [--shapes 256x4 256x8 ...]
[--rounds 4] [--out DIR]`` on a host of 2 or 4 cards builds
``csrc/remote_dma.cu`` once for each tile shape, threads x unroll
(``-DDCS_K7_THREADS``, ``-DDCS_K7_UNROLL``; the port's is 256x4), into
``build/torch_kernels/`` beside the port's own build, one ``nvcc`` a
shape, all started together, then runs one rank a card
(:func:`~dc_sand_tpu_torch.parallel.launch.run_ranks`),
each with one shard of the fx64 corner-turn (int8 ``(4096, 2, 128 / n,
2048)``, 537 MB on four cards) and K7b in its pitched mode across the
cards, through the port's wrapper with the rank's ``dcs_all_to_all``
pointed at each shape's build in turn.  Each shape's output is held
bitwise to the port's build's.  In every round each shape is timed, in
alternating order, with CUDA events around its launches alone and around
the call on the device with its flag rounds
(:func:`~dc_sand_tpu_torch.bench.collectives.kernel_alone_ms`); the
median of the rounds is kept.  Prints one JSON line: each shape's ms a
rank both ways, the NVLink bound of the bytes a card sends to the others,
the card's name and power limit.  Without 2 cards it exits 1 and prints
no JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

from dc_sand_tpu_torch import _build

__all__ = ["variant_path", "build_variants", "variant_all_to_all", "main"]

SHAPES = ("256x4", "128x8", "256x8", "512x4", "512x8", "1024x4")
CHANNELS, STREAMS, SPECTRA = 4096, 128, 2048     # the fx64 chunk


def _parse(shape: str) -> tuple:
    threads, unroll = (int(x) for x in shape.split("x"))
    return threads, unroll


def variant_path(shape: str):
    """The library of ``csrc/remote_dma.cu`` built with the tile shape
    ``shape`` (``"THREADSxUNROLL"``)."""
    threads, unroll = _parse(shape)
    src = _build._CSRC / "remote_dma.cu"
    flags = (*_build.NVCC_FLAGS, f"-DDCS_K7_THREADS={threads}",
             f"-DDCS_K7_UNROLL={unroll}")
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    name = f"libremote_dma_{shape}_{digest.hexdigest()[:16]}.so"
    return _build.build_dir() / name, flags, src


def build_variants(shapes) -> None:
    """Build the missing shapes' libraries, one ``nvcc`` each, at once."""
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    jobs = []
    for shape in shapes:
        so, flags, src = variant_path(shape)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            jobs.append((so, tmp, subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for so, tmp, proc in jobs:
        out, err = proc.communicate()
        so.with_suffix(".log").write_text(out + err)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{err}")
        os.replace(tmp, so)


def variant_all_to_all(shape: str):
    """``dcs_all_to_all`` of ``shape``'s library, bound as the port's."""
    fn = ctypes.CDLL(str(variant_path(shape)[0])).dcs_all_to_all
    fn.argtypes = _build._SIGNATURES["remote_dma"]["dcs_all_to_all"]
    fn.restype = ctypes.c_int
    return fn


def _rank(shapes, rounds: int, calls: int) -> None:
    """One rank: its shard, every shape bitwise the port's build and
    timed in turns; prints ``RESULT {json}``."""
    import torch.distributed as dist
    from dc_sand_tpu_torch.bench.collectives import kernel_alone_ms
    from dc_sand_tpu_torch.parallel import (FX_AXIS, SharedBuffers,
                                            all_to_all, build_global_mesh,
                                            ipc)
    from dc_sand_tpu_torch.parallel.distributed import (init_distributed,
                                                        local_cards)
    init_distributed()
    cards = local_cards()
    torch.cuda.set_device(cards[0])
    mesh = build_global_mesh(cards)
    n = mesh.size
    shape = (CHANNELS, 2, STREAMS // n, SPECTRA)
    rows = 2 * CHANNELS // n
    xs = []
    for d, dev in zip(mesh.local_shards, mesh.local_devices):
        gen = torch.Generator(device=dev)
        gen.manual_seed(32 + d)
        xs.append(torch.randint(-127, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8))
    bufs = SharedBuffers(mesh, shape, torch.int8)
    lib = _build.library()
    port = lib.dcs_all_to_all
    fns = {s: variant_all_to_all(s) for s in shapes}

    def call():
        return all_to_all(xs, mesh, FX_AXIS, rows=rows, out=bufs,
                          impl="cuda")

    want = [g.clone() for g in call()]
    same = {}
    try:
        for s in shapes:
            lib.dcs_all_to_all = fns[s]
            got = call()
            torch.cuda.synchronize()
            same[s] = all(torch.equal(g, w) for g, w in zip(got, want))
        del want, got
        times = {s: {"kernel": [], "span": []} for s in shapes}
        for r in range(rounds):
            for s in (shapes if r % 2 == 0 else shapes[::-1]):
                lib.dcs_all_to_all = fns[s]
                times[s]["kernel"].append(kernel_alone_ms(call, calls, 1))
                times[s]["span"].append(kernel_alone_ms(call, calls, 1,
                                                        span=True))
    finally:
        lib.dcs_all_to_all = port
    if not all(same.values()):
        raise RuntimeError(f"rank {mesh.rank}: shapes not bitwise the "
                           f"port's build: {[s for s in same if not same[s]]}")
    print("RESULT " + json.dumps({
        "rank": mesh.rank, "shard_mb": xs[0].numel() / 1e6,
        "cross_mb": xs[0].numel() * (n - 1) / n / 1e6,
        "ms": {s: {k: statistics.median(v) for k, v in t.items()}
               for s, t in times.items()}}), flush=True)
    ipc.close_all()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        _rank(args.shapes, args.rounds, args.calls)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("k7b_sizing: needs 2 or more cards", file=sys.stderr)
        return 1
    from dc_sand_tpu_torch.bench.harness import NVLINK_BYTES_S, card
    from dc_sand_tpu_torch.parallel.launch import run_ranks
    _build.library()
    build_variants(args.shapes)
    world = torch.cuda.device_count()
    results = run_ranks([sys.executable, "-m",
                         "dc_sand_tpu_torch.bench.k7b_sizing", "--rank",
                         "--shapes", *args.shapes, "--rounds",
                         str(args.rounds), "--calls", str(args.calls)],
                        world, timeout=600)
    ranks = []
    for rank, res in enumerate(results):
        for line in res.output.splitlines():
            if line.startswith("RESULT "):
                ranks.append(json.loads(line[len("RESULT "):]))
            elif line.strip():
                print(f"rank {rank}| {line}", file=sys.stderr, flush=True)
    if any(res.returncode for res in results) or len(ranks) != world:
        print("k7b_sizing: a rank failed", file=sys.stderr)
        return 1
    ranks.sort(key=lambda r: r["rank"])
    cross = ranks[0]["cross_mb"] * 1e6
    record = {
        "name": "k7b_sizing", "cards": world, "card": card(),
        "shard_mb": ranks[0]["shard_mb"], "cross_mb": cross / 1e6,
        "link_bound_ms": cross / NVLINK_BYTES_S * 1e3,
        "rounds": args.rounds, "calls": args.calls,
        "shapes": {s: {"kernel_ms": [r["ms"][s]["kernel"] for r in ranks],
                       "span_ms": [r["ms"][s]["span"] for r in ranks]}
                   for s in args.shapes}}
    line = json.dumps(record)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "k7b_sizing.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
