"""Weak-scaling sweep of the sharded fx step.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.scaling`: the sharded FX
streaming step over meshes of 1, 2, 4, ... of the devices the caller
gives, with the per-device work held constant.  The total antenna count
is fixed, so every device channelizes ``n_ants / d`` antennas at
``chans_per_dev * d`` channels and correlates a ``chans_per_dev`` channel
block of the full ap^2 baseline matrix; only the corner-turn grows with
``d``, which is the parallel overhead that ``efficiency_vs_1dev = T(1) d
/ T(d)`` measures.

The caller names the devices (the bench entry passes the distinct cards
present; the tests ``["cpu"] * d``); there is no fallback to a CPU pool.
A sweep whose efficiency exceeds 1.2 is implausible by construction (the
one-device time was polluted): the base is measured once more, and if
the implausibility survives, the sweep raises rather than records.
"""

from __future__ import annotations

import numpy as np
import torch

from dc_sand_tpu_torch.bench.harness import BenchResult, time_cuda
from dc_sand_tpu_torch.config import get_config
from dc_sand_tpu_torch.models.pipeline import (chunk_shape, history_shape,
                                               make_step, shard_inputs,
                                               zero_vis_acc)
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["bench_scaling", "IMPLAUSIBLE_EFFICIENCY"]

IMPLAUSIBLE_EFFICIENCY = 1.2


def _cfg(n_ants: int, n_chans: int, spectra: int):
    return get_config("fx64").replace(
        n_ants=n_ants, n_chans=n_chans, spectra_per_chunk=spectra,
        n_spectra_per_acc=spectra)


def _step_wall(cfg, mesh, iters: int) -> float:
    """Seconds per call of the sharded step on seeded inputs, carries
    updated in place; timed on the mesh's first device after the first
    device's stream has waited for every other card's."""
    step = make_step(cfg, pfb_window(cfg.n_taps, cfg.fft_size), mesh=mesh)
    devices = mesh.flat_devices
    rng = np.random.default_rng(0)
    a, p, k, b = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.spectra_per_chunk
    chunk = torch.from_numpy(rng.integers(-100, 100, chunk_shape(cfg),
                                          dtype=np.int8))
    zeros = torch.zeros((a * p, b))
    chunks, fracs, phases = shard_inputs(mesh, chunk, zeros, zeros)
    gains = torch.tensor([[0.05, 0.0]]).expand(k, 2).contiguous()
    args = ([torch.zeros(history_shape(cfg, mesh), dtype=torch.int8,
                         device=dev) for dev in devices],
            [zero_vis_acc(cfg, dev, mesh) for dev in devices],
            chunks, fracs, phases, [gains.to(dev) for dev in devices],
            [torch.zeros((1, a, k, 2), device=dev) for dev in devices],
            False)
    first = devices[0]
    others = sorted(set(devices) - {first}, key=str)

    def call():
        step(*args)
        for dev in others:
            torch.cuda.current_stream(first).wait_stream(
                torch.cuda.current_stream(dev))

    return time_cuda(call, warmup=2, iters=iters, device=first)


def bench_scaling(devices, n_ants: int = 16, chans_per_dev: int = 64,
                  spectra: int = 16, iters: int = 16) -> list:
    """Weak-scaling sweep over the first 1, 2, 4, ... of ``devices``.

    ``n_ants`` is the fixed total antenna count (the sweep stops at the
    first mesh size that does not divide it); channels grow as
    ``chans_per_dev * d``."""
    sizes = []
    d = 1
    while d <= len(devices) and n_ants % d == 0:
        sizes.append(d)
        d *= 2
    meshes = {d: build_mesh(devices[:d]) for d in sizes}
    cfgs = {d: _cfg(n_ants, chans_per_dev * d, spectra) for d in sizes}
    walls = {d: _step_wall(cfgs[d], meshes[d], iters) for d in sizes}
    samples = {d: cfg.n_ants * cfg.n_pols * cfg.chunk_samples
               for d, cfg in cfgs.items()}

    def efficiency(d):
        return samples[d] / walls[d] / d / (samples[1] / walls[1])

    if any(efficiency(d) > IMPLAUSIBLE_EFFICIENCY for d in sizes):
        # weak scaling cannot beat 1: measure the base once more and, if
        # the implausibility survives, refuse to record the sweep
        walls[1] = _step_wall(cfgs[1], meshes[1], iters)
        worst = max(sizes, key=efficiency)
        if efficiency(worst) > IMPLAUSIBLE_EFFICIENCY:
            raise RuntimeError(
                f"scaling sweep implausible: the {worst}-device efficiency "
                f"{efficiency(worst):.3g} exceeds {IMPLAUSIBLE_EFFICIENCY} "
                "against the re-measured one-device rate; refusing to "
                "record")
    return [BenchResult(
        name=f"scaling_fx_{d}dev",
        metric="weak-scaling samples/s", value=samples[d] / walls[d],
        unit="samp/s", wall_s=walls[d],
        extra={"devices": d, "cards": len(set(meshes[d].flat_devices)),
               "n_ants": n_ants, "n_chans": cfgs[d].n_chans,
               "per_device_rate": samples[d] / walls[d] / d,
               "efficiency_vs_1dev": efficiency(d)},
    ).finish(meshes[d].flat_devices[0]) for d in sizes]
