"""Multi-shard dry run: one step of every sharded mode at tiny shapes.

PyTorch counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``.  On
a mesh of ``n`` shards (:func:`~dc_sand_tpu_torch.parallel.build_mesh`;
the default puts shard i on ``cuda:(i mod the card count)``, all on
``cuda:0`` with one card, and raises without a card; the tests pass
``["cpu"] * n``) it runs
one chunk through :class:`~dc_sand_tpu_torch.runtime.FXRunner` in each
mode, from beam64 cut to ``16 n`` channels, ``2 n`` antennas and 8-spectra
chunks, with a delay model of ``max_delay`` 8:

* ``fx``: antenna-sharded F-engines, the corner-turn (K7b), the
  channel-sharded CMAC; one dump;
* ``beam``: partial beams per shard summed over fx (``psum``);
* ``beam_parallel``: ``n`` beams reduce-scattered over fx
  (``psum_scatter``);
* ``sp_fx``: the fx step with each chunk cut over a time axis of 2 behind
  the overlap-save halo (K7a) on a ``(2, n/2)`` mesh, at 32-spectra
  chunks; with ``n >= 4`` also ``sp_beam_parallel`` on that mesh;
* ``time_fengine``: the F-engine with the sample stream sharded ``n``
  ways over time (:func:`~dc_sand_tpu_torch.models.fx.
  make_time_sharded_fengine`);
* ``fused_fx``: fx at 512 channels and 16 spectra.

The ``fx``, ``beam`` and ``beam_parallel`` legs run the device coarse mode
(``coarse_on_host=False``: each shard gathers its antennas from its
lead-in history, :data:`DEVICE_COARSE`), as the JAX dry run compiles its
device gather under ``shard_map``; the others shift on the host feed.

Every leg but ``time_fengine`` (the FIR kernel K6, then ``torch.fft``)
runs the fused F-engine K1; ``fused_fx`` is the JAX dry run's leg through
its fused Pallas kernel, at that leg's shapes.  The JAX dry run's two legs
of native-layout kernels under ``shard_map`` (its CMAC and beamformer on
the k2-major planes) exercise Mosaic's layouts, which the port does not
keep: they are left out.

:func:`dryrun_reference` runs every mode's configuration on one device
from the same inputs (``time_shards`` 1, beams replicated): the fx dumps
and the incoherent beams are bitwise equal to the mesh's, the beams and
the time-sharded spectra equal within float32 summation order (on the CPU
the spectra are bitwise too).

    python -m dc_sand_tpu_torch.dryrun [N] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from dc_sand_tpu_torch.config import ChainConfig, get_config
from dc_sand_tpu_torch.models.fx import make_time_sharded_fengine
from dc_sand_tpu_torch.ops._dispatch import default_device
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["dryrun_multichip", "dryrun_reference", "dryrun_modes",
           "ModeResult", "MAX_DELAY", "DEVICE_COARSE"]

MAX_DELAY = 8
SEED = 0
DEVICE_COARSE = ("fx", "beam", "beam_parallel")   # coarse_on_host=False


class ModeResult(NamedTuple):
    """One mode's outputs as numpy arrays (``vis`` of the fx dump,
    ``beams`` and ``incoherent``, or ``spectra``) and its wall ms, the
    first call's build and load of the kernels included."""
    outputs: dict
    ms: float


def dryrun_modes(n_devices: int) -> dict:
    """``name -> (cfg, time_shards of its mesh)`` of every mode the dry
    run takes on ``n_devices`` shards (``time_fengine`` has no config:
    ``(None, n_devices)``)."""
    n = n_devices
    cfg = get_config("beam64").replace(n_chans=16 * n, spectra_per_chunk=8,
                                       n_beams=2, n_ants=2 * n)
    fx = cfg.replace(n_beams=0, run_xengine=True, n_spectra_per_acc=8)
    sp_b = 2 * cfg.n_taps
    modes = {
        "fx": (fx, 1),
        "beam": (cfg, 1),
        "beam_parallel": (cfg.replace(n_beams=n, beam_parallel=True), 1),
    }
    if n % 2 == 0:
        modes["sp_fx"] = (fx.replace(time_shards=2, spectra_per_chunk=sp_b,
                                     n_spectra_per_acc=sp_b), 2)
    if n >= 4 and n % 2 == 0:
        modes["sp_beam_parallel"] = (cfg.replace(
            n_beams=n // 2, beam_parallel=True, time_shards=2,
            spectra_per_chunk=sp_b), 2)
    modes["time_fengine"] = (None, n)
    modes["fused_fx"] = (fx.replace(n_chans=512, spectra_per_chunk=16,
                                    n_spectra_per_acc=16), 1)
    return modes


def _inputs(name: str, cfg: ChainConfig, n_devices: int) -> dict:
    """The mode's seeded chunk, delay model and weights (numpy)."""
    rng = np.random.default_rng([SEED, n_devices,
                                 list(dryrun_modes(n_devices)).index(name)])
    if cfg is None:     # time_fengine: 2 antennas, 1 pol, 16 taps' frames
        c = get_config("beam64")
        m = 2 * 16 * n_devices
        return {"x": rng.integers(-100, 100, (2, 1, n_devices * c.n_taps * m),
                                  dtype=np.int8), "m": m, "taps": c.n_taps,
                "window": pfb_window(c.n_taps, m, c.window)}
    a, p = cfg.n_ants, cfg.n_pols
    dm = DelayModel.zeros(a, p, max_delay=MAX_DELAY)
    dm.d0 = rng.uniform(0, MAX_DELAY, (a, p))
    dm.p0 = rng.uniform(-np.pi, np.pi, (a, p))
    return {
        "chunk": rng.integers(-100, 100, (a, p, cfg.chunk_samples),
                              dtype=np.int8),
        "delays": dm,
        "weights": (rng.normal(size=(cfg.n_beams, a, cfg.n_chans, 2))
                    .astype(np.float32) if cfg.n_beams else None),
        "window": pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
    }


def _sync(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(name: str, cfg, inp: dict, mesh) -> ModeResult:
    """One chunk of mode ``name``'s ``cfg`` through the runner over
    ``mesh``."""
    dev = mesh.flat_devices[0]
    _sync(dev)
    t0 = time.perf_counter()
    if cfg is None:
        fe = make_time_sharded_fengine(mesh, inp["window"], inp["taps"],
                                       inp["m"] // 2)
        out = {"spectra": fe(torch.from_numpy(inp["x"]).to(dev))}
    else:
        runner = FXRunner(cfg, inp["window"], delay_model=inp["delays"],
                          weights=inp["weights"], mesh=mesh,
                          coarse_on_host=name not in DEVICE_COARSE)
        got = []
        dumps, _ = runner.run(lambda i: inp["chunk"], 1,
                              on_output=lambda i, o: got.append(o))
        out = {"vis": dumps[0].vis} if dumps else got[0]
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return ModeResult({k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else v for k, v in out.items()}, ms)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run one step of every sharded mode (:func:`dryrun_modes`) on a mesh
    of ``n_devices`` shards over ``devices`` (default: shard i on
    ``cuda:(i mod the card count)``, raising without a card; the CPU:
    ``["cpu"] * n_devices``).  Returns ``name -> ModeResult``."""
    if devices is None:
        default_device(None)                  # raises without a card
        devices = [f"cuda:{i % torch.cuda.device_count()}"
                   for i in range(n_devices)]
    devices = list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} shards")
    results = {}
    for name, (cfg, n_t) in dryrun_modes(n_devices).items():
        mesh = build_mesh(devices, time_shards=n_t)
        results[name] = _run(name, cfg, _inputs(name, cfg, n_devices), mesh)
    return results


def dryrun_reference(n_devices: int, device=None) -> dict:
    """Every mode of :func:`dryrun_multichip` on ``n_devices`` shards, run
    on one ``device`` (default: the current card, raising without one)
    from the same inputs (``time_shards`` 1, beams replicated).  Returns
    ``name -> ModeResult``."""
    results = {}
    mesh = build_mesh([default_device(device)])
    for name, (cfg, _) in dryrun_modes(n_devices).items():
        inp = _inputs(name, cfg, n_devices)
        if cfg is not None:
            cfg = cfg.replace(time_shards=1, beam_parallel=False)
        results[name] = _run(name, cfg, inp, mesh)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dc_sand_tpu_torch.dryrun",
        description="One step of every sharded mode at tiny shapes.")
    ap.add_argument("n", type=int, nargs="?", default=4,
                    help="shards of the mesh (default 4)")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU shards (the default is the card, every shard "
                         "on cuda:0)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device is present; pass --cpu", file=sys.stderr)
        return 1
    results = dryrun_multichip(args.n, ["cpu"] * args.n if args.cpu
                               else None)
    for name, r in results.items():
        shapes = ", ".join(f"{k} {tuple(v.shape)}"
                           for k, v in r.outputs.items())
        print(f"{name}: {r.ms:.3f} ms ({shapes})")
    print(f"dryrun_multichip({args.n}): {' + '.join(results)} ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
