"""Per-rank checkpoints across ``torch.distributed`` ranks on the CPU (the
JAX rung ``ckpt`` of ``tests/test_distributed.py``), a JAX multi-process
checkpoint resumed by the port's ranks, the refusals of another process
count, and one run of four ranks.

The port's ranks are subprocesses running this file's ``__main__`` branch
(gloo over a ``file://`` store, 2 CPU shards a rank unless stated); the
JAX writer is two ``jax.distributed`` CPU processes of the same branch,
as ``tests/_mp_fx_worker.py`` runs them.

    python tests/test_torch_distributed_ckpt.py STORE OUTDIR MODE...
    python tests/test_torch_distributed_ckpt.py jax RANK PORT OUTDIR
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_distributed import spawn  # noqa: E402

N_CHANS, TAPS = 64, 4
# tests/test_torch_runner.py:25-29 (JAX against the port)
VIS_SNR_VS_JAX = 60.0
CKPT_MODES = {"ckpt": ("ckpt_resumed", "ckpt_sp_resumed", "ckpt_keys"),
              "refusals": ("refuse_process_count", "refuse_missing_file",
                           "refuse_layout")}
FOUR_MODES = ("four_runner", "four_verify_fx64", "four_verify_beam64")


def _cfg(**kw):
    from dc_sand_tpu_torch.config import ChainConfig
    base = dict(name="mpc", n_ants=8, n_pols=2, n_chans=N_CHANS,
                n_taps=TAPS, spectra_per_chunk=16, n_spectra_per_acc=32,
                apply_delay=True, apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _source(cfg, seed, rows):
    from dc_sand_tpu_torch import golden
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, 4 * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    return lambda i: stream[rows, :, i * c:(i + 1) * c]


def _delays(cfg, cls, max_delay=8):
    """A drifting model; with ``max_delay`` 0 no coarse delay (the JAX
    multi-process runner refuses its host coarse shift)."""
    dm = cls.zeros(cfg.n_ants, cfg.n_pols, max_delay=max_delay)
    if max_delay:
        dm.d0 = np.arange(cfg.n_ants * cfg.n_pols, dtype=float).reshape(
            cfg.n_ants, cfg.n_pols) % max_delay
        dm.d1 = np.full((cfg.n_ants, cfg.n_pols), 1e-3)
    dm.p1 = np.full((cfg.n_ants, cfg.n_pols), 1e-7)
    return dm


# ---- the port's ranks ------------------------------------------------------

def _runner(cfg, mesh, dm):
    from dc_sand_tpu_torch.runtime import FXRunner
    from dc_sand_tpu_torch.windows import pfb_window
    return FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size), delay_model=dm,
                    mesh=mesh)


def _resume_bitwise(cfg, mesh, rows, path):
    """Save after 2 chunks, resume in a fresh runner with a zero delay
    model: the dump after chunk 4 equals the uninterrupted run's."""
    from dc_sand_tpu_torch.runtime import DelayModel, load_state, save_state
    src = _source(cfg, 55, rows)
    want, _ = _runner(cfg, mesh, _delays(cfg, DelayModel)).run(src, 4)
    first = _runner(cfg, mesh, _delays(cfg, DelayModel))
    first.run(src, 2)
    written = save_state(first, path)
    resumed = _runner(cfg, mesh, DelayModel.zeros(cfg.n_ants, cfg.n_pols, 8))
    load_state(resumed, path)
    got, _ = resumed.run(src, 2)
    ok = (resumed.chunk_idx == 4 and len(got) == 1 and len(want) == 2
          and np.array_equal(got[0].vis, want[1].vis))
    return ok, written


def _rank(mode, check, outdir, rank, world):
    from dc_sand_tpu_torch.parallel import (build_global_mesh, build_mesh,
                                            local_antenna_range)
    from dc_sand_tpu_torch.runtime import DelayModel, load_state
    a0, a1 = local_antenna_range(8)
    mine = slice(a0, a1)
    mesh = build_global_mesh(["cpu"] * 2)
    path = os.path.join(outdir, "state")
    if mode == "ckpt":
        ok, written = _resume_bitwise(_cfg(), mesh, mine, path)
        check("ckpt_resumed", ok)
        sp = build_global_mesh(["cpu"] * 2, time_shards=2, time_local=True)
        ok_sp, _ = _resume_bitwise(_cfg(time_shards=2), sp, mine,
                                   os.path.join(outdir, "sp"))
        check("ckpt_sp_resumed", ok_sp)
        z = np.load(written)
        check("ckpt_keys", written.endswith(f"state.proc{rank}of2.npz")
              and list(z["process_shape"]) == [rank, 2]
              and {f"{n}_{k}{j}" for n in ("history", "vis_acc", "weights")
                   for k in ("shard", "idx") for j in (0, 1)} <= set(z.files)
              and z["history_idx0"][0].tolist() == [4 * rank, 4 * rank + 2])
    elif mode == "refusals":
        import pytest as pt
        cfg = _cfg()
        src = _source(cfg, 55, mine)
        r = _runner(cfg, mesh, _delays(cfg, DelayModel))
        r.run(src, 1)
        from dc_sand_tpu_torch.runtime import save_state
        written = save_state(r, path)
        z = dict(np.load(written))
        z["process_shape"] = np.array([rank, 3])
        bad = os.path.join(outdir, f"bad.proc{rank}of2.npz")
        np.savez(bad, **z)
        fresh = _runner(cfg, mesh, _delays(cfg, DelayModel))
        with pt.raises(ValueError, match="saved with 3 processes, restoring "
                                         "under 2"):
            load_state(fresh, os.path.join(outdir, "bad"))
        check("refuse_process_count", True)
        with pt.raises(ValueError, match="not found .* same process count"):
            load_state(fresh, os.path.join(outdir, "nothing"))
        check("refuse_missing_file", True)
        # the other rank's shards under this rank's name
        import torch.distributed as dist
        dist.barrier()
        np.savez(os.path.join(outdir, f"swap.proc{rank}of2.npz"),
                 **dict(np.load(os.path.join(
                     outdir, f"state.proc{1 - rank}of2.npz"))))
        with pt.raises(ValueError, match="shard layout mismatch"):
            load_state(fresh, os.path.join(outdir, "swap"))
        check("refuse_layout", True)
    elif mode == "four":
        # four ranks, two CPU shards each: an 8-shard fx mesh
        from dc_sand_tpu_torch.verify import SNR_BOUND, verify_config
        mesh = build_global_mesh(["cpu"] * 2)
        assert mesh.size == 8 and world == 4
        cfg = _cfg()
        src = _source(cfg, 56, mine)
        got, _ = _runner(cfg, mesh, _delays(cfg, DelayModel)).run(src, 4)
        want, _ = _runner(cfg, build_mesh(["cpu"] * 8),
                          _delays(cfg, DelayModel)).run(
            _source(cfg, 56, slice(None)), 4)
        check("four_runner", len(got) == 2 and all(
            np.array_equal(a.vis, b.vis) for a, b in zip(got, want)))
        for name, scale in (("fx64", 64), ("beam64", 32)):
            snrs, _ = verify_config(name, mesh=mesh, scale=scale)
            print(f"verify {name}: {snrs}", flush=True)
            check(f"four_verify_{name}",
                  all(v > SNR_BOUND for v in snrs.values()))
    elif mode == "resume_jax":
        # the JAX ranks' files: 2 chunks of a JAX multi-process run
        from dc_sand_tpu_torch.runtime import load_jax_checkpoint
        cfg = _cfg(name="mpj")
        r = _runner(cfg, mesh, DelayModel.zeros(8, 2))
        load_jax_checkpoint(r, os.path.join(outdir, "jax_state"))
        dumps, _ = r.run(_source(cfg, 57, mine), 2)
        np.save(os.path.join(outdir, f"resumed_{rank}.npy"), dumps[0].vis)
        check("resume_jax", r.chunk_idx == 4 and len(dumps) == 1)


def rank_main(argv) -> int:
    sys.path.insert(0, ROOT)
    if argv[0] == "jax":
        return jax_main(int(argv[1]), int(argv[2]), argv[3])
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    store, outdir, modes = argv[0], argv[1], argv[2:]
    info = init_distributed(init_method=f"file://{store}")
    rank, world = info["process_index"], info["process_count"]

    def check(name, ok):
        if not ok:
            raise AssertionError(f"rank {rank}: {name} failed")
        print(f"PASS {name}", flush=True)

    for mode in modes:
        _rank(mode, check, outdir, rank, world)
    ipc.close_all()
    return 0


# ---- the JAX writer: two jax.distributed CPU processes ---------------------

def jax_main(pid: int, port: int, outdir: str) -> int:
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dc_sand_tpu.config import ChainConfig
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.parallel.distributed import (init_distributed,
                                                  local_antenna_range)
    from dc_sand_tpu.runtime import DelayModel, FXRunner, save_state
    from dc_sand_tpu.windows import pfb_window
    init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                     process_id=pid)
    cfg = ChainConfig(**dataclasses.asdict(_cfg(name="mpj")))
    a0, a1 = local_antenna_range(cfg.n_ants)
    src = _source(cfg, 57, slice(a0, a1))
    w = pfb_window(cfg.n_taps, cfg.fft_size)
    kw = dict(mesh=build_mesh(), impl="jnp")
    straight, _ = FXRunner(cfg, w, delay_model=_delays(cfg, DelayModel, 0),
                           **kw).run(src, 4)
    first = FXRunner(cfg, w, delay_model=_delays(cfg, DelayModel, 0), **kw)
    first.run(src, 2)
    written = save_state(first, os.path.join(outdir, "jax_state"))
    assert written.endswith(f"jax_state.proc{pid}of2.npz"), written
    if pid == 0:
        np.save(os.path.join(outdir, "jax_straight.npy"), straight[1].vis)
    print("PASS jax_writer", flush=True)
    return 0


# ---- the tests --------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    return spawn(__file__, tmp, list(CKPT_MODES))


@pytest.mark.parametrize("name", [n for ns in CKPT_MODES.values()
                                  for n in ns])
def test_rank_passes(ranks, name):
    """Per-rank files resume bitwise (a drifting delay model and the
    per-rank coarse tail carried across), with JAX's keys; another
    process count, a missing file, another layout refused."""
    for out in ranks:
        assert f"PASS {name}\n" in out, out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_four")
    return spawn(__file__, tmp, ["four"], world=4)


@pytest.mark.parametrize("name", FOUR_MODES)
def test_four_ranks(four, name):
    """Four ranks of two shards: the runner bitwise the one-process 8-shard
    run, verify fx64 and beam64 (channels cut) > 50 dB on every rank."""
    for out in four:
        assert f"PASS {name}\n" in out, out


def test_jax_multiprocess_checkpoint_resumes_the_port(tmp_path):
    """Two ``jax.distributed`` CPU processes (2 devices each) run 2 chunks
    and save per-process files; two port ranks load them with
    ``load_jax_checkpoint`` and run 2 more: the dump matches the JAX
    processes' uninterrupted run."""
    from dc_sand_tpu_torch.parallel.launch import free_port
    from dc_sand_tpu_torch.utils import snr_db
    port = free_port()
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "JAX_PLATFORMS": "cpu"}
    import subprocess
    jax_procs = [subprocess.Popen(
        [sys.executable, __file__, "jax", str(pid), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, **env)) for pid in range(2)]
    from concurrent.futures import ThreadPoolExecutor

    def drain(p):
        try:
            return p.communicate(timeout=240)[0]
        finally:
            if p.poll() is None:
                p.kill()

    with ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(drain, jax_procs))
    for p, out in zip(jax_procs, outs):
        assert p.returncode == 0 and "PASS jax_writer" in out, out
    for out in spawn(__file__, tmp_path, ["resume_jax"]):
        assert "PASS resume_jax\n" in out, out
    want = np.load(tmp_path / "jax_straight.npy")
    for rank in range(2):
        got = np.load(tmp_path / f"resumed_{rank}.npy")
        assert snr_db(want[..., 0] + 1j * want[..., 1],
                      got[..., 0] + 1j * got[..., 1]) > VIS_SNR_VS_JAX


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
