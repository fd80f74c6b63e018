"""The device coarse-delay mode's state and ranks on the CPU: the lead-in
history through ``save_state``/``load_state`` and ``load_jax_checkpoint``
(single-process files of both packages, on one device and on a mesh; the
JAX multi-process per-rank files), the refusals of another ``max_delay``
and of the other coarse mode's file, and the runner across two
``torch.distributed`` ranks (gloo), the ``tests/_mp_fx_worker.py`` rung
``ckpt`` among them.

The ranks are subprocesses running this file's ``__main__`` branch:

    python tests/test_torch_coarse_runner.py STORE OUTDIR MODE...
    python tests/test_torch_coarse_runner.py jax RANK PORT OUTDIR
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_distributed import spawn  # noqa: E402

MAX_DELAY = 8
RANK_MODES = ("runner", "ckpt", "resume_jax")
# tests/test_torch_runner.py:25-29: the JAX and port F-engines may round a
# value within float32 noise of a .5 boundary apart; the visibilities are
# bitwise equal otherwise
VIS_SNR_VS_JAX = 60.0


def _cfg(**kw):
    from dc_sand_tpu_torch.config import ChainConfig
    base = dict(name="devc", n_ants=8, n_pols=2, n_chans=32, n_taps=4,
                spectra_per_chunk=8, n_spectra_per_acc=16, apply_delay=True,
                apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _worker_cfg():
    """The ``ckpt`` rung's configuration (``tests/_mp_fx_worker.py``)."""
    return _cfg(name="mpc", n_pols=1, n_chans=128, n_spectra_per_acc=16)


def _delays(cfg, cls, max_delay=MAX_DELAY):
    """A model whose coarse delay steps at chunk boundaries (1.5 samples a
    chunk) from the rung's ``arange % 8``, with its fringe rate."""
    dm = cls.zeros(cfg.n_ants, cfg.n_pols, max_delay=max_delay)
    dm.d0 = (np.arange(cfg.n_ants * cfg.n_pols, dtype=float).reshape(
        cfg.n_ants, cfg.n_pols) % max_delay) / 2
    dm.d1 = np.full((cfg.n_ants, cfg.n_pols), 1.5 / cfg.chunk_samples)
    dm.p1 = np.full((cfg.n_ants, cfg.n_pols), 1e-7)
    return dm


def _source(cfg, seed, rows=slice(None), n_chunks=4):
    from dc_sand_tpu_torch import golden
    x = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, n_chunks * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    return lambda i: x[rows, :, i * c:(i + 1) * c]


def _runner(cfg, dm, **kw):
    from dc_sand_tpu_torch.runtime import FXRunner
    from dc_sand_tpu_torch.windows import pfb_window
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                    delay_model=dm, coarse_on_host=False, **kw)


def _jax_runner(cfg, dm, **kw):
    from dc_sand_tpu.config import ChainConfig as JaxChainConfig
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    from dc_sand_tpu.windows import pfb_window
    return JaxRunner(JaxChainConfig(**dataclasses.asdict(cfg)),
                     pfb_window(cfg.n_taps, cfg.fft_size), delay_model=dm,
                     impl="jnp", coarse_on_host=False, **kw)


def _same(a, b) -> bool:
    return len(a) == len(b) > 0 and all(
        np.array_equal(x.vis, y.vis) and (x.n_spectra, x.first_chunk) ==
        (y.n_spectra, y.first_chunk) for x, y in zip(a, b))


def _close_to_jax(got, want) -> None:
    """The port's visibilities against JAX's, within the boundary flips of
    the two F-engines."""
    from dc_sand_tpu_torch.utils import np_ri2c, snr_db
    assert got.shape == want.shape
    assert snr_db(np_ri2c(want), np_ri2c(got)) >= VIS_SNR_VS_JAX


# ---- one process ------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_device_mode_checkpoint_resumes_bitwise(tmp_path, shards):
    """Save after 3 chunks (mid-window, the coarse delay stepping), resume
    in a fresh runner with a zero model: the dumps after equal the
    uninterrupted run's; the file holds the lead-in ``(A, P, max_delay +
    (taps-1)*M)``, an empty ``host_tail`` and ``delay_max``."""
    from dc_sand_tpu_torch.parallel import build_mesh
    from dc_sand_tpu_torch.runtime import DelayModel, load_state, save_state
    cfg = _cfg()
    src = _source(cfg, 11, n_chunks=6)
    kw = {"mesh": build_mesh(["cpu"] * shards)} if shards > 1 else {}
    want, _ = _runner(cfg, _delays(cfg, DelayModel), **kw).run(src, 6)
    first = _runner(cfg, _delays(cfg, DelayModel), **kw)
    first.run(src, 3)
    path = save_state(first, str(tmp_path / "state"))
    z = np.load(path)
    assert z["history"].shape == (8, 2, MAX_DELAY + 3 * cfg.fft_size)
    assert z["host_tail"].size == 0 and int(z["delay_max"]) == MAX_DELAY
    resumed = _runner(cfg, DelayModel.zeros(8, 2, MAX_DELAY), **kw)
    load_state(resumed, path)
    got, _ = resumed.run(src, 3)
    assert resumed.chunk_idx == 6 and _same(got, want[1:])


def test_checkpoint_refusals(tmp_path):
    """Another ``max_delay`` is refused, as the JAX loader refuses it; a
    runner with coarse on the host refuses a lead-in history (naming
    ``coarse_on_host=False``), and a device-mode runner the host form."""
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.windows import pfb_window
    cfg = _cfg()
    src = _source(cfg, 12, n_chunks=1)
    dev = _runner(cfg, _delays(cfg, DelayModel))
    dev.run(src, 1)
    dev_path = save_state(dev, str(tmp_path / "dev"))
    host = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                    delay_model=_delays(cfg, DelayModel), device="cpu")
    host.run(src, 1)
    host_path = save_state(host, str(tmp_path / "host"))
    with pytest.raises(ValueError, match="max_delay"):
        load_state(_runner(cfg, DelayModel.zeros(8, 2, 16)), dev_path)
    fresh_host = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                          delay_model=DelayModel.zeros(8, 2, MAX_DELAY),
                          device="cpu")
    with pytest.raises(ValueError, match="coarse_on_host=False"):
        load_state(fresh_host, dev_path)
    with pytest.raises(ValueError, match="coarse_on_host=True"):
        load_state(_runner(cfg, DelayModel.zeros(8, 2, MAX_DELAY)),
                   host_path)


@pytest.mark.parametrize("jax_devices", [1, 2])
def test_jax_device_mode_checkpoint_both_ways(tmp_path, jax_devices):
    """A JAX device-mode run (jnp arm; on one device or a 2-device mesh)
    saves after 2 chunks (a dump boundary): the port (one device, or a
    2-shard CPU mesh) loads it, holds the lead-in bitwise, and continues
    bitwise its own uninterrupted run (within the F-engines' boundary
    flips of JAX's); a port file of the same point resumes the JAX runner
    bitwise its own uninterrupted run."""
    import jax
    from dc_sand_tpu.parallel import build_mesh as jax_build_mesh
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import load_state as jax_load_state
    from dc_sand_tpu.runtime import save_state as jax_save_state
    from dc_sand_tpu_torch.parallel import build_mesh
    from dc_sand_tpu_torch.runtime import (DelayModel, load_jax_checkpoint,
                                           save_state)
    cfg = _cfg()
    src = _source(cfg, 13)
    jkw = ({"mesh": jax_build_mesh(devices=jax.devices()[:2])}
           if jax_devices > 1 else {})
    pkw = {"mesh": build_mesh(["cpu"] * 2)} if jax_devices > 1 else {}
    want, _ = _jax_runner(cfg, _delays(cfg, JaxDelayModel), **jkw).run(src, 4)
    straight, _ = _runner(cfg, _delays(cfg, DelayModel), **pkw).run(src, 4)
    first = _jax_runner(cfg, _delays(cfg, JaxDelayModel), **jkw)
    first.run(src, 2)
    jpath = jax_save_state(first, str(tmp_path / "jax"))
    port = _runner(cfg, DelayModel.zeros(8, 2, MAX_DELAY), **pkw)
    load_jax_checkpoint(port, jpath)
    lead = np.concatenate([h.numpy() for h in port.history])
    np.testing.assert_array_equal(lead, np.asarray(first.history))
    got, _ = port.run(src, 2)
    assert _same(got, straight[1:])
    _close_to_jax(got[0].vis, want[1].vis)
    mine = _runner(cfg, _delays(cfg, DelayModel), **pkw)
    mine.run(src, 2)
    ppath = save_state(mine, str(tmp_path / "port"))
    back = _jax_runner(cfg, _delays(cfg, JaxDelayModel), **jkw)
    jax_load_state(back, ppath)
    again, _ = back.run(src, 2)
    assert _same(again, want[1:])


# ---- the ranks --------------------------------------------------------------

def _rank(mode, check, outdir, rank):
    from dc_sand_tpu_torch.parallel import (build_global_mesh, build_mesh,
                                            local_antenna_range)
    from dc_sand_tpu_torch.runtime import (DelayModel, load_jax_checkpoint,
                                           load_state, save_state)
    mesh = build_global_mesh(["cpu"] * 2)
    a0, a1 = local_antenna_range(8)
    mine = slice(a0, a1)
    if mode == "runner":
        # each rank gathers its own antennas: bitwise the one-process run
        cfg = _cfg()
        got, _ = _runner(cfg, _delays(cfg, DelayModel), mesh=mesh).run(
            _source(cfg, 21, mine), 4, drop_chunks=(1,))
        want, _ = _runner(cfg, _delays(cfg, DelayModel),
                          mesh=build_mesh(["cpu"] * 4)).run(
            _source(cfg, 21), 4, drop_chunks=(1,))
        check("runner", _same(got, want))
        np.save(os.path.join(outdir, f"runner_{rank}.npy"),
                np.stack([d.vis for d in got]))
    elif mode == "ckpt":
        # the rung: save mid-stream, resume in a fresh runner, bitwise
        cfg = _worker_cfg()
        src = _source(cfg, 55, mine)
        straight, _ = _runner(cfg, _delays(cfg, DelayModel),
                              mesh=mesh).run(src, 4)
        first = _runner(cfg, _delays(cfg, DelayModel), mesh=mesh)
        dumps_a, _ = first.run(src, 2)
        written = save_state(first, os.path.join(outdir, "ckpt"))
        z = np.load(written)
        resumed = _runner(cfg, _delays(cfg, DelayModel), mesh=mesh)
        load_state(resumed, os.path.join(outdir, "ckpt"))
        dumps_b, _ = resumed.run(src, 2)
        check("ckpt", written.endswith(f"ckpt.proc{rank}of2.npz")
              and z["history_shard0"].shape == (
                  2, 1, MAX_DELAY + 3 * cfg.fft_size)
              and z["host_tail"].size == 0 and resumed.chunk_idx == 4
              and _same(dumps_a + dumps_b, straight))
        np.save(os.path.join(outdir, f"ckpt_{rank}.npy"),
                np.stack([d.vis for d in straight]))
    elif mode == "resume_jax":
        # the JAX ranks' device-mode files after 2 chunks
        cfg = _cfg(name="devj")
        r = _runner(cfg, DelayModel.zeros(8, 2, MAX_DELAY), mesh=mesh)
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
    rank = info["process_index"]

    def check(name, ok):
        if not ok:
            raise AssertionError(f"rank {rank}: {name} failed")
        print(f"PASS {name}", flush=True)

    for mode in modes:
        _rank(mode, check, outdir, rank)
    ipc.close_all()
    return 0


def jax_main(pid: int, port: int, outdir: str) -> int:
    """A JAX multi-process run in the device mode: 2 chunks, per-process
    files, and the uninterrupted run's second dump."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.parallel.distributed import (init_distributed,
                                                  local_antenna_range)
    from dc_sand_tpu.runtime import DelayModel, save_state
    init_distributed(coordinator=f"localhost:{port}", num_processes=2,
                     process_id=pid)
    cfg = _cfg(name="devj")
    src = _source(cfg, 57, slice(*local_antenna_range(cfg.n_ants)))
    straight, _ = _jax_runner(cfg, _delays(cfg, DelayModel),
                              mesh=build_mesh()).run(src, 4)
    first = _jax_runner(cfg, _delays(cfg, DelayModel), mesh=build_mesh())
    first.run(src, 2)
    written = save_state(first, os.path.join(outdir, "jax_state"))
    assert written.endswith(f"jax_state.proc{pid}of2.npz"), written
    if pid == 0:
        np.save(os.path.join(outdir, "jax_straight.npy"), straight[1].vis)
    print("PASS jax_writer", flush=True)
    return 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX writer's two processes, then the port's two ranks."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor
    from dc_sand_tpu_torch.parallel.launch import free_port
    tmp = tmp_path_factory.mktemp("coarse_ranks")
    port = free_port()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=2", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, "jax", str(pid),
                               str(port), str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(2)]

    def drain(p):
        try:
            return p.communicate(timeout=240)[0]
        finally:
            if p.poll() is None:
                p.kill()

    with ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(drain, procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "PASS jax_writer" in out, out
    return tmp, spawn(__file__, tmp, list(RANK_MODES))


@pytest.mark.parametrize("name", RANK_MODES)
def test_ranks_pass(ranks, name):
    """Each rank: the device mode bitwise the one-process run (stepping
    delays, a drop); the ``ckpt`` rung resumed bitwise from per-rank
    files holding the lead-in; the JAX ranks' device-mode files loaded."""
    for out in ranks[1]:
        assert f"PASS {name}\n" in out, out


def test_ranks_match_the_jax_device_mode(ranks):
    """The ranks' dumps (the same whole set on both) against the JAX
    device mode's, within the F-engines' boundary flips: the one-process
    JAX runner for the runner and the rung, and the JAX ranks'
    uninterrupted run for their resumed files."""
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    tmp = ranks[0]
    for name, cfg, seed, drops in (("runner", _cfg(), 21, (1,)),
                                   ("ckpt", _worker_cfg(), 55, ())):
        got = [np.load(tmp / f"{name}_{r}.npy") for r in range(2)]
        want, _ = _jax_runner(cfg, _delays(cfg, JaxDelayModel)).run(
            _source(cfg, seed), 4, drop_chunks=drops)
        np.testing.assert_array_equal(got[0], got[1])
        _close_to_jax(got[0], np.stack([d.vis for d in want]))
    want = np.load(tmp / "jax_straight.npy")
    for r in range(2):
        _close_to_jax(np.load(tmp / f"resumed_{r}.npy"), want)


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
