"""The port's streaming runner across ``torch.distributed`` ranks on the
CPU: the JAX rungs ``runner``, ``sp_runner``, ``fengine``, ``beam``,
``beam_ep`` and ``verify`` of ``tests/test_distributed.py``, the JAX
refusals, the refusal of ranks on two hosts, and ``cli run --distributed``.

Two ranks (subprocesses running this file's ``__main__`` branch, gloo over
a ``file://`` store) of 2 CPU shards each feed their own antennas; every
rank holds its dumps and outputs bitwise to the port's one-process runner
over the same global mesh and prints ``PASS <check>``.  The fx dumps are
also held against the JAX runner here, at ``tests/test_torch_runner.py``'s
tolerance.

    python tests/test_torch_distributed_runner.py STORE OUTDIR MODE...
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_distributed import spawn  # noqa: E402

N_CHANS, TAPS, N_CHUNKS, DROPS = 64, 4, 4, (1,)
# tests/test_torch_runner.py:25-29: the JAX and port F-engines may round a
# value within float32 noise of a .5 boundary apart; the visibilities are
# bitwise equal otherwise
VIS_SNR_VS_JAX = 60.0
RUNNER_MODES = {"runner": ("runner_dumps",),
                "sp_runner": ("sp_runner_dumps",),
                "fengine": ("fengine_spectra", "fengine_golden"),
                "beam": ("beam_outputs", "beam_golden"),
                "beam_ep": ("beam_ep_outputs", "beam_ep_golden"),
                "verify": ("verify_fx4", "verify_beam64"),
                "refusals": ("refuse_sp_across", "refuse_run_batched")}


def _cfg(**kw):
    from dc_sand_tpu_torch.config import ChainConfig
    base = dict(name="mp", n_ants=8, n_pols=2, n_chans=N_CHANS, n_taps=TAPS,
                spectra_per_chunk=16, n_spectra_per_acc=32, apply_delay=True,
                apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _stream(cfg, seed):
    from dc_sand_tpu_torch import golden
    return golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, N_CHUNKS * cfg.chunk_samples), 20.0, seed)


def _delays(cfg, cls):
    """A drifting delay model whose coarse delay moves between chunks."""
    rng = np.random.default_rng(5)
    dm = cls.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
    dm.d0 = rng.integers(0, 8, (cfg.n_ants, cfg.n_pols)).astype(float)
    dm.p1 = rng.uniform(-1e-6, 1e-6, (cfg.n_ants, cfg.n_pols))
    dm.d1 = np.full((cfg.n_ants, cfg.n_pols), 1e-3)
    return dm


def _run(cfg, mesh, seed, weights=None, rows=slice(None)):
    """``(dumps, outputs)`` of ``cfg`` over ``mesh`` on the seeded stream,
    the source giving ``rows`` of it."""
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    from dc_sand_tpu_torch.windows import pfb_window
    stream = _stream(cfg, seed)
    c = cfg.chunk_samples
    outs = []
    runner = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                      delay_model=_delays(cfg, DelayModel), weights=weights,
                      mesh=mesh)
    dumps, _ = runner.run(lambda i: stream[rows, :, i * c:(i + 1) * c],
                          N_CHUNKS, drop_chunks=DROPS,
                          on_output=lambda i, o: outs.append(
                              {k: v.numpy() for k, v in o.items()}))
    return dumps, outs


def _golden_spectra(cfg, seed):
    from dc_sand_tpu_torch import golden, verify
    from dc_sand_tpu_torch.runtime import DelayModel
    from dc_sand_tpu_torch.windows import pfb_window
    stream = _stream(cfg, seed)
    for i in DROPS:
        stream[..., i * cfg.chunk_samples:(i + 1) * cfg.chunk_samples] = 0
    return verify._golden_spectra(
        cfg, stream, _delays(cfg, DelayModel),
        np.full(cfg.n_chans, cfg.quant_scale) + 0j, N_CHUNKS,
        pfb_window(cfg.n_taps, cfg.fft_size)), golden


# ---- the ranks --------------------------------------------------------------

def _same_dumps(a, b):
    return len(a) == len(b) > 0 and all(
        np.array_equal(x.vis, y.vis) and (x.n_spectra, x.first_chunk) ==
        (y.n_spectra, y.first_chunk) for x, y in zip(a, b))


def _rank(mode, check, outdir, rank):
    from dc_sand_tpu_torch.parallel import (build_global_mesh, build_mesh,
                                            local_antenna_range)
    from dc_sand_tpu_torch.utils import snr_db
    mesh = build_global_mesh(["cpu"] * 2)
    one = build_mesh(["cpu"] * 4)
    a0, a1 = local_antenna_range(8)
    mine = slice(a0, a1)
    if mode == "runner":
        cfg = _cfg()
        dumps, _ = _run(cfg, mesh, 6, rows=mine)
        check("runner_dumps", _same_dumps(dumps, _run(cfg, one, 6)[0]))
        np.save(os.path.join(outdir, f"runner_vis_{rank}.npy"),
                np.stack([d.vis for d in dumps]))
    elif mode == "sp_runner":
        # time axis within each rank (time_local), the stream of a rank's
        # antennas split over its two shards: the same dumps as fx only
        cfg = _cfg(time_shards=2)
        sp = build_global_mesh(["cpu"] * 2, time_shards=2, time_local=True)
        dumps, _ = _run(cfg, sp, 7, rows=mine)
        check("sp_runner_dumps",
              _same_dumps(dumps, _run(cfg, build_mesh(["cpu"] * 4, 2), 7)[0])
              and _same_dumps(dumps, _run(_cfg(), mesh, 7, rows=mine)[0]))
    elif mode == "fengine":
        cfg = _cfg(run_xengine=False, n_spectra_per_acc=16)
        _, outs = _run(cfg, mesh, 8, rows=mine)
        _, want = _run(cfg, one, 8)
        check("fengine_spectra", all(np.array_equal(o["spectra"],
                                                    w["spectra"][mine])
                                     for o, w in zip(outs, want)))
        spec_g, _ = _golden_spectra(cfg, 8)
        got = np.concatenate([o["spectra"] for o in outs], axis=2)
        check("fengine_golden", snr_db(spec_g[mine], got[..., 0] +
                                       1j * got[..., 1]) > 50)
    elif mode in ("beam", "beam_ep"):
        ep = mode == "beam_ep"
        cfg = _cfg(run_xengine=False, n_beams=4 if ep else 3,
                   incoherent_beam=True, beam_stokes=True, beam_parallel=ep)
        w = np.random.default_rng(33).normal(
            size=(cfg.n_beams, 8, N_CHANS, 2)).astype(np.float32)
        _, outs = _run(cfg, mesh, 9, weights=w, rows=mine)
        _, want = _run(cfg, one, 9, weights=w)
        share = slice(2 * rank, 2 * rank + 2) if ep else slice(None)
        check(f"{mode}_outputs", all(
            np.array_equal(o[k], w_[k][share] if k in ("beams", "stokes")
                           else w_[k])
            for o, w_ in zip(outs, want) for k in w_))
        spec_g, golden = _golden_spectra(cfg, 9)
        beams_g = golden.beamform(spec_g, w[..., 0] + 1j * w[..., 1])[share]
        got = np.concatenate([o["beams"] for o in outs], axis=2)
        check(f"{mode}_golden",
              snr_db(beams_g, got[..., 0] + 1j * got[..., 1]) > 50)
    elif mode == "verify":
        from dc_sand_tpu_torch.verify import SNR_BOUND, verify_config
        for name, scale in (("fx4", 64), ("beam64", 32)):
            snrs, _ = verify_config(name, mesh=mesh, scale=scale)
            want, _ = verify_config(name, mesh=one, scale=scale)
            print(f"verify {name}: {snrs}", flush=True)
            check(f"verify_{name}", all(v > SNR_BOUND for v in snrs.values())
                  and snrs == want)
    elif mode == "refusals":
        import pytest as pt
        from dc_sand_tpu_torch.runtime import FXRunner
        from dc_sand_tpu_torch.windows import pfb_window
        w = pfb_window(TAPS, 2 * N_CHANS)
        across = build_global_mesh(["cpu"] * 2, time_shards=2)
        with pt.raises(NotImplementedError, match="process-local"):
            FXRunner(_cfg(time_shards=2), w, mesh=across)
        check("refuse_sp_across", True)
        with pt.raises(NotImplementedError, match="single-process"):
            FXRunner(_cfg(), w, mesh=mesh).run_batched(None, 2)
        check("refuse_run_batched", True)


def rank_main(argv) -> int:
    """One rank: ``STORE OUTDIR MODE...``; the mode ``hosts`` names a
    different host on each rank before it joins."""
    sys.path.insert(0, ROOT)
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    store, outdir, modes = argv[0], argv[1], argv[2:]
    if modes == ["hosts"]:
        import socket
        rank = int(os.environ["RANK"])
        socket.gethostname = lambda: f"node{rank}"
        try:
            init_distributed(init_method=f"file://{store}")
        except RuntimeError as err:
            if "rank 0 on node0, rank 1 on node1" in str(err):
                print("PASS refuse_two_hosts", flush=True)
                return 0
            raise
        return 1
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


# ---- the tests --------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_runner")
    return tmp, spawn(__file__, tmp, list(RUNNER_MODES))


@pytest.mark.parametrize("name", [n for ns in RUNNER_MODES.values()
                                  for n in ns])
def test_rank_passes(ranks, name):
    """Bitwise the one-process runner over the same global mesh, > 50 dB
    against golden where the JAX rung grades, the JAX refusals."""
    for out in ranks[1]:
        assert f"PASS {name}\n" in out, out


def test_runner_dumps_match_jax(ranks):
    """Both ranks' dumps (each the whole set) against the JAX runner on
    one process, the same stream, delay model and drops."""
    from dc_sand_tpu.config import ChainConfig as JaxConfig
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    import dataclasses
    tmp = ranks[0]
    vis = [np.load(tmp / f"runner_vis_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(vis[0], vis[1])
    cfg = _cfg()
    stream = _stream(cfg, 6)
    c = cfg.chunk_samples
    jd, _ = JaxRunner(JaxConfig(**dataclasses.asdict(cfg)),
                      pfb_window(TAPS, 2 * N_CHANS),
                      delay_model=_delays(cfg, JaxDelayModel),
                      impl="jnp").run(lambda i: stream[..., i * c:(i + 1) * c],
                                      N_CHUNKS, drop_chunks=DROPS)
    assert len(jd) == len(vis[0]) == 2
    for j, got in zip(jd, vis[0]):
        assert snr_db(j.vis[..., 0] + 1j * j.vis[..., 1],
                      got[..., 0] + 1j * got[..., 1]) > VIS_SNR_VS_JAX


def test_ranks_on_two_hosts_are_refused(tmp_path):
    for out in spawn(__file__, tmp_path, ["hosts"]):
        assert "PASS refuse_two_hosts\n" in out, out


def test_cli_run_distributed(tmp_path):
    """``cli run fx4 --cpu --distributed --mesh 4`` on two ranks prints the
    lines of the one-process ``--mesh 4`` run on each rank, and each rank
    saves its own checkpoint file."""
    import subprocess
    from dc_sand_tpu_torch.parallel.launch import run_ranks
    args = ["run", "fx4", "--cpu", "--scale", "32", "--chunks", "4",
            "--mesh", "4"]
    one = subprocess.run([sys.executable, "-m", "dc_sand_tpu_torch.cli",
                          *args], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert one.returncode == 0, one.stderr
    ckpt = str(tmp_path / "state")
    results = run_ranks([sys.executable, "-m", "dc_sand_tpu_torch.cli",
                         *args, "--distributed", "--checkpoint", ckpt], 2,
                        timeout=120, cwd=ROOT)
    want = [ln for ln in one.stdout.splitlines() if ln.startswith("dump")]
    assert len(want) == 4
    for rank, res in enumerate(results):
        assert res.returncode == 0, res.output
        lines = res.output.splitlines()
        assert any(ln.startswith("distributed: {'process_index': "
                                 f"{rank}, 'process_count': 2")
                   for ln in lines), res.output
        assert [ln for ln in lines if ln.startswith("dump")] == want
        assert f"state saved to {ckpt}.proc{rank}of2.npz" in lines
        assert os.path.exists(f"{ckpt}.proc{rank}of2.npz")


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
