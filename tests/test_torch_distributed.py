"""The port's multi-process mode on the CPU: the collectives and the
one-shot steps across ``torch.distributed`` ranks (gloo), each rank a
subprocess running this file's ``__main__`` branch with 2 CPU shards.

Every rank checks its own shards bitwise against the port's one-process
run over the same global mesh (in the rank itself) and prints ``PASS
<check>``; the tests here read those lines, and hold what the ranks wrote
against the JAX package on the same numpy inputs (the JAX rungs of
``tests/test_distributed.py``: ``fx`` and ``sp``).  Ranks meet through a
``file://`` store under the test's temporary directory.

    python tests/test_torch_distributed.py STORE OUTDIR MODE...   (a rank)
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N_CHANS, TAPS = 64, 4
M = 2 * N_CHANS
SP_FRAMES = 8                 # frames a time shard in the sp rung
# as tests/test_torch_sharded.py: the packages' F-engines may round a value
# within float32 noise of a .5 boundary apart
VIS_SNR_VS_JAX = 60.0
STEP_MODES = {"collectives": ("a2a_block", "a2a_pitched", "ring_time",
                              "ring_fx", "psum", "psum_scatter",
                              "halo_exchange"),
              "fx": ("fx_step",), "sp": ("sp_fengine",)}


def _fx_inputs():
    """The fx rung's global inputs, the same on every rank."""
    from dc_sand_tpu_torch import golden
    n_ants, n_pols, nb = 8, 2, 8
    rng = np.random.default_rng(19)
    x = golden.gaussian_noise_int8(
        (n_ants, n_pols, (nb + TAPS - 1) * M + 16), 20.0, 2)
    cd = rng.integers(0, 16, (n_ants, n_pols))
    fd = rng.uniform(-0.5, 0.5, (n_ants, n_pols, nb)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (n_ants, n_pols, nb)).astype(np.float32)
    g = np.full(N_CHANS, 0.05) * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                          N_CHANS))
    return x, cd, fd, ph, g


def _sp_input():
    from dc_sand_tpu_torch import golden
    return golden.gaussian_noise_int8((2, 1, 4 * SP_FRAMES * M), 20.0, 9)


# ---- the ranks --------------------------------------------------------------

def _rank_collectives(check):
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            all_to_all_torch,
                                            build_global_mesh, build_mesh,
                                            halo_exchange_left, psum,
                                            psum_scatter, ring_permute_right,
                                            ring_permute_right_torch)
    rng = np.random.default_rng(1)
    every = [torch.from_numpy(rng.integers(-127, 128, (8, 2, 3, 16),
                                           dtype=np.int8)) for _ in range(4)]
    mesh = build_global_mesh(["cpu"] * 2)
    one = build_mesh(["cpu"] * 4)
    assert mesh.multiprocess and mesh.shape == one.shape
    mine = [every[d] for d in mesh.local_shards]

    def same(got, want):
        return len(got) == len(mesh.local_shards) and all(
            torch.equal(g, want[d]) for g, d in zip(got, mesh.local_shards))

    check("a2a_block", same(all_to_all(mine, mesh, FX_AXIS),
                            all_to_all_torch(every, one, FX_AXIS)))
    check("a2a_pitched", same(
        all_to_all(mine, mesh, FX_AXIS, rows=4),
        all_to_all_torch(every, one, FX_AXIS, rows=4)))
    sp = build_global_mesh(["cpu"] * 2, time_shards=2)
    sp_one = build_mesh(["cpu"] * 4, time_shards=2)
    # time-major: the time ring crosses the processes, the fx ring not
    assert {sp.process_of(d) for d in (0, 2)} == {0, 1}
    for axis, name in ((TIME_AXIS, "ring_time"), (FX_AXIS, "ring_fx")):
        got = ring_permute_right([every[d] for d in sp.local_shards], sp,
                                 axis)
        check(name, same(got, ring_permute_right_torch(every, sp_one,
                                                       axis)))
    floats = [torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
              for _ in range(4)]
    fmine = [floats[d] for d in mesh.local_shards]
    check("psum", same(psum(fmine, mesh, FX_AXIS),
                       psum(floats, one, FX_AXIS)))
    check("psum_scatter", same(psum_scatter(fmine, mesh, FX_AXIS),
                               psum_scatter(floats, one, FX_AXIS)))
    check("halo_exchange", same(
        halo_exchange_left([every[d] for d in sp.local_shards], 5, sp),
        halo_exchange_left(every, 5, sp_one)))


def _rank_fx(check, outdir, rank):
    import torch
    from dc_sand_tpu_torch.models.fx import make_sharded_fx_step
    from dc_sand_tpu_torch.parallel import build_global_mesh, build_mesh
    from dc_sand_tpu_torch.windows import pfb_window
    x, cd, fd, ph, g = _fx_inputs()
    g_ri = np.stack([g.real, g.imag], -1).astype(np.float32)
    t = torch.from_numpy
    args = (t(x), t(fd), t(ph), t(g_ri), t(cd))
    w = pfb_window(TAPS, M)
    got = make_sharded_fx_step(build_global_mesh(["cpu"] * 2), w, TAPS,
                               N_CHANS, 8, max_delay=16)(*args)
    want = make_sharded_fx_step(build_mesh(["cpu"] * 4), w, TAPS, N_CHANS, 8,
                                max_delay=16)(*args)
    check("fx_step", torch.equal(got, want))
    np.save(os.path.join(outdir, f"fx_vis_{rank}.npy"), got.numpy())


def _rank_sp(check, outdir, rank):
    import torch
    from dc_sand_tpu_torch.models.fx import make_time_sharded_fengine
    from dc_sand_tpu_torch.parallel import build_global_mesh, build_mesh
    from dc_sand_tpu_torch.windows import pfb_window
    x = torch.from_numpy(_sp_input())
    w = pfb_window(TAPS, M)
    mesh = build_global_mesh(["cpu"] * 2, time_shards=4)
    got = make_time_sharded_fengine(mesh, w, TAPS, N_CHANS)(x)
    want = make_time_sharded_fengine(build_mesh(["cpu"] * 4, time_shards=4),
                                     w, TAPS, N_CHANS)(x)
    ts, _ = mesh.local_block()
    rows = want[:, :, ts[0] * SP_FRAMES:(ts[-1] + 1) * SP_FRAMES]
    check("sp_fengine", torch.equal(got, rows))
    np.save(os.path.join(outdir, f"sp_spectra_{rank}.npy"), got.numpy())


def _rank_card(check):
    """Two ranks on cuda:0 (or a card each): K7b in block and pitched mode
    and K7a through the peers' IPC mappings, bitwise their multi-process
    plain versions and the one-process ones, one launch a call a rank;
    the IPC sums bitwise the one-process sums."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                            all_to_all, all_to_all_torch,
                                            build_global_mesh, build_mesh,
                                            psum, psum_scatter,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.parallel.distributed import local_rank
    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    mesh = build_global_mesh([dev] * 2)
    one = build_mesh([dev] * 4)
    sp = build_global_mesh([dev] * 2, time_shards=2)
    sp_one = build_mesh([dev] * 4, time_shards=2)
    rng = np.random.default_rng(3)
    for shape in ((8, 4, 5), (4096, 2, 64)):
        every = [torch.from_numpy(rng.integers(-127, 128, shape,
                                               dtype=np.int8)).to(dev)
                 for _ in range(4)]
        mine = [every[d] for d in mesh.local_shards]
        bufs = SharedBuffers(mesh, shape, torch.int8)

        def same(got, want):
            torch.cuda.synchronize(dev)
            return all(torch.equal(g, w) for g, w in zip(got, want))

        def one_of(want, m):
            return [want[d] for d in m.local_shards]

        for rows in (1, 4):
            before = all_to_all.launches
            got = all_to_all(mine, mesh, FX_AXIS, rows=rows, out=bufs,
                             impl="cuda")
            ok = (all_to_all.launches == before + 1
                  and same(got, all_to_all_torch(mine, mesh, FX_AXIS,
                                                 rows=rows))
                  and same(got, one_of(all_to_all_torch(every, one, FX_AXIS,
                                                        rows=rows), mesh)))
            check(f"ipc_a2a_{'block' if rows == 1 else 'pitched'}_"
                  f"{shape[0]}", ok)
        ring_bufs = SharedBuffers(sp, shape, torch.int8)
        smine = [every[d] for d in sp.local_shards]
        for axis in (TIME_AXIS, FX_AXIS):
            before = ring_permute_right.launches
            got = ring_permute_right(smine, sp, axis, out=ring_bufs,
                                     impl="cuda")
            ok = (ring_permute_right.launches == before + 1
                  and same(got, ring_permute_right_torch(smine, sp, axis))
                  and same(got, one_of(ring_permute_right_torch(
                      every, sp_one, axis), sp)))
            check(f"ipc_ring_{axis}_{shape[0]}", ok)
    floats = [torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32))
              .to(dev) for _ in range(4)]
    fbufs = SharedBuffers(mesh, (64, 33), torch.float32)
    fmine = [floats[d] for d in mesh.local_shards]
    for _ in range(2):          # the second round reuses the buffers
        check("ipc_psum", all(torch.equal(g, w) for g, w in zip(
            psum(fmine, mesh, FX_AXIS, buffers=fbufs),
            [psum(floats, one, FX_AXIS)[d] for d in mesh.local_shards])))
        check("ipc_psum_scatter", all(torch.equal(g, w) for g, w in zip(
            psum_scatter(fmine, mesh, FX_AXIS, buffers=fbufs),
            [psum_scatter(floats, one, FX_AXIS)[d]
             for d in mesh.local_shards])))


def rank_main(argv) -> int:
    """One rank: ``STORE OUTDIR MODE...``."""
    sys.path.insert(0, ROOT)
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    store, outdir, modes = argv[0], argv[1], argv[2:]
    info = init_distributed(init_method=f"file://{store}")
    rank = info["process_index"]

    def check(name, ok):
        if not ok:
            raise AssertionError(f"rank {rank}: {name} differs from the "
                                 "one-process run")
        print(f"PASS {name}", flush=True)

    for mode in modes:
        if mode == "collectives":
            _rank_collectives(check)
        elif mode == "fx":
            _rank_fx(check, outdir, rank)
        elif mode == "sp":
            _rank_sp(check, outdir, rank)
        elif mode == "card":
            _rank_card(check)
    ipc.close_all()
    return 0


# ---- the tests --------------------------------------------------------------

def spawn(test_file, tmp, modes, world=2, timeout=240, nodes=None,
          env=None):
    """Run ``world`` ranks of ``test_file``'s ``__main__`` over the modes
    (on ``nodes`` nodes of this host, as ``run_ranks`` forms them; ``env``
    added to each rank's environment); returns each rank's output, after
    asserting that every rank passed."""
    from dc_sand_tpu_torch.parallel.launch import run_ranks
    store = os.path.join(tmp, "store")
    results = run_ranks([sys.executable, test_file, store, str(tmp),
                         *modes], world, timeout=timeout,
                        env={"OMP_NUM_THREADS": "2", **(env or {})},
                        nodes=nodes)
    for rank, res in enumerate(results):
        assert res.returncode == 0, f"rank {rank}:\n{res.output}"
    return [res.output for res in results]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_steps")
    return tmp, spawn(__file__, tmp, list(STEP_MODES))


@pytest.mark.parametrize("name", [n for ns in STEP_MODES.values()
                                  for n in ns])
def test_rank_bitwise_one_process(ranks, name):
    """Each rank's shards equal the one-process run over the same global
    mesh, bitwise."""
    for out in ranks[1]:
        assert f"PASS {name}\n" in out, out


def test_fx_step_matches_jax_and_golden(ranks):
    """Every rank's visibilities (the same whole set on both) against the
    JAX sharded fx step on a 4-device mesh and the golden chain."""
    import jax.numpy as jnp
    from dc_sand_tpu import golden
    from dc_sand_tpu.models.fx import make_sharded_fx_step
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    tmp = ranks[0]
    vis = [np.load(tmp / f"fx_vis_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(vis[0], vis[1])
    x, cd, fd, ph, g = _fx_inputs()
    g_ri = np.stack([g.real, g.imag], -1).astype(np.float32)
    w = pfb_window(TAPS, M)
    jvis = make_sharded_fx_step(build_mesh(n_devices=4), w, TAPS, N_CHANS, 8,
                                impl="jnp", max_delay=16)(
        jnp.asarray(x), jnp.asarray(fd), jnp.asarray(ph), jnp.asarray(g_ri),
        jnp.asarray(cd, jnp.int32))

    def c(v):
        v = np.asarray(v)
        return v[..., 0] + 1j * v[..., 1]

    assert snr_db(c(jvis), c(vis[0])) > VIS_SNR_VS_JAX
    vis_g = golden.xcorr(golden.f_engine(x, w, TAPS, N_CHANS,
                                         coarse_delays=cd, max_delay=16,
                                         frac_delay=fd, phase=ph, gains=g))
    assert snr_db(vis_g, c(vis[0])) > 50


def test_sp_fengine_matches_jax_and_golden(ranks):
    """The two ranks' time shards, joined, against the JAX time-sharded
    F-engine on a (time 4) mesh and the golden chain (> 100 dB: float32
    spectra)."""
    import jax.numpy as jnp
    from dc_sand_tpu import golden
    from dc_sand_tpu.models.fx import make_time_sharded_fengine
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    tmp = ranks[0]
    got = np.concatenate([np.load(tmp / f"sp_spectra_{r}.npy")
                          for r in range(2)], axis=2)
    x = _sp_input()
    w = pfb_window(TAPS, M)
    jfe = make_time_sharded_fengine(build_mesh(n_devices=4, time_shards=4),
                                    w, TAPS, N_CHANS, impl="jnp")(
        jnp.asarray(x))
    c = (lambda v: np.asarray(v)[..., 0] + 1j * np.asarray(v)[..., 1])
    assert snr_db(c(jfe), c(got)) > 100
    lead = np.zeros((2, 1, (TAPS - 1) * M))
    ref = golden.channelize(golden.pfb_fir(np.concatenate([lead, x], -1),
                                           w, TAPS, M), N_CHANS)
    assert snr_db(ref, c(got)) > 100


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the IPC route of K7a and K7b)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ipc_kernels_and_sums_on_the_card(cuda, tmp_path):
    """Two ranks on the card: K7b (block, pitched) and K7a write into the
    peers' buffers through CUDA IPC, bitwise their plain versions over
    gloo and the one-process ones; the IPC psum and psum_scatter bitwise
    the one-process sums."""
    outs = spawn(__file__, tmp_path, ["card"])
    names = [f"ipc_a2a_{m}_{n}" for m in ("block", "pitched")
             for n in (8, 4096)] + [f"ipc_ring_{a}_{n}" for a in ("time", "fx")
                                    for n in (8, 4096)]
    for out in outs:
        for name in names + ["ipc_psum", "ipc_psum_scatter"]:
            assert f"PASS {name}\n" in out, out


def test_shared_buffers_refusals(monkeypatch):
    """The IPC route spans the ranks of a multi-process mesh and refuses
    the allocator's expandable segments, whose memory it cannot export."""
    from dc_sand_tpu_torch.parallel import SharedBuffers, build_mesh, ipc
    with pytest.raises(ValueError, match="multi-process"):
        SharedBuffers(build_mesh(["cpu"] * 2), (4,), None)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with pytest.raises(RuntimeError, match="expandable_segments"):
        ipc._check_alloc_conf()


@pytest.mark.parametrize("n_ants,world", [(8, 2), (8, 4), (12, 4)])
def test_local_antenna_range_matches_jax(monkeypatch, n_ants, world):
    """The port's arithmetic against the JAX function's, every rank."""
    import jax
    from dc_sand_tpu.parallel import distributed as jax_dist
    from dc_sand_tpu_torch.parallel import distributed as port_dist
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(port_dist, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(port_dist, "process_index", lambda: rank)
        assert port_dist.local_antenna_range(n_ants) == \
            jax_dist.local_antenna_range(n_ants)
    with pytest.raises(ValueError, match="not divisible"):
        port_dist.local_antenna_range(n_ants + 1)
    with pytest.raises(ValueError, match="not divisible"):
        jax_dist.local_antenna_range(n_ants + 1)


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
