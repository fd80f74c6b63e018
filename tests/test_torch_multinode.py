"""The port's multi-process mode across nodes, on the CPU: two ranks that
``run_ranks(..., nodes=2)`` puts on two nodes of this host (torchrun's
``GROUP_RANK``), so that every pair of ranks takes the staged route
(pinned host slots and gloo on the card; plain host slots here, the same
bookkeeping).

Each rank runs this file's ``__main__`` branch (gloo over a ``file://``
store, 2 CPU shards a rank) and holds the collectives, the fx and sp
steps and a runner with per-rank checkpoints bitwise against the port's
one-process mesh, printing ``PASS <check>``; the tests here read those
lines and hold what the ranks wrote against the JAX rungs of
``tests/test_distributed.py`` as ``tests/test_torch_distributed.py``
does.  The ``cuda`` case runs the staged K7b and K7a on the card.

    python tests/test_torch_multinode.py STORE OUTDIR MODE...   (a rank)
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_torch_distributed as td  # noqa: E402
import test_torch_distributed_runner as tdr  # noqa: E402

N_CHANS, TAPS = td.N_CHANS, td.TAPS
STAGED_MODES = {"collectives": td.STEP_MODES["collectives"],
                "fx": ("fx_step", "fx_staged"),
                "sp": ("sp_fengine", "sp_staged"),
                "runner": ("runner_dumps", "runner_resumed")}


# ---- the ranks --------------------------------------------------------------

def _rank_collectives(check, rank):
    """Every collective through out= buffers whose peers are all on the
    other node: bitwise the one-process mesh, the blocks crossing in
    staged rounds."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                            StagedRoute, all_to_all,
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
    if mesh.routes() != {1 - rank: "staged"}:
        raise AssertionError(f"routes {mesh.routes()}")
    mine = [every[d] for d in mesh.local_shards]

    def same(got, want):
        return len(got) == len(mesh.local_shards) and all(
            torch.equal(g, want[d]) for g, d in zip(got, mesh.local_shards))

    def staged(name, fn, want):
        rounds = StagedRoute.rounds
        check(name, same(fn(), want) and StagedRoute.rounds > rounds)

    bufs = SharedBuffers(mesh, every[0].shape, torch.int8)
    for _ in range(2):      # the second round takes the other slots
        staged("a2a_block",
               lambda: all_to_all(mine, mesh, FX_AXIS, out=bufs),
               all_to_all_torch(every, one, FX_AXIS))
        staged("a2a_pitched",
               lambda: all_to_all(mine, mesh, FX_AXIS, rows=4, out=bufs),
               all_to_all_torch(every, one, FX_AXIS, rows=4))
    sp = build_global_mesh(["cpu"] * 2, time_shards=2)
    sp_one = build_mesh(["cpu"] * 4, time_shards=2)
    ring_bufs = SharedBuffers(sp, every[0].shape, torch.int8)
    for axis, name in ((TIME_AXIS, "ring_time"), (FX_AXIS, "ring_fx")):
        got = ring_permute_right([every[d] for d in sp.local_shards], sp,
                                 axis, out=ring_bufs)
        check(name, all(torch.equal(g, w) for g, w in zip(
            got, [ring_permute_right_torch(every, sp_one, axis)[d]
                  for d in sp.local_shards])))
    floats = [torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
              for _ in range(4)]
    fmine = [floats[d] for d in mesh.local_shards]
    fbufs = SharedBuffers(mesh, (8, 5), torch.float32)
    for _ in range(2):
        staged("psum", lambda: psum(fmine, mesh, FX_AXIS, buffers=fbufs),
               psum(floats, one, FX_AXIS))
        staged("psum_scatter",
               lambda: psum_scatter(fmine, mesh, FX_AXIS, buffers=fbufs),
               psum_scatter(floats, one, FX_AXIS))
    halo = SharedBuffers(sp, every[0].shape[:-1] + (5,), torch.int8)
    got = halo_exchange_left([every[d] for d in sp.local_shards], 5, sp,
                             out=halo)
    want = halo_exchange_left(every, 5, sp_one)
    check("halo_exchange", all(torch.equal(g, want[d])
                               for g, d in zip(got, sp.local_shards)))


def _rank_steps(mode, check, outdir, rank):
    """The fx and sp rungs of tests/test_torch_distributed.py on two
    nodes: every pair staged, bitwise the one-process mesh."""
    from dc_sand_tpu_torch.parallel import StagedRoute
    rounds = StagedRoute.rounds
    if mode == "fx":
        td._rank_fx(check, outdir, rank)
    else:
        td._rank_sp(check, outdir, rank)
    check(f"{mode}_staged", StagedRoute.rounds > rounds)


def _rank_runner(check, outdir, rank):
    """fx through FXRunner.run() on two nodes, each rank its antennas:
    the dumps bitwise the one-process runner's; a per-rank checkpoint
    after 2 chunks resumes in a fresh runner to the same last dump."""
    from dc_sand_tpu_torch.parallel import (StagedRoute, build_global_mesh,
                                            build_mesh, local_antenna_range)
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.windows import pfb_window
    cfg = tdr._cfg()
    mesh = build_global_mesh(["cpu"] * 2)
    mine = slice(*local_antenna_range(cfg.n_ants))
    rounds = StagedRoute.rounds
    dumps, _ = tdr._run(cfg, mesh, 6, rows=mine)
    want, _ = tdr._run(cfg, build_mesh(["cpu"] * 4), 6)
    check("runner_dumps", tdr._same_dumps(dumps, want)
          and StagedRoute.rounds > rounds)
    np.save(os.path.join(outdir, f"runner_vis_{rank}.npy"),
            np.stack([d.vis for d in dumps]))
    stream = tdr._stream(cfg, 6)
    c = cfg.chunk_samples

    def src(i):
        return stream[mine, :, i * c:(i + 1) * c]

    w = pfb_window(cfg.n_taps, cfg.fft_size)
    first = FXRunner(cfg, w, delay_model=tdr._delays(cfg, DelayModel),
                     mesh=mesh)
    first.run(src, 2, drop_chunks=tdr.DROPS)
    path = save_state(first, os.path.join(outdir, "state"))
    # the file carries the delay model: the fresh runner starts from zeros
    resumed = FXRunner(cfg, w, delay_model=DelayModel.zeros(
        cfg.n_ants, cfg.n_pols, 8), mesh=mesh)
    load_state(resumed, os.path.join(outdir, "state"))
    got, _ = resumed.run(src, 2, drop_chunks=tdr.DROPS)
    check("runner_resumed",
          path.endswith(f"state.proc{rank}of2.npz") and len(got) == 1
          and np.array_equal(got[0].vis, want[-1].vis))


def _rank_card(check):
    """Two ranks on two nodes of the card: the staged K7b (block and
    pitched) and K7a bitwise their plain versions over gloo and the
    one-process ones; each call a rank launches once for its own node's
    pairs and once, on the receiver, for the blocks that came in."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                            all_to_all, all_to_all_torch,
                                            build_global_mesh, build_mesh,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.parallel.distributed import local_rank
    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    mesh = build_global_mesh([dev] * 2)
    sp = build_global_mesh([dev] * 2, time_shards=2)
    one, sp_one = build_mesh([dev] * 4), build_mesh([dev] * 4, time_shards=2)
    rng = np.random.default_rng(3)
    for shape in ((8, 4, 5), (4096, 2, 64)):
        every = [torch.from_numpy(rng.integers(-127, 128, shape,
                                               dtype=np.int8)).to(dev)
                 for _ in range(4)]
        bufs = SharedBuffers(mesh, shape, torch.int8)
        mine = [every[d] for d in mesh.local_shards]
        for rows in (1, 4):
            before = all_to_all.launches
            got = all_to_all(mine, mesh, FX_AXIS, rows=rows, out=bufs,
                             impl="cuda")
            torch.cuda.synchronize(dev)
            want = all_to_all_torch(every, one, FX_AXIS, rows=rows)
            check(f"staged_a2a_{'block' if rows == 1 else 'pitched'}_"
                  f"{shape[0]}", all_to_all.launches == before + 2
                  and all(torch.equal(g, w) for g, w in zip(got, (
                      all_to_all_torch(mine, mesh, FX_AXIS, rows=rows))))
                  and all(torch.equal(g, want[d])
                          for g, d in zip(got, mesh.local_shards)))
        ring = SharedBuffers(sp, shape, torch.int8)
        smine = [every[d] for d in sp.local_shards]
        before = ring_permute_right.launches
        got = ring_permute_right(smine, sp, TIME_AXIS, out=ring,
                                 impl="cuda")
        torch.cuda.synchronize(dev)
        want = ring_permute_right_torch(every, sp_one, TIME_AXIS)
        # time-major: both of a rank's shards send to the other node
        check(f"staged_ring_{shape[0]}",
              ring_permute_right.launches == before + 1
              and all(torch.equal(g, w) for g, w in zip(
                  got, ring_permute_right_torch(smine, sp, TIME_AXIS)))
              and all(torch.equal(g, want[d])
                      for g, d in zip(got, sp.local_shards)))


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
            _rank_collectives(check, rank)
        elif mode in ("fx", "sp"):
            _rank_steps(mode, check, outdir, rank)
        elif mode == "runner":
            _rank_runner(check, outdir, rank)
        elif mode == "card":
            _rank_card(check)
    ipc.close_all()
    return 0


# ---- the tests --------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multinode")
    return tmp, td.spawn(__file__, tmp, list(STAGED_MODES), nodes=2)


@pytest.mark.parametrize("name", [n for ns in STAGED_MODES.values()
                                  for n in ns])
def test_staged_rank_bitwise_one_process(ranks, name):
    """Each rank's shards on two nodes equal the one-process run over the
    same global mesh, bitwise, through the staged route."""
    for out in ranks[1]:
        assert f"PASS {name}\n" in out, out


def test_fx_across_nodes_matches_jax(ranks):
    """Both ranks' visibilities against the JAX sharded fx step on a
    4-device mesh (the JAX rung ``fx``)."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.fx import make_sharded_fx_step
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    vis = [np.load(ranks[0] / f"fx_vis_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(vis[0], vis[1])
    x, cd, fd, ph, g = td._fx_inputs()
    g_ri = np.stack([g.real, g.imag], -1).astype(np.float32)
    jvis = make_sharded_fx_step(build_mesh(n_devices=4), pfb_window(
        TAPS, 2 * N_CHANS), TAPS, N_CHANS, 8, impl="jnp", max_delay=16)(
        jnp.asarray(x), jnp.asarray(fd), jnp.asarray(ph), jnp.asarray(g_ri),
        jnp.asarray(cd, jnp.int32))
    c = (lambda v: np.asarray(v)[..., 0] + 1j * np.asarray(v)[..., 1])
    assert snr_db(c(jvis), c(vis[0])) > td.VIS_SNR_VS_JAX


def test_sp_across_nodes_matches_jax(ranks):
    """The two nodes' time shards, joined, against the JAX time-sharded
    F-engine on a (time 4) mesh (the JAX rung ``sp``)."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.fx import make_time_sharded_fengine
    from dc_sand_tpu.parallel import build_mesh
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    got = np.concatenate([np.load(ranks[0] / f"sp_spectra_{r}.npy")
                          for r in range(2)], axis=2)
    jfe = make_time_sharded_fengine(build_mesh(n_devices=4, time_shards=4),
                                    pfb_window(TAPS, 2 * N_CHANS), TAPS,
                                    N_CHANS, impl="jnp")(
        jnp.asarray(td._sp_input()))
    c = (lambda v: np.asarray(v)[..., 0] + 1j * np.asarray(v)[..., 1])
    assert snr_db(c(jfe), c(got)) > 100


def test_runner_across_nodes_matches_jax(ranks):
    """Both ranks' runner dumps against the JAX runner in one process,
    at tests/test_torch_runner.py's tolerance."""
    import dataclasses
    from dc_sand_tpu.config import ChainConfig as JaxConfig
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.utils import snr_db
    vis = [np.load(ranks[0] / f"runner_vis_{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(vis[0], vis[1])
    cfg = tdr._cfg()
    stream = tdr._stream(cfg, 6)
    c = cfg.chunk_samples
    jd, _ = JaxRunner(JaxConfig(**dataclasses.asdict(cfg)),
                      pfb_window(TAPS, 2 * N_CHANS),
                      delay_model=tdr._delays(cfg, JaxDelayModel),
                      impl="jnp").run(lambda i: stream[..., i * c:(i + 1) * c],
                                      tdr.N_CHUNKS, drop_chunks=tdr.DROPS)
    assert len(jd) == len(vis[0]) == 2
    for j, got in zip(jd, vis[0]):
        assert snr_db(j.vis[..., 0] + 1j * j.vis[..., 1],
                      got[..., 0] + 1j * got[..., 1]) > tdr.VIS_SNR_VS_JAX


def test_routes_of_two_nodes_of_two_ranks():
    """A same-node peer is ``ipc``, a peer on the other node ``staged``;
    the process-major layout does not depend on the nodes."""
    import torch
    from dc_sand_tpu_torch.parallel import Mesh
    devs = np.empty((1, 4), dtype=object)
    devs[:] = [torch.device("cpu")] * 4
    nodes = ("hostA", "hostA", "hostB", "hostB")
    for rank in range(4):
        mesh = Mesh(devs, np.arange(4).reshape(1, 4), rank, nodes)
        assert mesh.node_of(rank) == nodes[rank]
        buddy = rank ^ 1
        assert mesh.routes() == {r: "ipc" if r == buddy else "staged"
                                 for r in range(4) if r != rank}
        assert mesh.local_shards == (rank,)
    with pytest.raises(ValueError, match="nodes for"):
        Mesh(devs, np.arange(4).reshape(1, 4), 0, nodes[:3])
    one = Mesh(devs, np.zeros((1, 4), dtype=int), 0)
    assert one.routes() == {} and one.node_of(0) == ""


def test_node_names_and_run_ranks_nodes(monkeypatch):
    """The node is the host name, ``host/g`` under torchrun's GROUP_RANK,
    or the name given; ``run_ranks(nodes=)`` forms torchrun's agents."""
    from dc_sand_tpu_torch.parallel import distributed, launch
    monkeypatch.setattr(distributed.socket, "gethostname", lambda: "h")
    monkeypatch.delenv("GROUP_RANK", raising=False)
    assert distributed.node_name() == "h"
    assert distributed.node_name("rack7") == "rack7"
    monkeypatch.setenv("GROUP_RANK", "1")
    assert distributed.node_name() == "h/1"
    res = launch.run_ranks([sys.executable, "-c", "import os; print(*(os."
                            "environ[k] for k in ('RANK', 'GROUP_RANK', "
                            "'LOCAL_RANK', 'LOCAL_WORLD_SIZE')))"], 4,
                           nodes=2, timeout=60)
    assert [r.output.split() for r in res] == [
        ["0", "0", "0", "2"], ["1", "0", "1", "2"], ["2", "1", "0", "2"],
        ["3", "1", "1", "2"]]
    with pytest.raises(ValueError, match="do not form"):
        launch.run_ranks(["true"], 3, nodes=2)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the staged K7a and K7b)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_staged_kernels_on_the_card(cuda, tmp_path):
    """Two ranks on two nodes of the card: K7b (block, pitched) and K7a
    launched by the receiver on the blocks that came through the pinned
    slots, bitwise their plain versions over gloo and the one-process
    ones."""
    outs = td.spawn(__file__, tmp_path, ["card"], nodes=2)
    names = [f"staged_a2a_{m}_{n}" for m in ("block", "pitched")
             for n in (8, 4096)] + [f"staged_ring_{n}" for n in (8, 4096)]
    for out in outs:
        for name in names:
            assert f"PASS {name}\n" in out, out


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
