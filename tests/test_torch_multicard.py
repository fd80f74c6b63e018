"""A rank that holds several cards, as a JAX process holds its host's
chips: which cards a rank takes (``local_cards``), the device counts that
``init_distributed`` reports, and the mesh's bookkeeping of a rank's
cards (per-pair routes, per-card senders, ``time_local``), on the CPU;
with two or more cards, K7b, K7a and the sums with senders and receivers
on different cards, in one process and across 2 ranks of 2 cards,
bitwise their plain versions and the one-process mesh.

The JAX rungs of 2 ranks of 2 shards, on CPU shards here and on 2 cards
a rank with four cards: the runner's dumps against the JAX runner's, and
the JAX package's checkpoint of 2 processes x 2 devices loaded, each
carry on its shard's device, and run on to the JAX run's dump.  The
machine with the cards has no JAX, so the JAX package's results are
committed under ``tests/data/jax_2x2`` (:func:`write_jax_references`),
and a CPU test holds them to what the JAX package gives now.

Each rank of the multi-process cases runs this file's ``__main__`` branch
(gloo over a ``file://`` store), printing ``PASS <check>``.

    python tests/test_torch_multicard.py STORE OUTDIR MODE...   (a rank)
    python tests/test_torch_multicard.py jax-references OUTDIR
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_torch_distributed as td  # noqa: E402
import test_torch_distributed_ckpt as tdc  # noqa: E402
import test_torch_distributed_runner as tdr  # noqa: E402

DATA = os.path.join(HERE, "data", "jax_2x2")


def _cards(n):
    import torch
    return [torch.device("cuda", i) for i in range(n)]


# ---- which cards a rank takes -----------------------------------------------

@pytest.mark.parametrize("n_cards,n_local,rank,want", [
    (4, 1, 0, [0, 1, 2, 3]),
    (4, 2, 0, [0, 1]),
    (4, 2, 1, [2, 3]),
    (4, 4, 3, [3]),
    (8, 2, 1, [4, 5, 6, 7]),
    (1, 2, 1, [0]),             # fewer cards than ranks: l mod c
    (2, 4, 3, [1]),
])
def test_local_cards_blocks(n_cards, n_local, rank, want):
    """Rank l of L takes cards [l c / L, (l + 1) c / L); with fewer cards
    than ranks, card l mod c alone."""
    from dc_sand_tpu_torch.parallel.distributed import local_cards
    got = local_cards(n_cards, n_local, rank)
    assert all(d.type == "cuda" for d in got)
    assert [d.index for d in got] == want


@pytest.mark.parametrize("rank", [0, 1])
def test_local_cards_refusals(rank):
    """Cards that do not divide over the node's ranks raise, naming the
    counts; so do no card and a rank outside the node."""
    from dc_sand_tpu_torch.parallel.distributed import local_cards
    with pytest.raises(ValueError, match="3 cards do not divide over the "
                       "node's 2 ranks"):
        local_cards(3, 2, rank)
    with pytest.raises(ValueError, match="no CUDA device"):
        local_cards(0, 2, rank)
    with pytest.raises(ValueError, match="local rank 2 of 2"):
        local_cards(4, 2, 2)


def test_local_cards_reads_the_launcher(monkeypatch):
    """Without arguments: the cards torch sees, ``LOCAL_WORLD_SIZE`` and
    ``LOCAL_RANK``."""
    import torch
    from dc_sand_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_world_size() == 2
    assert distributed.local_cards() == _cards(4)[2:]
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert distributed.local_world_size() == 1       # no process group
    assert distributed.local_cards() == _cards(4)


# ---- the mesh's bookkeeping of a rank's cards --------------------------------

def _two_by_two(rank, time_local=False, nodes=("n0", "n0")):
    """The mesh of 2 ranks x 2 cards as ``build_global_mesh`` lays it out
    (rank 0 on cuda:0 and 1, rank 1 on cuda:2 and 3), built directly:
    ``Mesh`` checks no card."""
    from dc_sand_tpu_torch.parallel import Mesh
    from dc_sand_tpu_torch.parallel.mesh import _layout
    devs = np.empty(4, dtype=object)
    devs[:] = _cards(4)
    procs = np.array([0, 0, 1, 1])
    t = 2 if time_local else 1
    return Mesh(_layout(devs, t, time_local), _layout(procs, t, time_local),
                rank, nodes)


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_two_ranks_of_two_cards(rank):
    """fx over 4 shards, 2 a rank: the rank's cards, its shards by card,
    each pair's route, K7b's and K7a's senders by card, its block."""
    from dc_sand_tpu_torch.parallel import FX_AXIS
    mesh = _two_by_two(rank)
    mine = (2 * rank, 2 * rank + 1)
    c = _cards(4)
    assert mesh.local_shards == mine
    assert mesh.local_cards == [c[d] for d in mine]
    assert mesh.local_block() == ((0,), mine)
    assert mesh.routes() == {1 - rank: "ipc"}
    for i in range(4):
        for j in range(4):
            want = ("local" if i == j else "peer" if i // 2 == j // 2
                    else "ipc")
            assert mesh.route(i, j) == want, (i, j)
    # each sender lists its receivers in group order
    assert mesh.all_to_all_sends(FX_AXIS) == tuple(
        (c[i], tuple((i, j) for j in range(4))) for i in mine)
    assert mesh.ring_sends(FX_AXIS) == tuple(
        (c[i], ((i, (i + 1) % 4),)) for i in mine)
    # on other nodes the other rank's pairs are staged; a rank's own stay
    apart = _two_by_two(rank, nodes=("n0", "n1"))
    assert apart.routes() == {1 - rank: "staged"}
    assert apart.route(mine[0], mine[1]) == "peer"
    assert apart.route(mine[0], 3 - mine[0] // 2 * 2) == "staged"


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_time_local_keeps_the_halo_on_the_rank(rank):
    """``time_local`` with 2 time shards: a rank's two time shards lie on
    its two cards, so its halo ring goes card to card by peer access and
    never to the other rank; its K7b pairs reach the other rank."""
    from dc_sand_tpu_torch.parallel import FX_AXIS, TIME_AXIS
    mesh = _two_by_two(rank, time_local=True)
    c = _cards(4)
    head, tail = rank, 2 + rank          # shard (t, f) = t * 2 + f
    assert mesh.local_shards == (head, tail)
    assert mesh.coords(head) == (0, rank) and mesh.coords(tail) == (1, rank)
    assert mesh.local_cards == [c[2 * rank], c[2 * rank + 1]]
    assert mesh.local_block() == ((0, 1), (rank,))
    assert mesh.ring_sends(TIME_AXIS) == (
        (c[2 * rank], ((head, tail),)), (c[2 * rank + 1], ((tail, head),)))
    assert mesh.route(head, tail) == mesh.route(tail, head) == "peer"
    sends = dict(mesh.all_to_all_sends(FX_AXIS))
    assert sends[c[2 * rank]] == ((head, 0), (head, 1))
    assert all(mesh.route(i, j) == "ipc" for ps in sends.values()
               for i, j in ps if i != j)


def test_ipc_maps_a_peer_buffer_on_the_writing_card(monkeypatch):
    """A peer's handle is rebuilt in the context of this rank's card that
    writes into it, not on the exporter's device index, and without a
    wait on the producer's event (the exporter synchronised); the other
    arguments pass through."""
    import functools
    import inspect
    import torch
    from torch.multiprocessing import reductions
    from dc_sand_tpu_torch.parallel import ipc
    real = reductions.rebuild_cuda_tensor
    names = list(inspect.signature(real).parameters)
    got = {}

    @functools.wraps(real)
    def fake(*args):
        got.update(zip(names, args))
        return "view"

    monkeypatch.setattr(reductions, "rebuild_cuda_tensor", fake)
    args = [f"arg{i}" for i in range(len(names))]
    args[names.index("storage_device")] = 3
    args[names.index("event_sync_required")] = True
    assert ipc._open(tuple(args), 1, 2, torch.device("cuda", 1)) == "view"
    assert got["storage_device"] == 1
    assert got["event_sync_required"] is False
    assert all(got[k] == a for k, a in zip(names, args)
               if k not in ("storage_device", "event_sync_required"))


# ---- the ranks --------------------------------------------------------------

def _rank_counts(check, cpu, outdir, rank):
    """init_distributed's device counts: on the CPU one device a rank; as
    seen by 2 ranks of a node of 4 cards, 2 a rank and 4 in all."""
    import torch
    from dc_sand_tpu_torch.parallel import distributed
    check("counts_cpu", cpu["local_devices"] == 1
          and cpu["global_devices"] == 2
          and os.environ["LOCAL_WORLD_SIZE"] == "2")
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 4
    four = distributed.init_distributed()
    check("counts_four_cards", four["local_devices"] == 2
          and four["global_devices"] == 4
          and distributed.local_cards() == _cards(4)[2 * rank:2 * rank + 2])


def _rank_masks(check, cpu, outdir, rank):
    """A launcher that shows each rank of the node its own cards
    (``CUDA_VISIBLE_DEVICES`` 0,1 and 2,3, each rank seeing 2): each takes
    both of its cards, 4 in all; masks that share a card raise on every
    rank; one mask on both ranks is split as before."""
    import torch
    from dc_sand_tpu_torch.parallel import distributed
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 2
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0,1", "2,3")[rank]
    own = distributed.init_distributed()
    check("masks_own_cards", distributed.masked_per_rank()
          and own["local_devices"] == 2 and own["global_devices"] == 4
          and distributed.local_cards() == _cards(2))
    os.environ["CUDA_VISIBLE_DEVICES"] = ("0,1", "1,2")[rank]
    try:
        distributed.init_distributed()
        shared = None
    except ValueError as err:
        shared = str(err)
    check("masks_sharing_a_card_refused", shared is not None
          and "share no card" in shared and "'1,2'" in shared)
    os.environ["CUDA_VISIBLE_DEVICES"] = "0,1"
    one = distributed.init_distributed()
    check("masks_one_split", not distributed.masked_per_rank()
          and one["local_devices"] == 1 and one["global_devices"] == 2
          and distributed.local_cards() == _cards(2)[rank:rank + 1])


def _rank_card(check, info, outdir, rank):
    """2 ranks of 2 cards each: K7b (block, pitched) and K7a (over both
    axes, the time ring inside each rank with ``time_local``) bitwise
    their plain versions and the one-process 4-card mesh, one launch a
    card; psum and psum_scatter bitwise the one-process mesh; fx through
    the runner bitwise the one-process mesh, and a per-rank checkpoint
    resumed to it."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                            all_to_all, all_to_all_torch,
                                            build_global_mesh, build_mesh,
                                            local_antenna_range, psum,
                                            psum_scatter, ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.parallel.distributed import local_cards
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.windows import pfb_window
    cards = local_cards()
    check("cards", len(cards) == 2 and cards[0].index == 2 * rank
          and info["local_devices"] == 2 and info["global_devices"] == 4)
    mesh = build_global_mesh(cards)
    one = build_mesh(_cards(4))
    sp = build_global_mesh(cards, time_shards=2, time_local=True)
    sp_one = build_mesh(_cards(4), time_shards=2, time_local=True)
    rng = np.random.default_rng(4)

    def same(got, want, m):
        for c in cards:
            torch.cuda.synchronize(c)
        return all(torch.equal(g.cpu(), want[d].cpu())
                   for g, d in zip(got, m.local_shards))

    for shape in ((8, 4, 5), (4096, 2, 64)):
        every = [torch.from_numpy(rng.integers(-127, 128, shape,
                                               dtype=np.int8)).to(c)
                 for c in _cards(4)]
        bufs = SharedBuffers(mesh, shape, torch.int8)
        mine = [every[d] for d in mesh.local_shards]
        for rows in (1, 4):
            before = all_to_all.launches
            got = all_to_all(mine, mesh, FX_AXIS, rows=rows, out=bufs,
                             impl="cuda")
            want = all_to_all_torch(every, one, FX_AXIS, rows=rows)
            check(f"a2a_{'block' if rows == 1 else 'pitched'}_{shape[0]}",
                  all_to_all.launches == before + 2 and same(got, want, mesh)
                  and same(got, dict(zip(mesh.local_shards, all_to_all_torch(
                      mine, mesh, FX_AXIS, rows=rows))), mesh))
        ring = SharedBuffers(sp, shape, torch.int8)
        sp_every = [x.to(d) for x, d in zip(every, sp_one.flat_devices)]
        smine = [sp_every[d] for d in sp.local_shards]
        for axis in (TIME_AXIS, FX_AXIS):
            before = ring_permute_right.launches
            got = ring_permute_right(smine, sp, axis, out=ring, impl="cuda")
            want = ring_permute_right_torch(sp_every, sp_one, axis)
            check(f"ring_{axis}_{shape[0]}",
                  ring_permute_right.launches == before + 2
                  and same(got, want, sp))
    floats = [torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32))
              .to(c) for c in _cards(4)]
    fbufs = SharedBuffers(mesh, (64, 33), torch.float32)
    fmine = [floats[d] for d in mesh.local_shards]
    for _ in range(2):          # the second round reuses the buffers
        check("psum", same(psum(fmine, mesh, FX_AXIS, buffers=fbufs),
                           psum(floats, one, FX_AXIS), mesh))
        check("psum_scatter", same(
            psum_scatter(fmine, mesh, FX_AXIS, buffers=fbufs),
            psum_scatter(floats, one, FX_AXIS), mesh))
    cfg = tdr._cfg()
    rows = slice(*local_antenna_range(cfg.n_ants))
    stream = tdr._stream(cfg, 6)
    c = cfg.chunk_samples

    def runner(m, dm=None):
        return FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                        delay_model=dm or tdr._delays(cfg, DelayModel),
                        mesh=m)

    def src(sel):
        return lambda i: stream[sel, :, i * c:(i + 1) * c]

    want, _ = runner(one).run(src(slice(None)), tdr.N_CHUNKS,
                              drop_chunks=tdr.DROPS)
    got, _ = runner(mesh).run(src(rows), tdr.N_CHUNKS, drop_chunks=tdr.DROPS)
    check("runner_dumps", tdr._same_dumps(got, want))
    _jax_rungs(check, outdir, rank, mesh, got)
    first = runner(mesh)
    first.run(src(rows), 2, drop_chunks=tdr.DROPS)
    save_state(first, os.path.join(outdir, "state"))
    resumed = runner(mesh, DelayModel.zeros(cfg.n_ants, cfg.n_pols, 8))
    load_state(resumed, os.path.join(outdir, "state"))
    check("runner_resumed_cards", [h.device for h in resumed.history]
          == mesh.local_devices)
    dumps, _ = resumed.run(src(rows), 2, drop_chunks=tdr.DROPS)
    check("runner_resumed", len(dumps) == 1
          and np.array_equal(dumps[0].vis, want[-1].vis))


# ---- the JAX rungs ----------------------------------------------------------

def _jax_rungs(check, outdir, rank, mesh, runner_dumps):
    """The JAX rungs of a rank of ``mesh`` (2 ranks of 2 shards): the
    port's ``runner_dumps`` (``tdr``'s stream, delays and drops) saved for
    :func:`_match_jax`; the JAX package's checkpoint of 2 processes x 2
    devices (``DATA``) loaded, each carry on its shard's device, and run 2
    chunks on, its dump saved."""
    from dc_sand_tpu_torch.parallel import local_antenna_range
    from dc_sand_tpu_torch.runtime import DelayModel, load_jax_checkpoint
    np.save(os.path.join(outdir, f"runner_vis_{rank}.npy"),
            np.stack([d.vis for d in runner_dumps]))
    cfg = tdc._cfg(name="mpj")
    r = tdc._runner(cfg, mesh, DelayModel.zeros(cfg.n_ants, cfg.n_pols))
    load_jax_checkpoint(r, os.path.join(DATA, "jax_state"))
    check("jax_resumed_devices",
          [h.device for h in r.history] == mesh.local_devices
          and [a.device for a in r.vis_acc] == mesh.local_devices)
    dumps, _ = r.run(tdc._source(cfg, 57, slice(*local_antenna_range(
        cfg.n_ants))), 2)
    np.save(os.path.join(outdir, f"jax_resumed_{rank}.npy"), dumps[0].vis)
    check("jax_resumed", r.chunk_idx == 4 and len(dumps) == 1)


def _rank_jax_cpu(check, info, outdir, rank):
    """:func:`_jax_rungs` on 2 CPU shards a rank."""
    from dc_sand_tpu_torch.parallel import (build_global_mesh,
                                            local_antenna_range)
    mesh = build_global_mesh(["cpu"] * 2)
    cfg = tdr._cfg()
    dumps, _ = tdr._run(cfg, mesh, 6,
                        rows=slice(*local_antenna_range(cfg.n_ants)))
    _jax_rungs(check, outdir, rank, mesh, dumps)


def _close_to_jax(want, got) -> bool:
    from dc_sand_tpu_torch.utils import snr_db
    return snr_db(want[..., 0] + 1j * want[..., 1],
                  got[..., 0] + 1j * got[..., 1]) > tdr.VIS_SNR_VS_JAX


def _match_jax(outdir) -> None:
    """Both ranks' saved dumps (:func:`_jax_rungs`) against the JAX
    package's at ``tdr``'s tolerance: the runner's against the JAX
    runner's, the run resumed from the JAX checkpoint against the JAX
    processes' uninterrupted run."""
    jax_vis = np.load(os.path.join(DATA, "runner_vis.npy"))
    straight = np.load(os.path.join(DATA, "jax_straight.npy"))
    for rank in range(2):
        vis = np.load(os.path.join(outdir, f"runner_vis_{rank}.npy"))
        assert vis.shape == jax_vis.shape == (2,) + vis.shape[1:]
        assert all(_close_to_jax(j, g) for j, g in zip(jax_vis, vis))
        assert _close_to_jax(straight, np.load(
            os.path.join(outdir, f"jax_resumed_{rank}.npy")))


def write_jax_references(outdir: str) -> None:
    """What the JAX package gives for the JAX rungs, into ``outdir``:
    ``runner_vis.npy``, the JAX runner's two dumps on ``tdr``'s stream,
    delays and drops (as ``tdr.test_runner_dumps_match_jax`` runs it); and
    from ``tdc``'s writer, two ``jax.distributed`` CPU processes of 2
    devices each, ``jax_state.proc{0,1}of2.npz`` (their checkpoint after 2
    chunks) and ``jax_straight.npy`` (their uninterrupted run's second
    dump).  ``python tests/test_torch_multicard.py jax-references
    tests/data/jax_2x2`` rewrites the committed set."""
    import dataclasses
    import subprocess
    from concurrent.futures import ThreadPoolExecutor
    from dc_sand_tpu.config import ChainConfig as JaxConfig
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    from dc_sand_tpu.windows import pfb_window
    from dc_sand_tpu_torch.parallel.launch import free_port
    os.makedirs(outdir, exist_ok=True)
    cfg = tdr._cfg()
    stream = tdr._stream(cfg, 6)
    c = cfg.chunk_samples
    jd, _ = JaxRunner(JaxConfig(**dataclasses.asdict(cfg)),
                      pfb_window(cfg.n_taps, cfg.fft_size),
                      delay_model=tdr._delays(cfg, JaxDelayModel),
                      impl="jnp").run(lambda i: stream[..., i * c:(i + 1) * c],
                                      tdr.N_CHUNKS, drop_chunks=tdr.DROPS)
    np.save(os.path.join(outdir, "runner_vis.npy"),
            np.stack([np.asarray(d.vis) for d in jd]))
    port = free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [sys.executable, tdc.__file__, "jax", str(pid), str(port), outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
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
        if p.returncode != 0 or "PASS jax_writer" not in out:
            raise RuntimeError(f"the JAX writer failed:\n{out}")


def rank_main(argv) -> int:
    """One rank: ``STORE OUTDIR MODE``."""
    sys.path.insert(0, ROOT)
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    store, outdir, mode = argv
    info = init_distributed(init_method=f"file://{store}")
    rank = info["process_index"]

    def check(name, ok):
        if not ok:
            raise AssertionError(f"rank {rank}: {name} differs from the "
                                 "one-process run")
        print(f"PASS {name}", flush=True)

    {"counts": _rank_counts, "masks": _rank_masks, "jax_cpu": _rank_jax_cpu,
     "card": _rank_card}[mode](check, info, outdir, rank)
    ipc.close_all()
    return 0


# ---- the tests --------------------------------------------------------------

def test_init_distributed_counts_a_ranks_cards(tmp_path):
    """2 gloo ranks: 1 device a rank on the CPU; on a node of 4 cards, 2
    a rank and 4 in all (not every visible card counted on every
    rank)."""
    for out in td.spawn(__file__, tmp_path, ["counts"]):
        for name in ("counts_cpu", "counts_four_cards"):
            assert f"PASS {name}\n" in out, out


def test_local_cards_under_a_mask_a_rank(tmp_path):
    """2 gloo ranks, each shown 2 cards of its own by
    ``CUDA_VISIBLE_DEVICES``: each takes both, 4 devices in all; masks
    that share a card are refused; one mask is split over the ranks."""
    for out in td.spawn(__file__, tmp_path, ["masks"]):
        for name in ("masks_own_cards", "masks_sharing_a_card_refused",
                     "masks_one_split"):
            assert f"PASS {name}\n" in out, out


def test_jax_rungs_on_cpu_shards(tmp_path):
    """2 ranks of 2 CPU shards: the runner's dumps match the JAX
    runner's, and the JAX 2-process x 2-device checkpoint loads onto the
    shards' devices and resumes to the JAX run's dump."""
    for out in td.spawn(__file__, tmp_path, ["jax_cpu"]):
        for name in ("jax_resumed_devices", "jax_resumed"):
            assert f"PASS {name}\n" in out, out
    _match_jax(tmp_path)


def test_committed_jax_references_are_the_jax_packages(tmp_path):
    """``tests/data/jax_2x2`` holds what the JAX package gives now: every
    array equal, a visibility set at least within ``tdr``'s tolerance."""
    write_jax_references(str(tmp_path))
    names = sorted(os.listdir(DATA))
    assert names == sorted(os.listdir(tmp_path)) == [
        "jax_state.proc0of2.npz", "jax_state.proc1of2.npz",
        "jax_straight.npy", "runner_vis.npy"]
    for name in names:
        old, new = np.load(os.path.join(DATA, name)), np.load(tmp_path / name)
        pairs = ([(k, old[k], new[k]) for k in old.files]
                 if name.endswith(".npz") else [(name, old, new)])
        if name.endswith(".npz"):
            assert sorted(old.files) == sorted(new.files)
        for key, a, b in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, key
            assert np.array_equal(a, b) or (
                "vis" in key or key == "jax_straight.npy") and \
                _close_to_jax(a, b), key


@pytest.fixture
def cards():
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs 2 or more NVIDIA cards, {n} present")
    return n


@pytest.mark.cuda
def test_kernels_across_cards_in_one_process(cards):
    """K7b (block, pitched) and K7a with every shard on a card of its own,
    one launch a card, bitwise their plain versions; the sums bitwise the
    one-card mesh."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            all_to_all_torch, build_mesh,
                                            psum, psum_scatter,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    n = 4 if cards >= 4 else 2
    devs = _cards(n)
    mesh = build_mesh(devs)
    sp = build_mesh(devs, time_shards=2)
    one = build_mesh(devs[:1] * n)
    rng = np.random.default_rng(5)
    for shape in ((8, 4, 5), (4096, 2, 64)):
        host = [torch.from_numpy(rng.integers(-127, 128, shape,
                                              dtype=np.int8))
                for _ in range(n)]
        xs = [x.to(d) for x, d in zip(host, devs)]
        for rows in (1, 4):
            before = all_to_all.launches
            got = all_to_all(xs, mesh, FX_AXIS, rows=rows, impl="cuda")
            want = all_to_all_torch(host, build_mesh(["cpu"] * n), FX_AXIS,
                                    rows=rows)
            assert all_to_all.launches == before + n
            assert all(g.device == d for g, d in zip(got, devs))
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        for axis in (TIME_AXIS, FX_AXIS):
            before = ring_permute_right.launches
            got = ring_permute_right(xs, sp, axis, impl="cuda")
            want = ring_permute_right_torch(
                host, build_mesh(["cpu"] * n, time_shards=2), axis)
            assert ring_permute_right.launches == before + n
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    floats = [torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
              for _ in range(n)]
    for op in (psum, psum_scatter):
        got = op([f.to(d) for f, d in zip(floats, devs)], mesh, FX_AXIS)
        want = op([f.to(devs[0]) for f in floats], one, FX_AXIS)
        assert all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


@pytest.mark.cuda
def test_two_ranks_of_two_cards(cards, tmp_path):
    """2 ranks, each of 2 cards (needs 4): the kernels, the sums and the
    runner across them bitwise one process (:func:`_rank_card`); the
    runner's dumps against the JAX runner's, and the JAX 2-process x
    2-device checkpoint loaded onto the cards and resumed to the JAX
    run's dump (:func:`_jax_rungs`)."""
    if cards < 4:
        pytest.skip(f"needs 4 NVIDIA cards for 2 ranks of 2, {cards} present")
    names = ["cards"] + [f"a2a_{m}_{n}" for m in ("block", "pitched")
                         for n in (8, 4096)] + [
        f"ring_{a}_{n}" for a in ("time", "fx") for n in (8, 4096)] + [
        "psum", "psum_scatter", "runner_dumps", "jax_resumed_devices",
        "jax_resumed", "runner_resumed_cards", "runner_resumed"]
    for out in td.spawn(__file__, tmp_path, ["card"], timeout=600):
        for name in names:
            assert f"PASS {name}\n" in out, out
    _match_jax(tmp_path)


if __name__ == "__main__":
    if sys.argv[1:2] == ["jax-references"]:
        sys.path.insert(0, ROOT)
        os.environ["JAX_PLATFORMS"] = "cpu"
        write_jax_references(sys.argv[2])
        sys.exit(0)
    sys.exit(rank_main(sys.argv[1:]))
