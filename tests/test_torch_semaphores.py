"""The TPU kernels' DMA semaphores as device flags, K7b's schedule and the
CLI's default mesh across ranks.

On the CPU: K7b's pairs in the TPU kernel's symmetric schedule (at every
offset the senders of a group write into different receivers, the local
pair first and apart); the bookkeeping of the flag rounds
(:class:`~dc_sand_tpu_torch.parallel.ipc.FlagPlan`): which words each
card of each rank writes and waits for over many rounds of two roles,
with several cards a rank, ranks running ahead of each other and the
sequence wrapping; K7a's rounds paired with its ring (each card waits
only on its ring neighbours in other ranks, a pair inside a rank takes
no word, one writer a word, the ring the JAX mesh's ring step on the
same layout), mixed with node-wide rounds across the wrap; ``cli ... --distributed`` without ``--mesh`` building
one shard a device; the plain K7b and K7a across gloo ranks (one node,
and two nodes through the staged route's bookkeeping) against the JAX
package's kernels in interpret mode.

On the card (``cuda``, ``python -m pytest --noconftest
tests/test_torch_semaphores.py -m cuda``; 2 ranks sharing one card, of
one card each on two, of two cards each on four): a thousand K7a rounds
with the kernel's own signal and no barrier, each receiver reading its
own round's value and never a stale one, and with two cards a rank a
time ring inside each rank that writes and waits on no flag; K7b and
K7a bitwise their plain versions, launched on the sender's card through
its own mappings.

Each rank of the multi-process cases runs this file's ``__main__`` branch
(gloo over a ``file://`` store), printing ``PASS <check>``.

    python tests/test_torch_semaphores.py STORE OUTDIR MODE   (a rank)
"""

import os
import random
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import test_torch_distributed as td  # noqa: E402

STRESS_ROUNDS = 1000
PLAIN_SHAPE = (8, 4, 5)       # 4 shards, 2 a rank: the collectives' inputs
PLAIN_ROWS = (1, 4)


def _mesh(ranks, cards, rank=0, time_shards=1, time_local=False):
    """The global mesh of ``ranks`` ranks of ``cards`` cards each, one
    shard a card, as ``build_global_mesh`` lays it out, built directly
    (``Mesh`` checks no card)."""
    import torch
    from dc_sand_tpu_torch.parallel import Mesh
    from dc_sand_tpu_torch.parallel.mesh import _layout
    n = ranks * cards
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cuda", i % cards) for i in range(n)]
    procs = np.repeat(np.arange(ranks), cards)
    return Mesh(_layout(devs, time_shards, time_local),
                _layout(procs, time_shards, time_local), rank)


# ---- K7b's schedule ---------------------------------------------------------

@pytest.mark.parametrize("ranks,cards,time_shards", [
    (1, 2, 1), (1, 3, 1), (1, 4, 1), (1, 8, 1), (1, 8, 2),
    (2, 2, 1), (4, 1, 1), (2, 4, 2),
])
def test_all_to_all_sends_form_a_latin_square(ranks, cards, time_shards):
    """Over every rank's senders: every (src, dst) of a group once; the
    sender at position p lists the receiver at p + j at offset j, its own
    block first; at every offset the group's senders write into
    different receivers; a card's pairs are its own senders'."""
    from dc_sand_tpu_torch.parallel import FX_AXIS, TIME_AXIS
    for axis in (FX_AXIS, TIME_AXIS):
        listed = {}
        for rank in range(ranks):
            mesh = _mesh(ranks, cards, rank, time_shards)
            flat = mesh.flat_devices
            for card, pairs in mesh.all_to_all_sends(axis):
                assert all(flat[i] == card and i in mesh.local_shards
                           for i, _ in pairs)
                for i, j in pairs:
                    listed.setdefault(i, []).append(j)
        for group in mesh.groups(axis):
            n = len(group)
            for p, src in enumerate(group):
                assert listed[src] == [group[(p + j) % n] for j in range(n)]
            for j in range(n):
                at_j = [listed[src][j] for src in group]
                assert sorted(at_j) == sorted(group)      # a Latin square
                assert all((dst == src) == (j == 0)
                           for src, dst in zip(group, at_j))


def test_remote_pairs_go_first_in_each_launch():
    """A card's launch takes its pairs to other cards first and those that
    stay on the card last, at most MAX_PEERS a launch, each kept in its
    order."""
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.parallel.remote_dma import _remote_first
    items = list(range(20))
    got = _remote_first(items, lambda x: x % 5 == 0)
    assert [len(c) for c in got] == [_build.MAX_PEERS, 4]
    assert got[0] == [x for x in items if x % 5][:_build.MAX_PEERS]
    assert got[1] == [0, 5, 10, 15]
    assert _remote_first([3], lambda x: True) == [[3]]


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (2, 3, 4)), ("int8", (5, 7)), ("complex64", (3,)),
])
def test_pointer_view_shares_the_memory(dtype, shape):
    """``ipc.pointer_view`` (how a peer's mapped buffer becomes a tensor
    on the card that mapped it) wraps the bytes at an address without a
    copy, on the device it is given: here the CPU's, read and written
    through the view; the capsule names a card's index as given."""
    import torch
    from dc_sand_tpu_torch.parallel.ipc import _dlpack, pointer_view
    dt = getattr(torch, dtype)
    base = torch.arange(int(np.prod(shape)) * 2, dtype=torch.float32)
    base = base.to(dt) if not dt.is_complex else base.view(dt)
    base = base[:int(np.prod(shape))].reshape(shape).clone()
    nbytes = base.numel() * base.element_size()
    view = pointer_view(base.data_ptr(), nbytes, torch.device("cpu"))
    view = view.view(dt).view(shape)
    assert view.device.type == "cpu" and view.data_ptr() == base.data_ptr()
    assert torch.equal(view, base)
    view.view(-1)[-1] = 0
    assert base.view(-1)[-1] == 0
    managed, _ = _dlpack(4096, nbytes, torch.device("cuda", 3))
    dl = managed.dl_tensor
    assert (dl.device.device_type, dl.device.device_id) == (2, 3)
    assert (dl.data, dl.ndim, dl.shape[0]) == (4096, 1, nbytes)
    assert (dl.dtype.code, dl.dtype.bits, dl.dtype.lanes) == (1, 8, 1)


def test_k7b_sizing_builds_one_library_a_shape(capsys):
    """The tile-shape bench keys a library by its shape and flags (the
    port's own build untouched), and without two cards exits 1 with no
    JSON."""
    import torch
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.bench import k7b_sizing
    paths = {s: k7b_sizing.variant_path(s) for s in k7b_sizing.SHAPES}
    assert len({p for p, _, _ in paths.values()}) == len(paths)
    so, flags, src = paths["512x8"]
    assert src.name == "remote_dma.cu" and so.parent == _build.build_dir()
    assert flags[-2:] == ("-DDCS_K7_THREADS=512", "-DDCS_K7_UNROLL=8")
    assert so.name.startswith("libremote_dma_512x8_")
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        pytest.skip("two cards present")
    assert k7b_sizing.main([]) == 1
    assert capsys.readouterr().out == ""


def test_k7a_launch_flags_carry_each_pairs_word():
    """The kernel's by-value signals carry each pair's flag, the counters
    and the round's number, and none without flags."""
    from dc_sand_tpu_torch.parallel.remote_dma import _ring_flags
    arg = _ring_flags(([4096, None, 8192], 64, 0xFFFFFFFF))
    assert list(arg.flag)[:4] == [4096, None, 8192, None]
    assert (arg.count, arg.value) == (64, 0xFFFFFFFF)
    empty = _ring_flags(None)
    assert not any(empty.flag) and not empty.count and empty.value == 0


# ---- the flag rounds --------------------------------------------------------

def _ahead(value: int, seq: int) -> bool:
    """The driver's ``CU_STREAM_WAIT_VALUE_GEQ``: ``(int32)(value - seq)
    >= 0``, a cyclic comparison."""
    return ((value - seq) & 0xFFFFFFFF) < 1 << 31


@pytest.mark.parametrize("ranks,cards,start", [
    (2, 1, 0), (4, 1, 0), (2, 2, 0), (3, 2, 0), (2, 2, 0xFFFFFFF0),
])
def test_flag_rounds_bookkeeping(ranks, cards, start):
    """Ranks of ``cards`` cards each, two roles, 400 rounds of both kinds
    in one order on every rank, the ranks stepping in a random
    interleaving (one may run rounds ahead): every word has one writer;
    a card waits on every peer card's word of the kind and on no one
    else's; the ranks number each kind's rounds alike; a wait passes
    exactly when every peer card has signalled that round or a later
    one, never on an earlier round's value, across the sequence's
    wrap."""
    from dc_sand_tpu_torch.parallel.ipc import CONSUMED, SENT, FlagPlan
    roles = 2
    plans = [[FlagPlan([cards] * ranks, r, [p for p in range(ranks)
                                            if p != r])
              for r in range(ranks)] for _ in range(roles)]
    width = ranks * cards
    for role in plans:
        for plan in role:
            plan.seq = [start, start]
        for which in (CONSUMED, SENT):
            owner = {}
            for r, plan in enumerate(role):
                for k in range(cards):
                    for peer, c, word in plan.signals(which, k):
                        assert peer != r and 0 <= word < 2 * width
                        owner.setdefault((peer, c, word), set()).add((r, k))
                        assert word == plan.slot(which, r, k)
                assert len(plan.waits(which)) == (ranks - 1) * cards
            # each word of each card has exactly one writer
            assert all(len(w) == 1 for w in owner.values())
            for r, plan in enumerate(role):
                want = {role[p].slot(which, p, c) for p in range(ranks)
                        if p != r for c in range(cards)}
                assert set(plan.waits(which)) == want
    # the same order of rounds on every rank
    rng = random.Random(ranks * 10 + cards)
    ops = [(rng.randrange(roles), which) for _ in range(200)
           for which in (CONSUMED, SENT)]
    # the words as the rounds before ``start`` left them (a fresh buffer
    # is zeroed and the first round is 1)
    memory = np.full((roles, ranks, cards, 2 * width), start, dtype=np.uint64)
    signalled = np.full((roles, 2, ranks), 0, dtype=np.int64)  # rounds
    at = [0] * ranks                 # next op of each rank
    pending = [None] * ranks         # (role, which, seq) signalled
    while min(at) < len(ops):
        live = [r for r in range(ranks) if at[r] < len(ops)]
        r = rng.choice(live)
        role, which = ops[at[r]]
        plan = plans[role][r]
        if pending[r] is None:
            seq = plan.next(which)
            for k in range(cards):
                for peer, c, word in plan.signals(which, k):
                    memory[role, peer, c, word] = seq
            signalled[role, which, r] += 1
            pending[r] = (role, which, seq)
            continue
        seq = pending[r][2]
        passes = all(_ahead(int(memory[role, r, k, w]), seq)
                     for k in range(cards) for w in plan.waits(which))
        rounds = signalled[role, which, r]
        peers_done = all(signalled[role, which, p] >= rounds
                         for p in range(ranks) if p != r)
        assert passes == peers_done, (r, role, which, seq)
        stale = (seq - 1) & 0xFFFFFFFF
        assert not _ahead(stale, seq)
        if passes:
            pending[r] = None
            at[r] += 1
        elif all(pending[p] is not None and at[p] == at[r]
                 for p in live):
            raise AssertionError("every rank waits: a deadlock")
    for role in plans:
        for which in (CONSUMED, SENT):
            assert len({plan.seq[which] for plan in role}) == 1


# ---- K7a's rounds, paired with its ring --------------------------------------

# (ranks, cards a rank, time shards, time_local): phase 40's (b) and (c),
# 2 x 2 with the time axis across the ranks, and rings of 3 and 4 ranks
K7A_LAYOUTS = {"b": (4, 1, 2, True), "c": (2, 2, 2, True),
               "2x2": (2, 2, 2, False), "ring3": (3, 1, 3, False),
               "ring4": (4, 1, 4, False)}


def _k7a_ring(layout):
    """``(mesh of rank 0, the time ring's (sender, receiver) shards, each
    shard's (rank, card), the JAX mesh's ring step as (rank, card)
    pairs)``: the JAX package's mesh over as many CPU devices, laid out
    alike, its device i standing for card ``i mod cards`` of rank ``i //
    cards`` (the global device order)."""
    import jax
    from dc_sand_tpu.parallel.mesh import build_mesh
    from dc_sand_tpu_torch.parallel import TIME_AXIS
    from dc_sand_tpu_torch.parallel.ipc import shard_places
    ranks, cards, t, local = layout
    mesh = _mesh(ranks, cards, 0, t, local)
    ring = tuple(p for _, ps in _all_ring_sends(layout) for p in ps)
    assert sorted(ring) == sorted(
        (g[k], g[(k + 1) % len(g)]) for g in mesh.groups(TIME_AXIS)
        for k in range(len(g)))
    devs = jax.devices("cpu")[:ranks * cards]
    jm = build_mesh(devices=devs, time_shards=t, time_local=local)
    index = {d.id: i for i, d in enumerate(devs)}
    grid = np.vectorize(lambda d: index[d.id])(jm.devices)
    jax_pairs = {(divmod(int(grid[tt, f]), cards),
                  divmod(int(grid[(tt + 1) % t, f]), cards))
                 for tt in range(t) for f in range(grid.shape[1])}
    return mesh, ring, shard_places(mesh), jax_pairs


def _all_ring_sends(layout):
    """Every rank's ``Mesh.ring_sends`` over the time axis."""
    from dc_sand_tpu_torch.parallel import TIME_AXIS
    ranks, cards, t, local = layout
    return [s for r in range(ranks)
            for s in _mesh(ranks, cards, r, t, local).ring_sends(TIME_AXIS)]


@pytest.mark.parametrize("layout", sorted(K7A_LAYOUTS))
def test_k7a_rounds_pair_with_the_ring(layout):
    """K7a's flag rounds (``FlagPlan.paired``) on each rank of the
    layout: its ring is the JAX mesh's ring step on the same layout,
    mapped through the devices; each card waits, in a ``consumed`` round,
    on exactly the words of its receivers in other ranks and, in a
    ``sent`` round, on those of its senders in other ranks; a pair inside
    a rank takes no word (a ring inside each rank, none at all); every
    word has one writer, and every word written is one its card waits
    on."""
    from dc_sand_tpu_torch.parallel.ipc import CONSUMED, SENT, FlagPlan
    ranks, cards, _, _ = K7A_LAYOUTS[layout]
    mesh, ring, places, jax_pairs = _k7a_ring(K7A_LAYOUTS[layout])
    assert {(places[i], places[j]) for i, j in ring} == jax_pairs
    plans = [FlagPlan([cards] * ranks, r, [p for p in range(ranks)
                                           if p != r]) for r in range(ranks)]
    for which in (CONSUMED, SENT):
        writers, waited = {}, set()
        for r, plan in enumerate(plans):
            signals, waits = plan.paired(which, ring, places.__getitem__)
            want = {}
            for (ri, ci), (rj, cj) in jax_pairs:
                if ri == rj:
                    continue
                if which == CONSUMED and ri == r:      # a sender waits
                    want.setdefault(ci, set()).add(plan.slot(which, rj, cj))
                if which == SENT and rj == r:          # a receiver waits
                    want.setdefault(cj, set()).add(plan.slot(which, ri, ci))
            assert {k: set(v) for k, v in waits.items()} == want
            waited |= {(r, k, w) for k, ws in waits.items() for w in ws}
            for k, sig in signals.items():
                for peer, c, word in sig:
                    assert peer != r and word == plan.slot(which, r, k)
                    writers.setdefault((peer, c, word), set()).add((r, k))
        assert all(len(w) == 1 for w in writers.values())
        assert set(writers) == waited
        if all(ri == rj for (ri, _), (rj, _) in jax_pairs):
            assert not writers and not waited


def _run_rounds(plans, places, ops, needs, start, seed) -> None:
    """Step the ranks' rounds ``ops`` (``(paired pairs or None, kind)``,
    ``places`` each shard's rank and card)
    in a random interleaving, writing each round's words into a model of
    every card's flag buffer, and check each wait: it passes exactly when
    every writer in ``needs(r, pairs, kind)`` has signalled this round or
    a later one, and never on an earlier round's value."""
    ranks, width = len(plans), plans[0].width
    cards = plans[0].counts[0]
    for plan in plans:
        plan.seq = [start, start]
    memory = np.full((ranks, cards, 2 * width), start, dtype=np.uint64)
    signalled = np.zeros((2, ranks), dtype=np.int64)
    rng = random.Random(seed)
    at, pending = [0] * ranks, [None] * ranks
    while min(at) < len(ops):
        live = [r for r in range(ranks) if at[r] < len(ops)]
        r = rng.choice(live)
        pairs, which = ops[at[r]]
        plan = plans[r]
        if pairs is None:
            signals = {k: plan.signals(which, k) for k in range(cards)}
            waits = {k: plan.waits(which) for k in range(cards)}
        else:
            signals, waits = plan.paired(which, pairs, places.__getitem__)
        if pending[r] is None:
            seq = plan.next(which)
            for sig in signals.values():
                for peer, c, word in sig:
                    memory[peer, c, word] = seq
            signalled[which, r] += 1
            pending[r] = seq
            continue
        seq = pending[r]
        passes = all(_ahead(int(memory[r, k, w]), seq)
                     for k, ws in waits.items() for w in ws)
        rounds = signalled[which, r]
        done = all(signalled[which, p] >= rounds
                   for p in needs(r, pairs, which))
        assert passes == done, (r, which, seq)
        if passes:
            pending[r] = None
            at[r] += 1
        elif all(pending[p] is not None and at[p] == at[r] for p in live):
            raise AssertionError("every rank waits: a deadlock")
    for which in (0, 1):
        assert len({plan.seq[which] for plan in plans}) == 1


@pytest.mark.parametrize("layout,start", [
    ("b", 0xFFFFFFF0), ("ring3", 0xFFFFFFF0), ("2x2", 0), ("c", 7)])
def test_k7a_paired_rounds_across_the_wrap(layout, start):
    """K7a's paired rounds mixed with node-wide rounds (K7b's, the sums')
    of one role, 120 rounds in one order on every rank, the ranks
    stepping in a random interleaving across the sequence's wrap: a
    paired wait passes exactly when the ring neighbours it needs have
    signalled that round (a node-wide one when every peer has), so the
    numbering stays aligned though a paired round skips the other
    ranks."""
    from dc_sand_tpu_torch.parallel.ipc import CONSUMED, SENT, FlagPlan
    ranks, cards, _, _ = K7A_LAYOUTS[layout]
    _, ring, places, jax_pairs = _k7a_ring(K7A_LAYOUTS[layout])
    plans = [FlagPlan([cards] * ranks, r, [p for p in range(ranks)
                                           if p != r]) for r in range(ranks)]
    rng = random.Random(ranks * 7 + cards)
    ops = [(ring if rng.random() < 0.6 else None, which)
           for _ in range(60) for which in (CONSUMED, SENT)]

    def needs(r, pairs, which):
        if pairs is None:
            return [p for p in range(ranks) if p != r]
        # consumed: my receivers write; sent: my senders write
        return sorted({(ri if which == SENT else rj)
                       for (ri, _), (rj, _) in jax_pairs if ri != rj
                       and (rj if which == SENT else ri) == r})

    _run_rounds(plans, places, ops, needs, start, ranks + cards)


# ---- the ranks --------------------------------------------------------------

def _rank_cli(check, info, outdir, rank):
    """``cli run fx4 --cpu --distributed`` without ``--mesh`` on ranks
    whose ``local_cards`` reports 2 cards: the CLI's mesh has
    ``global_devices`` (4) shards, 2 a rank, and its dumps are the
    one-process 4-shard mesh's (written for the test to compare)."""
    from unittest import mock
    import torch
    import dc_sand_tpu_torch.parallel as par
    from dc_sand_tpu_torch import cli
    from dc_sand_tpu_torch.parallel import distributed
    real_init, real_build = distributed.init_distributed, \
        par.build_global_mesh
    built = []

    def init(*args, **kw):
        two = [torch.device("cuda", 2 * rank + k) for k in range(2)]
        with mock.patch.object(torch.cuda, "is_available", lambda: True), \
                mock.patch.object(distributed, "local_cards",
                                  lambda *a, **k: two):
            got = real_init(*args, **kw)
        check("cli_counts", got["local_devices"] == 2
              and got["global_devices"] == 4)
        return got

    def build(*args, **kw):
        built.append(real_build(*args, **kw))
        return built[-1]

    with mock.patch.object(distributed, "init_distributed", init), \
            mock.patch.object(par, "build_global_mesh", build):
        rc = cli.main(["run", "fx4", "--cpu", "--scale", "32", "--chunks",
                       "2", "--distributed"])
    check("cli_default_mesh", rc == 0 and len(built) == 1
          and built[0].size == 4 and len(built[0].local_shards) == 2)


def _rank_plain(check, info, outdir, rank):
    """K7b (block and pitched) and K7a's plain versions across the ranks,
    2 CPU shards a rank (one node: gloo; two nodes: the staged route's
    bookkeeping through SharedBuffers), each shard's output written for
    the test to hold against JAX."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, SharedBuffers,
                                            all_to_all, build_global_mesh,
                                            ring_permute_right,
                                            uses_shared_buffers)
    mesh = build_global_mesh(["cpu"] * 2)
    rng = np.random.default_rng(16)
    every = [rng.integers(-127, 128, PLAIN_SHAPE).astype(np.int8)
             for _ in range(mesh.size)]
    mine = [torch.from_numpy(every[d]) for d in mesh.local_shards]
    bufs = (SharedBuffers(mesh, PLAIN_SHAPE, torch.int8)
            if uses_shared_buffers(mesh) else None)
    for rows in PLAIN_ROWS:
        got = all_to_all(mine, mesh, FX_AXIS, rows=rows, out=bufs)
        for d, g in zip(mesh.local_shards, got):
            np.save(os.path.join(outdir, f"a2a{rows}_{d}.npy"), g.numpy())
    got = ring_permute_right(mine, mesh, FX_AXIS, out=bufs)
    for d, g in zip(mesh.local_shards, got):
        np.save(os.path.join(outdir, f"ring_{d}.npy"), g.numpy())
    check("plain_saved", True)


def _rank_stress(check, info, outdir, rank):
    """:data:`STRESS_ROUNDS` rounds of K7a over the fx ring of every
    rank's cards with no host barrier, each receiver's ``sent`` flag
    written by the sender's kernel: each round's blocks hold the round's
    number, and each receiver counts, on its stream, the words of its
    buffer that differ from it (a stale round's value would); one rank
    sleeps on the card now and then, so that the ranks drift.  With
    several cards a rank, then a time ring inside each rank (phase 40's
    layout (c)): bitwise its plain version, no flag written or waited
    on.  Before that, two shards of the first card into two of a peer's
    card, whose one ``sent`` word both launches' pairs share."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS,
                                            SharedBuffers,
                                            build_global_mesh,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.parallel.distributed import local_cards
    mesh = build_global_mesh(local_cards())
    shape = (1 << 16,)
    bufs = SharedBuffers(mesh, shape, torch.int32)
    xs = [torch.empty(shape, dtype=torch.int32, device=d)
          for d in mesh.local_devices]
    bad = [torch.zeros((), dtype=torch.int64, device=d)
           for d in mesh.local_devices]
    rng = random.Random(rank)
    b0, f0 = SharedBuffers.barriers, SharedBuffers.flag_rounds
    for r in range(1, STRESS_ROUNDS + 1):
        for x in xs:
            x.fill_(r)
        if rank == 0 and rng.random() < 0.1:
            torch.cuda._sleep(rng.randrange(1, 200000))
        got = ring_permute_right(xs, mesh, FX_AXIS, out=bufs, impl="cuda")
        for b, g in zip(bad, got):
            b += (g != r).sum()
    for d in mesh.local_cards:
        torch.cuda.synchronize(d)
    check("stress_no_stale_value", all(int(b) == 0 for b in bad))
    bufs.check_signals()
    check("stress_signals_landed", True)
    check("stress_no_barrier", SharedBuffers.barriers == b0
          and SharedBuffers.flag_rounds - f0 == 2 * STRESS_ROUNDS)
    # two shards of a card into two of one peer card (phase 33's SP mesh):
    # both pairs write one word, which the kernel writes once both landed
    two = build_global_mesh([mesh.local_cards[0]] * 2, time_shards=2)
    grouped = SharedBuffers(two, shape, torch.int32)
    ys = [torch.empty(shape, dtype=torch.int32, device=d)
          for d in two.local_devices]
    bad = torch.zeros((), dtype=torch.int64, device=two.local_devices[0])
    for r in range(1, STRESS_ROUNDS // 10 + 1):
        for d, y in zip(two.local_shards, ys):
            y.fill_(10 * r + d)
        got = ring_permute_right(ys, two, TIME_AXIS, out=grouped,
                                 impl="cuda")
        want = ring_permute_right_torch(ys, two, TIME_AXIS)
        for g, w in zip(got, want):
            bad += (g != w).sum()
    grouped.check_signals()
    check("stress_grouped_word", int(bad) == 0
          and max(grouped.waited.values()) == 2 * STRESS_ROUNDS // 10)
    if len(mesh.local_cards) == 1:
        return
    sp = build_global_mesh(local_cards(), time_shards=2, time_local=True)
    halo = SharedBuffers(sp, shape, torch.int32)
    f0, h0 = SharedBuffers.flag_rounds, ring_permute_right.flag_rounds
    same = True
    for r in range(1, 11):
        ys = [torch.full(shape, 1000 * r + d, dtype=torch.int32, device=dev)
              for d, dev in zip(sp.local_shards, sp.local_devices)]
        got = ring_permute_right(ys, sp, TIME_AXIS, out=halo, impl="cuda")
        want = ring_permute_right_torch(ys, sp, TIME_AXIS)
        for dev in sp.local_cards:
            torch.cuda.synchronize(dev)
        same = same and all(torch.equal(g, w) for g, w in zip(got, want))
    check("inside_ranks_no_flag", same and halo.flagged_rounds == 0
          and SharedBuffers.flag_rounds == f0
          and ring_permute_right.flag_rounds == h0
          and not any(halo.waited.values()))


def _rank_schedules(check, info, outdir, rank):
    """K7b (block and pitched) and K7a over the ranks' cards, bitwise
    their plain versions, one launch a card; each card that writes into
    a peer's shard writes through a mapping of its own context (the
    readers' view of it lies on one of them), and no host barrier orders
    them."""
    import torch
    from dc_sand_tpu_torch.parallel import (FX_AXIS, SharedBuffers,
                                            all_to_all, all_to_all_torch,
                                            build_global_mesh,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.parallel.distributed import local_cards
    mesh = build_global_mesh(local_cards())
    cards = mesh.local_cards
    rng = np.random.default_rng(17)
    b0 = SharedBuffers.barriers

    def same(got, want):
        for c in cards:
            torch.cuda.synchronize(c)
        return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))

    for shape in ((8 * mesh.size, 4, 5), (1024 * mesh.size, 2, 64)):
        every = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(mesh.size)]
        mine = [torch.from_numpy(every[d]).to(dev)
                for d, dev in zip(mesh.local_shards, mesh.local_devices)]
        bufs = SharedBuffers(mesh, shape, torch.int8)
        for rows in (1, 4):
            before = all_to_all.launches
            got = all_to_all(mine, mesh, FX_AXIS, rows=rows, out=bufs,
                             impl="cuda")
            launches = all_to_all.launches - before
            want = all_to_all_torch(mine, mesh, FX_AXIS, rows=rows)
            check(f"a2a_{rows}_{shape[0]}",
                  launches == len(cards) and same(got, want))
        before = ring_permute_right.launches
        got = ring_permute_right(mine, mesh, FX_AXIS, out=bufs, impl="cuda")
        want = ring_permute_right_torch(mine, mesh, FX_AXIS)
        check(f"ring_{shape[0]}", ring_permute_right.launches - before
              == len(cards) and same(got, want))
        peers = [d for d in range(mesh.size)
                 if mesh.process_of(d) != mesh.rank]
        want_maps = {(d, c) for d in peers for c in cards}
        check(f"sender_mappings_{shape[0]}", set(bufs._maps) == want_maps
              and all(bufs.views[d].device in cards
                      and bufs.views[d].data_ptr()
                      == bufs._maps[(d, bufs.views[d].device)]
                      for d in peers))
    check("schedules_no_barrier", SharedBuffers.barriers == b0)


def rank_main(argv) -> int:
    """One rank: ``STORE OUTDIR MODE``."""
    sys.path.insert(0, ROOT)
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import init_distributed
    store, outdir, mode = argv
    if mode == "cli":            # the CLI joins from the environment
        rank = int(os.environ["RANK"])
    else:
        rank = init_distributed(
            init_method=f"file://{store}")["process_index"]
        if mode in ("stress", "schedules"):
            import torch
            from dc_sand_tpu_torch.parallel.distributed import local_cards
            torch.cuda.set_device(local_cards()[0])

    def check(name, ok):
        if not ok:
            raise AssertionError(f"rank {rank}: {name} failed")
        print(f"PASS {name}", flush=True)

    {"cli": _rank_cli, "plain": _rank_plain, "stress": _rank_stress,
     "schedules": _rank_schedules}[mode](check, None, outdir, rank)
    ipc.close_all()
    return 0


# ---- the tests --------------------------------------------------------------

def test_cli_distributed_default_mesh_is_one_shard_a_device(tmp_path):
    """2 gloo ranks whose ``local_cards`` reports 2 cards each: ``cli run
    fx4 --cpu --distributed`` without ``--mesh`` builds the mesh of
    ``global_devices`` (4) shards, 2 a rank, as the JAX CLI builds one
    over every global device."""
    for out in td.spawn(__file__, tmp_path, ["cli"]):
        for name in ("cli_counts", "cli_default_mesh"):
            assert f"PASS {name}\n" in out, out


@pytest.mark.parametrize("nodes", [None, 2])
def test_plain_collectives_across_ranks_match_jax(tmp_path, nodes):
    """K7b (block and pitched) and K7a's plain versions across 2 gloo
    ranks of 2 CPU shards, on one node and on two (the staged route's
    bookkeeping), bitwise JAX's Pallas kernels in interpret mode over a
    4-device mesh on the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh, PartitionSpec as P
    from dc_sand_tpu.parallel.remote_dma import (all_to_all_pallas,
                                                 ring_permute_right)
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    for out in td.spawn(__file__, tmp_path, ["plain"], nodes=nodes):
        assert "PASS plain_saved\n" in out, out
    n = 4
    rng = np.random.default_rng(16)
    every = [rng.integers(-127, 128, PLAIN_SHAPE).astype(np.int8)
             for _ in range(n)]
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n]), ("fx",))

    def sharded(fn, x):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(P("fx"),), out_specs=P("fx"),
            check_vma=False))(jnp.asarray(x)))

    def saved(name):
        return np.concatenate([np.load(tmp_path / f"{name}_{d}.npy")
                               for d in range(n)])

    x = np.concatenate(every)
    for rows in PLAIN_ROWS:
        # the pitched mode is the block mode on each block's rows, each
        # receiver interleaving its senders' rows
        blocks = x.reshape(n, n, rows, -1)
        want = sharded(lambda xl: all_to_all_pallas(
            xl, "fx", ("fx",), interpret=True),
            blocks.reshape(n * n * rows, -1)).reshape(n, n, rows, -1)
        want = want.transpose(0, 2, 1, 3).reshape(x.shape)
        np.testing.assert_array_equal(saved(f"a2a{rows}"), want)
    want = sharded(lambda xl: ring_permute_right(
        xl, "fx", ("fx",), interpret=True), x)
    np.testing.assert_array_equal(saved("ring"), want)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("visible,need", [("0", 1), ("0,1", 2),
                                          ("0,1,2,3", 4)])
def test_flags_thousand_rounds_without_a_barrier(card, tmp_path, visible,
                                                  need):
    """2 ranks sharing one card, of one card each (two cards shown), and
    of two cards each (four): a thousand K7a rounds ordered by the device
    flags alone, each ``sent`` flag written by the kernel, each receiver
    reading its own round's value and never a stale one; with two cards a
    rank also a time ring inside each rank that writes and waits on no
    flag; and two shards of a card into two of one peer card, whose one
    word the kernel writes once both blocks landed."""
    if card < need:
        pytest.skip(f"needs {need} cards, {card} present")
    for out in td.spawn(__file__, tmp_path, ["stress"], timeout=600,
                        env={"CUDA_VISIBLE_DEVICES": visible}):
        names = ["stress_no_stale_value", "stress_signals_landed",
                 "stress_no_barrier", "stress_grouped_word"]
        names += ["inside_ranks_no_flag"] if need == 4 else []
        for name in names:
            assert f"PASS {name}\n" in out, out


@pytest.mark.cuda
def test_k7b_and_k7a_on_the_senders_cards(card, tmp_path):
    """2 ranks: K7b and K7a bitwise their plain versions, one launch a
    card on the sender's card, the mappings a writing card opens (the
    readers' views among them), and no host barrier."""
    for out in td.spawn(__file__, tmp_path, ["schedules"], timeout=600):
        lines = out.splitlines()
        assert "PASS schedules_no_barrier" in lines, out
        for name in ("sender_mappings", "ring", "a2a_1", "a2a_4"):
            assert sum(ln.startswith(f"PASS {name}_") for ln in lines) == 2, \
                out


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]))
