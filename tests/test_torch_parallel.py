"""The port's mesh and collectives against the JAX package's.

The plain versions of the peer-copy kernels K7a (ring step) and K7b
(all-to-all) are held bitwise to the JAX package's Pallas kernels in
interpret mode on a flat 4-device CPU mesh and to the XLA collectives;
the corner-turn and the halo exchange to JAX's; the sums over an axis to
``lax.psum``/``lax.psum_scatter``; Stokes to ``dc_sand_tpu.ops.stokes``.
The port's shards are a list of CPU tensors (``build_mesh(["cpu"] *
4)``), the JAX shards the blocks of a ``shard_map`` over the same global
array, made from one numpy seed."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from dc_sand_tpu.ops.stokes import stokes as jax_stokes
from dc_sand_tpu.parallel import (FX_AXIS as J_FX, TIME_AXIS as J_TIME,
                                  corner_turn_all_to_all as jax_corner_turn,
                                  halo_exchange_left as jax_halo)
from dc_sand_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dc_sand_tpu.parallel.remote_dma import (all_to_all_pallas,
                                             ring_permute_right as jax_ring)
from dc_sand_tpu_torch.ops.stokes import stokes
from dc_sand_tpu_torch.ops.xcorr import wire_to_a2, wire_to_operand
from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                        build_mesh, corner_turn_all_to_all,
                                        halo_exchange_left, psum,
                                        psum_scatter, ring_permute_right,
                                        ring_permute_right_torch)

try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

D = 4


def _flat(name, n=D):
    return JaxMesh(np.array(jax.devices("cpu")[:n]), (name,))


def _jax_sharded(fn, name, x, spec_in, spec_out, n=D):
    """``fn`` under shard_map over a flat n-device mesh on axis ``name``;
    returns the global result as numpy."""
    mesh = _flat(name, n)
    return np.asarray(jax.jit(shard_map_fn(
        fn, mesh=mesh, in_specs=(spec_in,), out_specs=spec_out,
        check_vma=False))(jnp.asarray(x)))


def _shards(x, axis=0, n=D):
    return [torch.from_numpy(np.ascontiguousarray(b))
            for b in np.split(x, n, axis=axis)]


def _cat(xs, axis=0):
    return np.concatenate([x.numpy() for x in xs], axis=axis)


def _data(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_all_to_all_plain_bitwise_equals_pallas_and_xla(dtype):
    """K7b's plain version == JAX's direct-send Pallas kernel (interpret
    mode) == ``lax.all_to_all(split_axis=concat_axis=0, tiled=True)``."""
    x = _data(dtype, (D * 8, 3, 5), 1)           # D shards of (8, 3, 5)
    spec = P(J_FX)
    pal = _jax_sharded(lambda xl: all_to_all_pallas(
        xl, J_FX, (J_FX,), interpret=True), J_FX, x, spec, spec)
    xla = _jax_sharded(lambda xl: jax.lax.all_to_all(
        xl, J_FX, 0, 0, tiled=True), J_FX, x, spec, spec)
    got = _cat(all_to_all(_shards(x), build_mesh(["cpu"] * D), FX_AXIS))
    np.testing.assert_array_equal(pal, xla)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_ring_plain_bitwise_equals_pallas_and_xla(dtype):
    """K7a's plain version == JAX's Pallas ring kernel (interpret mode) ==
    ``lax.ppermute`` over the full ring."""
    x = _data(dtype, (2, D * 16), 2)            # D shards of (2, 16)
    spec = P(None, J_TIME)
    pal = _jax_sharded(lambda xl: jax_ring(
        xl, J_TIME, (J_TIME,), interpret=True), J_TIME, x, spec, spec)
    ring = [(i, (i + 1) % D) for i in range(D)]
    xla = _jax_sharded(lambda xl: jax.lax.ppermute(xl, J_TIME, ring),
                       J_TIME, x, spec, spec)
    mesh = build_mesh(["cpu"] * D, time_shards=D)
    got = _cat(ring_permute_right(_shards(x, 1), mesh, TIME_AXIS), 1)
    np.testing.assert_array_equal(pal, xla)
    np.testing.assert_array_equal(got, pal)


def test_collectives_act_within_each_group_of_a_2d_mesh():
    """On a (time 2, fx 2) mesh each op moves data only among the shards
    that share the other axis's coordinate, as ``shard_map`` does."""
    mesh = build_mesh(["cpu"] * 4, time_shards=2)
    xs = [torch.full((2, 3), float(d)) for d in range(4)]
    ring_t = ring_permute_right(xs, mesh, TIME_AXIS)
    assert [int(r[0, 0]) for r in ring_t] == [2, 3, 0, 1]
    ring_f = ring_permute_right(xs, mesh, FX_AXIS)
    assert [int(r[0, 0]) for r in ring_f] == [1, 0, 3, 2]
    a2a = all_to_all(xs, mesh, FX_AXIS)
    assert [r[:, 0].tolist() for r in a2a] == [[0, 1], [0, 1], [2, 3],
                                               [2, 3]]
    assert [r.tolist() for r in psum(xs, mesh, TIME_AXIS)] == [
        [[2.0] * 3] * 2, [[4.0] * 3] * 2] * 2


@pytest.mark.parametrize("n,time_shards,cards", [
    (4, 4, 1), (4, 2, 1), (4, 2, 2), (4, 2, 4), (16, 4, 1), (16, 16, 4),
    (16, 1, 16)])
def test_ring_sender_grouping_covers_every_shard_once(n, time_shards, cards):
    """The (source, destination) pairs the ring wrapper hands each card
    (``Mesh.ring_sends``; CPU devices ``cpu:i`` stand for the cards): one
    entry per card that holds a sender, every shard a source once and a
    destination once, each source on its entry's card, and the pairs move
    the blocks as the plain version does, on both axes."""
    devs = [f"cpu:{i % cards}" for i in range(n)]
    mesh = build_mesh(devs, time_shards=time_shards)
    xs = [torch.full((2, 3), float(d)) for d in range(n)]
    for axis in (TIME_AXIS, FX_AXIS):
        sends = mesh.ring_sends(axis)
        assert sends is mesh.ring_sends(axis)            # computed once
        assert len(sends) == len({d for d, _ in sends}) == cards
        pairs = [pr for _, prs in sends for pr in prs]
        assert sorted(s for s, _ in pairs) == list(range(n))
        assert sorted(d for _, d in pairs) == list(range(n))
        for dev, prs in sends:
            assert all(mesh.flat_devices[s] == dev for s, _ in prs)
        want = ring_permute_right_torch(xs, mesh, axis)
        moved = [None] * n
        for s, d in pairs:
            moved[d] = xs[s]
        for m, w in zip(moved, want):
            assert torch.equal(m, w)
    # the whole 4-shard ring on one card, and both rings of a (2, 2) mesh,
    # are one launch's worth of pairs
    if cards == 1:
        assert len(mesh.ring_sends(TIME_AXIS)) == 1


@pytest.mark.parametrize("n", [1, 2, 4])
def test_corner_turn_bitwise_equals_jax(n):
    """Each shard's CMAC operand, from operand-layout shards ``(K, 2,
    s_local, b)`` through K7b's pitched mode, equals ``wire_to_a2`` of its
    block of JAX's corner-turn (XLA's and the Pallas route's, equal)."""
    a, pol, b, k = 8, 2, 3, 64
    q = _data(np.int8, (a, pol, b, k, 2), 3)
    want = _jax_sharded(lambda ql: jax_corner_turn(ql, J_FX), J_FX, q,
                        P(J_FX), P(None, None, None, J_FX), n)
    pal = _jax_sharded(lambda ql: jax_corner_turn(
        ql, J_FX, impl="pallas", axis_names=(J_FX,), interpret=True), J_FX,
        q, P(J_FX), P(None, None, None, J_FX), n)
    np.testing.assert_array_equal(pal, want)
    mesh = build_mesh(["cpu"] * n)
    shards = [wire_to_operand(x.reshape(-1, b, k, 2))
              for x in _shards(q, n=n)]
    a2 = corner_turn_all_to_all(shards, mesh)
    for i, blk in enumerate(np.split(want, n, axis=3)):
        ref = wire_to_a2(torch.from_numpy(np.ascontiguousarray(
            blk.reshape(a * pol, b, k // n, 2))))
        assert torch.equal(a2[i], ref)
    if n > 1:
        with pytest.raises(ValueError, match="channels"):
            corner_turn_all_to_all([x[1:].contiguous() for x in shards],
                                   mesh)


def test_halo_exchange_bitwise_equals_jax():
    x = _data(np.int8, (2, 3, D * 32), 4)
    spec = P(None, None, J_TIME)
    want = _jax_sharded(lambda xl: jax_halo(xl, 8, J_TIME), J_TIME, x, spec,
                        spec)
    mesh = build_mesh(["cpu"] * D, time_shards=D)
    got = halo_exchange_left(_shards(x, 2), 8, mesh)
    np.testing.assert_array_equal(_cat(got, 2), want)
    assert not _cat(got, 2)[..., :8].any()            # shard 0 cold start
    with pytest.raises(ValueError, match="halo"):
        halo_exchange_left(_shards(x, 2), 33, mesh)


def test_psum_and_psum_scatter_match_jax():
    """Float32 sums in shard order against XLA's: equal to float32
    rounding (the two may add in other orders); the scattered blocks equal
    the all-reduced tensor's slices bitwise."""
    x = _data(np.float32, (D * 8, 6, 5), 5)
    spec = P(J_FX)
    want = _jax_sharded(lambda xl: jax.lax.psum(xl, J_FX), J_FX, x, spec,
                        spec)
    want_sc = _jax_sharded(lambda xl: jax.lax.psum_scatter(
        xl, J_FX, scatter_dimension=0, tiled=True), J_FX, x, spec, spec)
    mesh = build_mesh(["cpu"] * D)
    summed = psum(_shards(x), mesh, FX_AXIS)
    scattered = psum_scatter(_shards(x), mesh, FX_AXIS)
    for i in range(D):
        np.testing.assert_allclose(summed[i].numpy(),
                                   np.split(want, D)[i], rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(scattered[i], summed[0][2 * i:2 * i + 2])
    np.testing.assert_allclose(_cat(scattered), want_sc, rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="scatter"):
        psum_scatter(_shards(x), mesh, FX_AXIS, dim=2)


def test_stokes_matches_jax():
    beams = _data(np.float32, (3, 2, 5, 7, 2), 6) * 30
    np.testing.assert_allclose(
        stokes(torch.from_numpy(beams)).numpy(),
        np.asarray(jax_stokes(jnp.asarray(beams))), rtol=1e-6, atol=1e-3)
    with pytest.raises(ValueError, match="dual-pol"):
        stokes(torch.from_numpy(beams[:, :1]))


def test_build_mesh_layout_matches_jax():
    """The (time, fx) arrangement of the devices is the JAX package's
    default, time-major one."""
    jdev = jax.devices("cpu")[:8]
    for ts in (1, 2, 4, 8):
        jm = jax_build_mesh(devices=jdev, time_shards=ts)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        m = build_mesh([f"cpu:{i}" for i in range(8)], time_shards=ts)
        assert m.shape == dict(jm.shape)
        got = np.vectorize(lambda d: d.index)(m.devices)
        np.testing.assert_array_equal(got, ids - ids.min())


def test_build_mesh_accepts_repeats_and_refuses_the_rest():
    m = build_mesh(["cpu"] * 6, time_shards=2)
    assert m.shape == {TIME_AXIS: 2, FX_AXIS: 3} and m.size == 6
    assert m.groups(TIME_AXIS) == [[0, 3], [1, 4], [2, 5]]
    assert m.coords(4) == (1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh(["cpu"] * 6, time_shards=4)
    with pytest.raises(ValueError, match="at least one"):
        build_mesh([])
    with pytest.raises(ValueError, match="axis"):
        m.groups("beam")


def test_collectives_refuse_mismatched_shards():
    mesh = build_mesh(["cpu"] * 2)
    a = torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="shape and dtype"):
        all_to_all([a, a.float()], mesh, FX_AXIS)
    with pytest.raises(ValueError, match="shards for a mesh"):
        ring_permute_right([a], mesh, FX_AXIS)
    with pytest.raises(ValueError, match="divisible"):
        all_to_all([a[:3], a[:3]], mesh, FX_AXIS)
