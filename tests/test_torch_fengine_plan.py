"""The fused F-engine kernel's FFT plan (``csrc/fengine.cu``), modelled in
PyTorch (``ops/fengine_fused.py:fft_plan_torch``: the radix order, the
twiddle table indices, the Stockham addressing and the in-register DFT's
stages) and held to ``torch.fft.rfft`` in float64, so that an index error
shows on the CPU before it reaches the card; and the persistent CTAs'
walk over the tiles (``k1_tiles``), held to cover every tile once."""

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.ops.fengine_fused import (K1_CLUSTER, K1_TILE,
                                                 fft_plan, fft_plan_torch,
                                                 k1_grid, k1_l2_bytes,
                                                 k1_tiles, _tables_np)

THREADS = 512   # csrc/fengine.cu: kThreads


@pytest.mark.parametrize("m", [32, 2048, 8192])
def test_plan_model_matches_rfft(m):
    """The model of the kernel's real FFT (its float32 twiddle tables,
    computed in complex128) equals ``torch.fft.rfft`` without the Nyquist
    bin to 1e-6 of the largest bin: an index error is an error of order
    one."""
    y = torch.from_numpy(np.random.default_rng(m).normal(size=(3, m)) * 20)
    got = fft_plan_torch(y)
    want = torch.fft.rfft(y)[..., :m // 2]
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


@pytest.mark.parametrize("m", [2 ** e for e in range(5, 14)])
def test_plan_fits_the_kernel(m):
    """Every pass's butterflies of one spectrum divide the CTA's threads
    (a round of the in-place pass covers whole spectra), radices are 2..16
    with 16 first, the radices multiply to N, and the pass table holds
    exactly the twiddles the passes read."""
    n = m // 2
    plan = fft_plan(n)
    radices = [r for r, _, _ in plan]
    assert int(np.prod(radices)) == n
    assert all(r in (2, 4, 8, 16) for r in radices)
    assert all(r == 16 for r in radices[:-1])
    ns = 1
    for r, ns_p, _ in plan:
        assert ns_p == ns and THREADS % (n // r) == 0
        ns *= r
    need = sum((r - 1) * ns for r, ns, _ in plan if ns > 1)
    split, passes = _tables_np(m)
    assert split.shape == (n,) and passes.shape == (max(need, 1),)


@pytest.mark.parametrize("operand", [False, True])
@pytest.mark.parametrize("resident", [1, 15 * 8, 132, 264])
@pytest.mark.parametrize("streams,b", [(1, 1), (1, 19), (6, 19), (4, 256),
                                       (3, 2040), (128, 2048)])
def test_persistent_walk_covers_every_tile_once(operand, resident, streams,
                                                b):
    """The persistent kernel's walk at the grid it launches with when the
    card holds ``resident`` CTAs: every (stream, tile) exactly once, no CTA
    idle, steps balanced to one; in the operand layout the grid is whole
    clusters (none when the card holds fewer than 8 CTAs), a cluster's CTAs
    take consecutive tiles of one stream in the same number of steps, and
    the only tiles past B are the padding of a stream's last group."""
    grid = k1_grid(streams, b, resident, operand)
    tiles = -(-b // K1_TILE)
    if operand and resident < K1_CLUSTER:
        assert grid == 0
        with pytest.raises(ValueError, match="whole clusters"):
            k1_tiles(streams, b, grid, operand)
        return
    walk = k1_tiles(streams, b, grid, operand)
    assert len(walk) == grid and all(walk)
    seen = [(s, j // K1_TILE) for steps in walk for s, j in steps if j < b]
    assert sorted(seen) == [(s, t) for s in range(streams)
                            for t in range(tiles)]
    if not operand:
        assert max(map(len, walk)) - min(map(len, walk)) <= 1
        return
    clusters = [walk[c:c + K1_CLUSTER] for c in range(0, grid, K1_CLUSTER)]
    assert max(len(c[0]) for c in clusters) - min(
        len(c[0]) for c in clusters) <= 1
    groups = -(-tiles // K1_CLUSTER)
    for cl in clusters:
        assert len({len(steps) for steps in cl}) == 1
        for i in range(len(cl[0])):
            s0, j0 = cl[0][i]
            assert j0 % (K1_CLUSTER * K1_TILE) == 0
            assert [cl[r][i] for r in range(K1_CLUSTER)] == [
                (s0, j0 + r * K1_TILE) for r in range(K1_CLUSTER)]
            if j0 + K1_CLUSTER * K1_TILE > b:   # the padding lies here only
                assert j0 // (K1_CLUSTER * K1_TILE) == groups - 1


@pytest.mark.parametrize("b,taps", [(2048, 16), (256, 16), (19, 4), (6, 1)])
def test_l2_bytes_counts_each_tile(b, taps):
    """The FIR's L2 bytes: each tile the whole window and its frames,
    counted tile by tile; fx64's chunk reads about 30.5 GB."""
    m, streams = 8192, 3
    want = 0
    for j in range(0, b, K1_TILE):
        n = min(K1_TILE, b - j)
        want += taps * m * 4 + (n + taps - 1) * m
    assert k1_l2_bytes(streams, b, m, taps) == streams * want
    if b == 2048:
        assert abs(k1_l2_bytes(128, b, m, taps) / 1e9 - 30.48) < 0.01


@pytest.mark.parametrize("operand", [False, True])
@pytest.mark.parametrize("resident", [8, 15 * 8, 132])
@pytest.mark.parametrize("streams,b", [(1, 1), (3, 13), (5, 36),
                                       (128, 256)])
def test_wide_walk_gives_each_tile_to_one_cluster(operand, resident,
                                                   streams, b):
    """At M = 65536 (either layout: the operand layout is the wire kernel's
    output transposed) the grid is whole clusters of 8 that the card holds,
    every CTA of a cluster walks the same tiles (each an eighth of their
    spectra), and the clusters take every (stream, tile) once, their steps
    balanced to one."""
    grid = k1_grid(streams, b, resident, operand, m=65536)
    assert grid % K1_CLUSTER == 0 and 0 < grid <= resident
    walk = k1_tiles(streams, b, grid, operand, m=65536)
    clusters = [walk[c:c + K1_CLUSTER] for c in range(0, grid, K1_CLUSTER)]
    assert all(steps == cl[0] for cl in clusters for steps in cl)
    seen = sorted(t for cl in clusters for t in cl[0])
    assert seen == [(s, t * K1_TILE) for s in range(streams)
                    for t in range(-(-b // K1_TILE))]
    lens = [len(cl[0]) for cl in clusters]
    assert max(lens) - min(lens) <= 1


def test_l2_bytes_at_32k_channels():
    """At M = 65536 a tile's 8 CTAs each read an eighth of the window's
    columns and of its frames': a tile reads the whole window and its
    frames, as at fx64, so the 32k cell's chunk reads 30.64 GB from L2
    against fx64's 30.48."""
    m, taps = 65536, 16
    want = 128 * sum(taps * m * 4 + (min(K1_TILE, 256 - j) + taps - 1) * m
                     for j in range(0, 256, K1_TILE))
    assert k1_l2_bytes(128, 256, m, taps) == want
    assert abs(want / 1e9 - 30.64) < 0.01


def test_wide_tables_hold_the_plan_and_the_cluster_twiddles():
    """At M = 65536 the split table is W_M^k for k < 32768 in the
    sub-sequences' order (bin k1 + 16 k2 at 2048 k1 + k2); the pass table
    is the 2048-point plan's (each CTA's FFTs) and then W_N^(n2 k1) for k1
    = 1..15 and n2 < 2048 (the radix-16 pass across the cluster)."""
    split, passes = _tables_np(65536)
    k1, k2 = np.meshgrid(np.arange(16), np.arange(2048), indexing="ij")
    np.testing.assert_allclose(
        split, np.exp(-2j * np.pi * (k1 + 16 * k2) / 65536).ravel(),
        atol=1e-7)
    plan = _tables_np(4096)[1]
    assert plan.size == 2032
    np.testing.assert_array_equal(passes[:plan.size], plan)
    cross = passes[plan.size:].reshape(15, 2048)
    k1, n2 = np.meshgrid(np.arange(1, 16), np.arange(2048), indexing="ij")
    np.testing.assert_allclose(cross, np.exp(-2j * np.pi * k1 * n2 / 32768),
                               atol=1e-7)
