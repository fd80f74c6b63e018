"""The fused F-engine kernel's FFT plan (``csrc/fengine.cu``), modelled in
PyTorch (``ops/fengine_fused.py:fft_plan_torch``: the radix order, the
twiddle table indices, the Stockham addressing and the in-register DFT's
stages) and held to ``torch.fft.rfft`` in float64, so that an index error
shows on the CPU before it reaches the card."""

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.ops.fengine_fused import (fft_plan, fft_plan_torch,
                                                 _tables_np)

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
