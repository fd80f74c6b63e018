"""The port's per-stage ops against the JAX package's, on the same numpy
inputs (CPU).  Float stages agree to rtol 1e-5: the FFT sums in another
order (pocketfft vs XLA's FFT) and the phasor's cos/sin are different
float32 implementations; the FIR is held to the same bound.  Integer
stages agree exactly, up to certified round-half-even boundary flips."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dc_sand_tpu import golden, ops as jops
from dc_sand_tpu.models.fengine import coarse_delay as jx_coarse_delay
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import ops
from dc_sand_tpu_torch.models.fengine import coarse_delay

RTOL = 1e-5


def _close(got, want):
    """rtol 1e-5 of the array's largest magnitude (elementwise rtol is
    meaningless for bins that happen to land near zero)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("taps,nch", [(4, 32), (16, 64)])
def test_pfb_fir_matches_jax(taps, nch):
    rng = np.random.default_rng(taps)
    m = 2 * nch
    x = rng.integers(-127, 128, (2, 3, (5 + taps - 1) * m), dtype=np.int8)
    w = pfb_window(taps, m)
    want = np.asarray(jops.pfb_fir(jnp.asarray(x), w, taps, m, impl="jnp"))
    got = ops.pfb_fir(torch.from_numpy(x), w, taps, m).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    _close(got, want)


def test_channelize_matches_jax():
    rng = np.random.default_rng(1)
    fir = rng.normal(0, 300, (3, 5, 128)).astype(np.float32)
    want = np.asarray(jops.channelize(jnp.asarray(fir), 64))
    got = ops.channelize(torch.from_numpy(fir), 64).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    _close(got, want)


def test_fine_delay_fringe_matches_jax():
    rng = np.random.default_rng(2)
    spec = (rng.normal(0, 50, (2, 4, 64))
            + 1j * rng.normal(0, 50, (2, 4, 64))).astype(np.complex64)
    fd = rng.uniform(-0.5, 0.5, (2, 4)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (2, 4)).astype(np.float32)
    want = np.asarray(jops.fine_delay_fringe(jnp.asarray(spec),
                                             jnp.asarray(fd),
                                             jnp.asarray(ph)))
    got = ops.fine_delay_fringe(torch.from_numpy(spec), torch.from_numpy(fd),
                                torch.from_numpy(ph)).numpy()
    _close(got, want)


def test_requantize_matches_jax_and_rounds_half_even():
    rng = np.random.default_rng(3)
    spec = (rng.normal(0, 800, (4, 8, 64))
            + 1j * rng.normal(0, 800, (4, 8, 64))).astype(np.complex64)
    # exact .5 values (gain 1) must round half to even, and +-200 saturate
    spec[0, 0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 200, -200],
                              np.float32) * (1 + 1j)
    g = (0.05 * np.exp(1j * rng.uniform(-np.pi, np.pi, 64))).astype(
        np.complex64)
    g[:8] = 1.0
    want = np.asarray(jops.requantize(jnp.asarray(spec), jnp.asarray(g)))
    got = ops.requantize(torch.from_numpy(spec), torch.from_numpy(g)).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got[0, 0, :8, 0],
                                  [0, 2, 2, 0, -2, 126, 127, -127])
    diff = got.astype(np.int16) - want
    flips = np.argwhere(diff != 0)
    # the same float32 product on both sides: a flip may only sit within
    # 1e-3 of a .5 boundary of the float64 pre-round value
    pre = spec.astype(np.complex128) * g.astype(np.complex128)
    pre_ri = np.stack([pre.real, pre.imag], -1)
    assert np.abs(diff).max(initial=0) <= 1
    for i in map(tuple, flips):
        v = pre_ri[i]
        assert abs(v - np.floor(v) - 0.5) < 1e-3, (i, v)
    np.testing.assert_array_equal(
        ops.dequantize(torch.from_numpy(got)).numpy(),
        np.asarray(jops.dequantize(jnp.asarray(got))))


def test_coarse_delay_matches_jax_and_clamps():
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (3, 2, 100), dtype=np.int8)
    xt = torch.from_numpy(x)
    delays = np.array([[0, 5], [8, 3], [1, -2]])   # -2 clamps to 0
    want = np.asarray(jx_coarse_delay(jnp.asarray(x), jnp.asarray(delays), 8))
    np.testing.assert_array_equal(coarse_delay(xt, delays, 8).numpy(), want)
    np.testing.assert_array_equal(
        coarse_delay(xt, np.clip(delays, 0, 8), 8).numpy(),
        golden.apply_coarse_delay(x, np.clip(delays, 0, 8), 8))
    # above max_delay the documented clamp holds: delay 12 reads as 8.
    # (The JAX version's dynamic_slice takes the negative start index
    # relative to the array's end instead, so it is not compared here.)
    np.testing.assert_array_equal(
        coarse_delay(xt, np.array([[12, 5], [8, 3], [1, 0]]), 8).numpy(),
        coarse_delay(xt, np.array([[8, 5], [8, 3], [1, 0]]), 8).numpy())
