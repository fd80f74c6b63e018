"""The port's PFB-FIR (the plain version of kernel K6) against the JAX
package's ``ops.pfb_fir``: bitwise against its jnp arm, and within float32
rounding of its Pallas kernel run in the interpreter; and the unfused
F-engine (K6 -> rfft -> phasor -> requant) against the JAX F-engine's
``impl="pallas_interpret"`` path, which is the same composition."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dc_sand_tpu import golden, ops as jops
from dc_sand_tpu.models.fengine import f_engine as jx_f_engine
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops.pfb import pfb_fir, taps_pad_for
from dc_sand_tpu_torch.utils import np_c2ri, np_ri2c, snr_db

# the Pallas interpreter sums the taps in another float32 order than the
# jnp arm: measured differences 7.6e-6 to 1.1e-5 at sigma-20 int8 input
PALLAS_ATOL = 2e-5
FLOAT_SNR_DB = 120.0      # unfused F-engine, float spectra, vs JAX
MAX_FLIP_FRACTION = 1e-3  # int8 spectra: single-LSB boundary flips only


def _stream(shape, seed):
    return golden.gaussian_noise_int8(shape, 20.0, seed)


@pytest.mark.parametrize("taps,m,b", [(16, 128, 32), (16, 256, 64),
                                      (4, 128, 16)])
def test_plain_fir_matches_jax(taps, m, b):
    """Bitwise against the jnp arm; within PALLAS_ATOL of the Pallas
    kernel in the interpreter, which tiles these shapes."""
    x = _stream((3, (b + taps - 1) * m), taps + m)
    w = pfb_window(taps, m)
    got = pfb_fir(torch.from_numpy(x), w, taps, m).numpy()
    assert got.dtype == np.float32 and got.shape == (3, b, m)
    want = np.asarray(jops.pfb_fir(jnp.asarray(x), w, taps, m, impl="jnp"))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jops.pfb_fir(jnp.asarray(x), w, taps, m,
                                     impl="pallas_interpret"))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=PALLAS_ATOL)


@pytest.mark.parametrize("taps", [16, 5])      # pad0 = 1 and 4
def test_split_io_equals_the_concatenated_stream(taps):
    m, b, s = 64, 12, 3
    tp = taps_pad_for(taps)
    hist = _stream((s, tp, m), 1)
    chunk = _stream((s, b, m), 2)
    got = pfb_fir(torch.from_numpy(chunk), pfb_window(taps, m), taps, m,
                  history=torch.from_numpy(hist)).numpy()
    pad0 = tp - taps + 1
    stream = np.concatenate([hist[:, pad0:], chunk], 1).reshape(s, -1)
    want = pfb_fir(torch.from_numpy(stream), pfb_window(taps, m), taps,
                   m).numpy()
    np.testing.assert_array_equal(got, want)


def test_shape_the_jax_kernel_cannot_tile():
    """B = 21 and M = 100 (no tile of 16..128 spectra, M not a multiple of
    128): the JAX kernel falls back to its jnp arm; the port's wrapper
    takes the shape as it is (its kernel masks the ragged edges)."""
    taps, m, b = 16, 100, 21
    x = _stream((2, 2, (b + taps - 1) * m), 3)
    w = pfb_window(taps, m)
    got = pfb_fir(torch.from_numpy(x), w, taps, m).numpy()
    assert got.shape == (2, 2, b, m)
    for impl in ("jnp", "pallas_interpret"):
        np.testing.assert_array_equal(
            got, np.asarray(jops.pfb_fir(jnp.asarray(x), w, taps, m,
                                         impl=impl)))


def test_wrapper_checks():
    x = torch.zeros((2, 5 * 64), dtype=torch.int8)
    w = pfb_window(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        pfb_fir(x, w, 4, 64, impl="cuda")
    with pytest.raises(ValueError, match="multiple of M"):
        pfb_fir(x[:, :-1], w, 4, 64)
    with pytest.raises(ValueError, match="history must be"):
        pfb_fir(x.reshape(2, 5, 64), w, 4, 64,
                history=torch.zeros((2, 4, 64), dtype=torch.int8))


def _fengine_inputs(seed, s=3, b=32, nch=128, taps=16):
    rng = np.random.default_rng(seed)
    m = 2 * nch
    hist = _stream((s, taps_pad_for(taps), m), seed)
    chunk = _stream((s, b, m), seed + 1)
    fd = rng.uniform(-0.5, 0.5, (s, b)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (s, b)).astype(np.float32)
    g = np_c2ri(0.05 * np.exp(1j * rng.uniform(-np.pi, np.pi, nch)))
    return hist, chunk, fd, ph, g, pfb_window(taps, m)


@pytest.mark.parametrize("quant", [True, False])
def test_unfused_fengine_matches_jax_pallas_path(quant):
    """3 streams x 32 spectra x 128 channels, delay and fringe on: int8
    spectra within 1 LSB on at most 1e-3 of the values, float spectra
    >= 120 dB from JAX's; the same bits as the port's fused path on the
    CPU (both run the plain stages there)."""
    taps, nch = 16, 128
    hist, chunk, fd, ph, g, w = _fengine_inputs(7)
    kw = dict(history=torch.from_numpy(hist), frac_delay=torch.from_numpy(fd),
              phase=torch.from_numpy(ph),
              gains=torch.from_numpy(g) if quant else None)
    got = f_engine(torch.from_numpy(chunk), w, taps, nch, fused=False,
                   **kw).numpy()
    fused = f_engine(torch.from_numpy(chunk), w, taps, nch, **kw).numpy()
    np.testing.assert_array_equal(got, fused)
    want = np.asarray(jx_f_engine(
        jnp.asarray(chunk), w, taps, nch, history=jnp.asarray(hist),
        frac_delay=jnp.asarray(fd), phase=jnp.asarray(ph),
        gains=jnp.asarray(g) if quant else None, impl="pallas_interpret"))
    assert got.shape == want.shape == (3, 32, nch, 2)
    assert got.dtype == want.dtype
    if quant:
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= MAX_FLIP_FRACTION
    else:
        assert snr_db(np_ri2c(want), np_ri2c(got)) >= FLOAT_SNR_DB
