"""The port's matmul-formulated real FFT (``ops/fft_mxu.py``) against numpy
float64 ``rfft``, as ``tests/test_ops.py`` holds the JAX module's, and
against the JAX module on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_sand_tpu.ops import fft_mxu as jax_fft_mxu
from dc_sand_tpu_torch.ops import fft_mxu
from dc_sand_tpu_torch.utils import snr_db

# both are float32 matmuls of the same tables, summed in other orders:
# tests/test_ops.py holds the JAX module > 100 dB from float64
SNR_VS_NUMPY = 100.0
SNR_VS_JAX = 120.0


@pytest.mark.parametrize("n_chans", [64, 1024])
def test_channelize_mxu_matches_numpy_and_jax(n_chans):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 4, 2 * n_chans)).astype(np.float32) * 30
    ref = np.fft.rfft(x.astype(np.float64))[..., :n_chans]
    out = fft_mxu.channelize_mxu(torch.from_numpy(x), n_chans)
    assert out.dtype == torch.complex64 and tuple(out.shape) == ref.shape
    got = out.numpy()
    assert snr_db(ref, got) > SNR_VS_NUMPY
    jx = np.asarray(jax_fft_mxu.channelize_mxu(jnp.asarray(x), n_chans))
    assert snr_db(jx, got) > SNR_VS_JAX


def test_factor_and_tables_match_jax():
    for m in (64, 128, 2048, 8192):
        assert fft_mxu._factor(m) == jax_fft_mxu._factor(m)
        for a, b in zip(fft_mxu._tables_np(m), jax_fft_mxu._tables_np(m)):
            np.testing.assert_array_equal(a, b)


def test_channelize_mxu_rejects_bad_length():
    with pytest.raises(ValueError, match="FFT length"):
        fft_mxu.channelize_mxu(torch.zeros((2, 100)), 64)
    with pytest.raises(ValueError, match="not factorable"):
        fft_mxu.rfft_mxu(torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="not factorable"):
        jax_fft_mxu.rfft_mxu(jnp.zeros((2, 12), jnp.float32))
