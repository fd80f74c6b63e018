"""The port's B-engine (CPU: the plain versions of the beam kernel) against
the JAX B-engine — its jnp arm, and the TPU kernels K5 and K4 run in the
Pallas interpreter — and against the golden beamformer; plus the numpy
copy of the steering weights."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dc_sand_tpu import golden
from dc_sand_tpu.models.steering import steering_weights as jax_steering
from dc_sand_tpu_torch.models.steering import steering_weights
from dc_sand_tpu_torch.utils import snr_db

# by module path: both ops packages also hold a function named beamform
jb = importlib.import_module("dc_sand_tpu.ops.beamform")
tb = importlib.import_module("dc_sand_tpu_torch.ops.beamform")

# both sides sum float32 products in different orders: ~140 dB apart
SNR_VS_JNP = 110.0
# the TPU kernels split the weights into bf16 hi/lo halves (the JAX
# package's own bound for them, tests/test_ops.py TestBeamformPallas)
SNR_VS_PALLAS = 85.0


def _inputs(a, p, b, k, nb, seed):
    rng = np.random.default_rng(seed)
    # the quantiser saturates to +-127: -128 never occurs
    q = rng.integers(-127, 128, (a, p, b, k, 2), dtype=np.int8)
    w = rng.normal(size=(nb, a, k, 2)).astype(np.float32)
    return q, w


def _c(x):
    return x[..., 0] + 1j * x[..., 1]


@pytest.mark.parametrize("a,p,b,k,nb", [(4, 2, 64, 16, 4),
                                        (64, 2, 16, 8, 16)])
def test_beams_match_jax_jnp_and_golden(a, p, b, k, nb):
    q, w = _inputs(a, p, b, k, nb, seed=a + b)
    want = np.asarray(jb.beamform(jnp.asarray(q), jnp.asarray(w),
                                  impl="jnp"))
    got = tb.beamform_torch(torch.from_numpy(q), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (nb, p, b, k, 2)
    assert snr_db(want, got.numpy()) >= SNR_VS_JNP
    assert snr_db(golden.beamform(_c(q), _c(w)), _c(got.numpy())) > 85
    # the wrapper takes the plain version for CPU tensors
    beams, inc = tb.beamform(torch.from_numpy(q), torch.from_numpy(w))
    assert torch.equal(beams, got) and inc is None


def test_beams_match_the_wire_tpu_kernel_k5():
    """K5 (``_bf_kernel``) as the JAX tests run it: the Pallas
    interpreter, at the smallest shape its gate admits."""
    q, w = _inputs(4, 2, 64, 16, 4, seed=55)
    want = np.asarray(jb.beamform(jnp.asarray(q), jnp.asarray(w),
                                  impl="pallas_interpret"))
    got, _ = tb.beamform(torch.from_numpy(q), torch.from_numpy(w))
    assert snr_db(want, got.numpy()) > SNR_VS_PALLAS


def test_beams_match_the_native_tpu_kernel_k4():
    """K4 (``_beam_native_kernel``) in the Pallas interpreter, fed the
    fused F-engine's native planes ``(a, p, m2, 2, b, k1n)`` built from
    the same wire spectra (channel ``k = k1 * m2 + k2``); with the
    in-kernel int8 quantisation as well.  ``_kg=16`` cuts the k1 axis
    into smaller groups than the default (which only changes how the
    grid is cut): the interpreter then traces a body 8x smaller."""
    a, p, b, m2, k1n, nb = 4, 2, 128, 2, 128, 4
    k = m2 * k1n
    q, w = _inputs(a, p, b, k, nb, seed=57)
    qn = np.ascontiguousarray(
        q.reshape(a, p, b, k1n, m2, 2).transpose(0, 1, 4, 5, 2, 3))
    want = np.asarray(jb.beamform_native(jnp.asarray(qn), jnp.asarray(w),
                                         impl="pallas_interpret", _kg=16))
    got, _ = tb.beamform(torch.from_numpy(q), torch.from_numpy(w))
    assert snr_db(want, got.numpy()) > SNR_VS_PALLAS
    scale = 30.0 / float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    want_q = np.asarray(jb.beamform_native(
        jnp.asarray(qn), jnp.asarray(w), impl="pallas_interpret",
        quant_scale=scale, _kg=16))
    got_q, _ = tb.beamform(torch.from_numpy(q), torch.from_numpy(w),
                           quant_scale=scale)
    d = np.abs(got_q.numpy().astype(np.int16) - want_q.astype(np.int16))
    # the TPU kernel's bf16-split weights move y*s by ~1e-5 LSB
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# the kernel's arithmetic in plain PyTorch: exact operands (int8 samples,
# three bf16 pieces that add up to the float32 weight), float32 sums in
# another order than beamform_torch's
SNR_SPLIT_VS_PLAIN = 120.0
# against the JAX package: its jnp arm sums float32 in yet another order,
# and the TPU kernels keep two bf16 pieces of a weight (about 16 bits)
SNR_SPLIT_VS_JAX = 60.0


def test_split3_pieces_add_up_to_the_weight_bitwise():
    """hi, mid, lo are bf16 values and hi + mid + lo == w bitwise, in
    either order of the float32 additions, for seeded normal weights."""
    w = torch.from_numpy(np.random.default_rng(12).normal(
        size=(16, 64, 33, 2)).astype(np.float32))
    w[0, 0, 0, 0] = 0.0
    hi, mid, lo = tb.split3(w)
    for piece in (hi, mid, lo):
        assert piece.dtype == torch.float32
        assert torch.equal(piece.to(torch.bfloat16).to(torch.float32), piece)
    assert torch.equal((hi + mid) + lo, w)
    assert torch.equal(hi + (mid + lo), w)
    # two pieces do not: the third carries bits 17-24
    assert not torch.equal(hi + mid, w)


@pytest.mark.parametrize("a,p,b,k,nb", [(4, 2, 64, 16, 4),
                                        (64, 2, 16, 8, 16)])
def test_beams_from_split_weights_match_plain_and_jax(a, p, b, k, nb):
    """Beams formed as the kernel forms them (interleaved real GEMM per
    channel, one pass per bf16 piece, float32 sums) against the plain
    version, the JAX jnp arm and the TPU kernel K5 in the interpreter."""
    q, w = _inputs(a, p, b, k, nb, seed=a * b + 1)
    got = tb.beamform_split_torch(torch.from_numpy(q), torch.from_numpy(w))
    plain = tb.beamform_torch(torch.from_numpy(q), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == plain.shape
    assert snr_db(plain.numpy(), got.numpy()) >= SNR_SPLIT_VS_PLAIN
    jnp_arm = np.asarray(jb.beamform(jnp.asarray(q), jnp.asarray(w),
                                     impl="jnp"))
    assert snr_db(jnp_arm, got.numpy()) >= SNR_SPLIT_VS_JAX
    if b % 64 == 0:                  # K5's gate (as in the test above)
        k5 = np.asarray(jb.beamform(jnp.asarray(q), jnp.asarray(w),
                                    impl="pallas_interpret"))
        assert snr_db(k5, got.numpy()) >= SNR_SPLIT_VS_JAX


def test_beams_from_split_weights_match_the_native_tpu_kernel_k4():
    """The same arithmetic against K4 in the interpreter, fed the native
    planes of the same wire spectra."""
    a, p, b, m2, k1n, nb = 4, 2, 128, 2, 128, 4
    k = m2 * k1n
    q, w = _inputs(a, p, b, k, nb, seed=58)
    qn = np.ascontiguousarray(
        q.reshape(a, p, b, k1n, m2, 2).transpose(0, 1, 4, 5, 2, 3))
    want = np.asarray(jb.beamform_native(jnp.asarray(qn), jnp.asarray(w),
                                         impl="pallas_interpret", _kg=16))
    got = tb.beamform_split_torch(torch.from_numpy(q), torch.from_numpy(w))
    assert snr_db(want, got.numpy()) >= SNR_SPLIT_VS_JAX


@pytest.mark.parametrize("a,p,b,k,nb", [(3, 2, 5, 7, 5), (1, 1, 1, 1, 1),
                                        (5, 1, 16, 9, 17), (16, 2, 8, 4, 16)])
def test_interleaved_weights_signs_and_column_order(a, p, b, k, nb):
    """W' (k, 2a, 2nb): rows (antenna, re/im of the sample), columns
    (beam, re/im of the output).  One float32 product X' @ W' per channel
    gives the plain version's beams (float32 sums in another order:
    >= 120 dB), and the entries are the weights themselves."""
    q, w = _inputs(a, p, b, k, nb, seed=a + nb)
    qt, wt = torch.from_numpy(q), torch.from_numpy(w)
    wp = tb.interleaved_weights(wt)
    assert wp.shape == (k, 2 * a, 2 * nb)
    e, ant, ch = nb - 1, a - 1, k - 1
    wr, wi = w[e, ant, ch]
    assert wp[ch, 2 * ant, 2 * e] == wr and wp[ch, 2 * ant + 1, 2 * e] == -wi
    assert wp[ch, 2 * ant, 2 * e + 1] == wi
    assert wp[ch, 2 * ant + 1, 2 * e + 1] == wr
    x = qt.float().permute(3, 1, 2, 0, 4).reshape(k, p * b, 2 * a)
    y = torch.matmul(x, wp).reshape(k, p, b, nb, 2).permute(3, 1, 2, 0, 4)
    assert snr_db(tb.beamform_torch(qt, wt).numpy(),
                  y.numpy()) >= SNR_SPLIT_VS_PLAIN
    assert snr_db(tb.beamform_torch(qt, wt).numpy(),
                  tb.beamform_split_torch(qt, wt).numpy()) \
        >= SNR_SPLIT_VS_PLAIN


def test_incoherent_sum_bitwise_equals_jax():
    q, w = _inputs(64, 2, 16, 8, 2, seed=3)
    want = np.asarray(jb.incoherent_sum(jnp.asarray(q)))
    got = tb.incoherent_sum_torch(torch.from_numpy(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    _, inc = tb.beamform(torch.from_numpy(q), torch.from_numpy(w),
                         incoherent=True)
    np.testing.assert_array_equal(inc.numpy(), want)
    np.testing.assert_array_equal(inc.numpy(),
                                  golden.incoherent_sum(_c(q)))


def test_int8_beams_match_quantised_jax_beams():
    """``quant_scale > 0``: ``clip(rint(y * s), +-127)`` of the float
    beams, at a scale that puts the rms of ``y * s`` near 30 LSB (and
    saturates the tails), against the same rounding of JAX's jnp beams."""
    q, w = _inputs(64, 2, 16, 8, 16, seed=9)
    y = np.asarray(jb.beamform(jnp.asarray(q), jnp.asarray(w), impl="jnp"))
    scale = 30.0 / float(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
    want = np.clip(np.round(y * np.float32(scale)), -127, 127).astype(
        np.int8)
    got, _ = tb.beamform(torch.from_numpy(q), torch.from_numpy(w),
                         quant_scale=scale)
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert np.abs(want).max() == 127         # the clip is exercised


def test_wrapper_rejects_bad_inputs():
    q, w = (torch.from_numpy(x) for x in _inputs(3, 2, 4, 8, 2, seed=1))
    with pytest.raises(ValueError, match="q must be"):
        tb.beamform(q[..., 0], w)
    with pytest.raises(ValueError, match="weights must be"):
        tb.beamform(q, w[:, :2])
    with pytest.raises(ValueError, match="quant_scale"):
        tb.beamform(q, w, quant_scale=-1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tb.beamform(q, w, impl="cuda")


def test_steering_weights_copy_equals_the_jax_package():
    rng = np.random.default_rng(4)
    delays = rng.uniform(-2.5e-7, 2.5e-7, (3, 5))
    taper = rng.uniform(0.5, 1.0, 5)
    for tp in (None, taper):
        np.testing.assert_array_equal(
            steering_weights(delays, 64, 1712e6, taper=tp),
            jax_steering(delays, 64, 1712e6, taper=tp))
    with pytest.raises(ValueError, match="n_beams, n_ants"):
        steering_weights(delays[0], 64, 1712e6)
