"""The port's X-engine (CPU: the plain version of the CMAC kernel)
against the JAX X-engine — bitwise, the arithmetic is integer — and
against the golden correlator."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dc_sand_tpu import golden

# by module path: both ops packages also hold a function named xcorr
jx = importlib.import_module("dc_sand_tpu.ops.xcorr")
tx = importlib.import_module("dc_sand_tpu_torch.ops.xcorr")


def _a2(k, ap, b, seed):
    rng = np.random.default_rng(seed)
    # the quantiser saturates to +-127: -128 never occurs
    return rng.integers(-127, 128, (k, 2 * ap, b), dtype=np.int8)


def _acc(k, ap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**20, 2**20, (k, ap, ap), dtype=np.int32)


@pytest.mark.parametrize("keep", [1, 0])
@pytest.mark.parametrize("k,ap,b", [(3, 6, 8), (2, 16, 40)])
def test_accumulate_a2_bitwise_vs_jax(k, ap, b, keep):
    a2, acc = _a2(k, ap, b, k + ap), _acc(k, ap, b)
    base = acc if keep else np.zeros_like(acc)
    want = np.asarray(jx.xcorr_accumulate_a2(jnp.asarray(base),
                                             jnp.asarray(a2), impl="jnp"))
    got = torch.from_numpy(acc.copy())
    out = tx.xcorr_accumulate_a2(got, torch.from_numpy(a2), keep=keep)
    assert out is got                       # updated in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_accumulate_a2_bitwise_vs_pallas_interpret():
    """The smallest shape the TPU CMAC kernel takes (2ap % 16 == 0,
    b % 128 == 0), run through the Pallas interpreter."""
    k, ap, b = 2, 8, 128
    a2, acc = _a2(k, ap, b, 7), _acc(k, ap, 8)
    want = np.asarray(jx._xcorr_accumulate_pallas(
        jnp.asarray(acc), jnp.asarray(a2), interpret=True))
    got = torch.from_numpy(acc.copy())
    tx.xcorr_accumulate_a2(got, torch.from_numpy(a2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wire_corner_turn_and_q_form_match_jax():
    """``wire_to_a2`` is the JAX step's corner-turn glue (moveaxis to
    channel-major, then [Ar; Ai] stacking), and the q-form accumulate,
    ``xcorr_full`` and ``extract_baselines`` agree with JAX bitwise."""
    a, p, b, k = 3, 2, 8, 16
    rng = np.random.default_rng(11)
    wire = rng.integers(-127, 128, (a, p, b, k, 2), dtype=np.int8)
    qk = np.moveaxis(wire, 3, 0)                          # (k, a, p, b, 2)
    a_ = qk.reshape(k, a * p, b, 2)
    want_a2 = np.concatenate([a_[..., 0], a_[..., 1]], axis=1)
    got_a2 = tx.wire_to_a2(torch.from_numpy(wire.reshape(a * p, b, k, 2)))
    np.testing.assert_array_equal(got_a2.numpy(), want_a2)
    acc = _acc(k, a * p, 1)
    want = np.asarray(jx.xcorr_accumulate(jnp.asarray(acc), jnp.asarray(qk),
                                          impl="jnp"))
    got = torch.from_numpy(acc.copy())
    tx.xcorr_accumulate(got, torch.from_numpy(np.ascontiguousarray(qk)))
    np.testing.assert_array_equal(got.numpy(), want)
    q_t = torch.from_numpy(np.ascontiguousarray(qk))
    np.testing.assert_array_equal(tx.xcorr_full(q_t).numpy(),
                                  np.asarray(jx.xcorr_full(jnp.asarray(qk))))
    np.testing.assert_array_equal(
        tx.extract_baselines(tx.xcorr_full(q_t), a, p).numpy(),
        np.asarray(jx.xcorr(jnp.asarray(qk))))


def test_extract_vis_bitwise_vs_jax_and_golden():
    a, p, b, k = 4, 2, 12, 8
    ap = a * p
    rng = np.random.default_rng(12)
    q = rng.integers(-127, 128, (a, p, b, k, 2), dtype=np.int8)
    qk = np.moveaxis(q, 3, 0).reshape(k, ap, b, 2)
    a2 = np.concatenate([qk[..., 0], qk[..., 1]], axis=1)
    acc = torch.zeros(tx.acc_shape(a, p, k), dtype=torch.int32)
    tx.xcorr_accumulate_a2(acc, torch.from_numpy(a2), keep=0)
    got = tx.extract_vis(acc, a, p).numpy()
    want = np.asarray(jx.extract_vis(jnp.asarray(acc.numpy()), a, p))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (a * (a + 1) // 2, p, p, k, 2)
    vis_g = golden.xcorr(q[..., 0] + 1j * q[..., 1])
    np.testing.assert_array_equal(got[..., 0] + 1j * got[..., 1], vis_g)


def test_plain_cmac_blocks_channels_exactly(monkeypatch):
    """The plain version's channel blocking (bounding its exact int64 /
    float64 copies) changes nothing: one channel per block equals one
    block for all."""
    a2, acc = _a2(5, 4, 16, 3), _acc(5, 4, 3)
    whole = torch.from_numpy(acc.copy())
    tx.xcorr_accumulate_a2_torch(whole, torch.from_numpy(a2))
    monkeypatch.setattr(tx, "_PLAIN_BLOCK_ELEMS", 1)
    blocked = torch.from_numpy(acc.copy())
    tx.xcorr_accumulate_a2_torch(blocked, torch.from_numpy(a2))
    np.testing.assert_array_equal(blocked.numpy(), whole.numpy())
