"""The port's F-engine (split-I/O streaming form) against the JAX
F-engine's jnp arm on the concatenated stream, and against the golden
chain (CPU: the port runs the plain version of kernel K1)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dc_sand_tpu import golden
from dc_sand_tpu.models.fengine import f_engine as jx_f_engine
from dc_sand_tpu.ops.fengine_fused import fengine_fused as jx_fengine_fused
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dc_sand_tpu_torch.models.pipeline import make_step, history_shape
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.utils import np_c2ri, np_ri2c, snr_db
from dc_sand_tpu.config import ChainConfig


def _certify_flips(got, want, pre):
    """int8 wire spectra ``got``/``want`` (..., 2) may differ only by
    single-LSB flips whose float64 pre-round value ``pre`` (complex) lies
    within 1e-3 of a .5 boundary: the float32 FFTs sum in different
    orders, and a value that close to the boundary rounds either way.  A
    wrong rounding mode, gain or phase gives diffs away from boundaries
    or larger than 1 LSB."""
    diff = got.astype(np.int16) - want.astype(np.int16)
    assert np.abs(diff).max(initial=0) <= 1
    pre_ri = np.stack([pre.real, pre.imag], -1)
    for i in map(tuple, np.argwhere(diff != 0)):
        v = pre_ri[i]
        assert abs(v - np.floor(v) - 0.5) < 1e-3, (i, v)
    return int((diff != 0).sum())


def _inputs(taps, nch, s, b, seed):
    rng = np.random.default_rng(seed)
    m = 2 * nch
    tp = taps_pad_for(taps)
    hist = golden.gaussian_noise_int8((s, tp * m), 20.0, seed).reshape(s, tp, m)
    chunk = golden.gaussian_noise_int8((s, b * m), 20.0, seed + 1).reshape(
        s, b, m)
    fd = rng.uniform(-0.5, 0.5, (s, b)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (s, b)).astype(np.float32)
    g = 0.05 * np.exp(1j * rng.uniform(-np.pi, np.pi, nch))
    return hist, chunk, fd, ph, g, pfb_window(taps, m)


@pytest.mark.parametrize("taps", [4, 16])      # pad0 = 5 and 1
def test_split_io_matches_jax_and_golden(taps):
    nch, s, b = 64, 4, 16
    hist, chunk, fd, ph, g, w = _inputs(taps, nch, s, b, seed=taps)
    pad0 = taps_pad_for(taps) - taps + 1
    got = f_engine(torch.from_numpy(chunk), w, taps, nch,
                   history=torch.from_numpy(hist),
                   frac_delay=torch.from_numpy(fd),
                   phase=torch.from_numpy(ph),
                   gains=torch.from_numpy(np_c2ri(g))).numpy()
    assert got.dtype == np.int8 and got.shape == (s, b, nch, 2)
    stream = np.concatenate([hist[:, pad0:], chunk], 1).reshape(s, -1)
    want = np.asarray(jx_f_engine(
        jnp.asarray(stream), w, taps, nch, frac_delay=jnp.asarray(fd),
        phase=jnp.asarray(ph), gains=jnp.asarray(np_c2ri(g)), impl="jnp"))
    pre = golden.f_engine(stream, w, taps, nch, frac_delay=fd,
                          phase=ph) * g
    _certify_flips(got, want, pre)
    ref = golden.f_engine(stream, w, taps, nch, frac_delay=fd, phase=ph,
                          gains=g)
    assert snr_db(ref, np_ri2c(got)) > 50


def test_float_spectra_without_gains_match_golden():
    taps, nch, s, b = 4, 32, 2, 8
    hist, chunk, fd, ph, _, w = _inputs(taps, nch, s, b, seed=9)
    pad0 = taps_pad_for(taps) - taps + 1
    got = f_engine(torch.from_numpy(chunk), w, taps, nch,
                   history=torch.from_numpy(hist),
                   frac_delay=torch.from_numpy(fd),
                   phase=torch.from_numpy(ph)).numpy()
    stream = np.concatenate([hist[:, pad0:], chunk], 1).reshape(s, -1)
    ref = golden.f_engine(stream, w, taps, nch, frac_delay=fd, phase=ph)
    assert got.dtype == np.float32
    assert snr_db(ref, np_ri2c(got)) > 100


@pytest.mark.parametrize("b", [16, 8])   # B >= taps_pad, and B < taps_pad
def test_step_carries_history_as_the_stream_tail(b):
    """After a step the history holds the stream's last taps_pad frames,
    so the next chunk's spectra equal the one-stream F-engine's over the
    concatenated frames."""
    taps, nch = 16, 32
    cfg = ChainConfig(name="t", n_ants=2, n_pols=2, n_chans=nch, n_taps=taps,
                      spectra_per_chunk=b, n_spectra_per_acc=b,
                      apply_requant=True, run_xengine=True)
    s, m, tp = 4, cfg.fft_size, taps_pad_for(taps)
    w = pfb_window(taps, m)
    frames = golden.gaussian_noise_int8((s, 2 * b * m), 20.0, 3).reshape(
        s, 2 * b, m)
    c0, c1 = (torch.from_numpy(np.ascontiguousarray(frames[:, i * b:
                                                           (i + 1) * b]))
              for i in range(2))
    gains = torch.from_numpy(np_c2ri(np.full(nch, 0.05)))
    history = torch.zeros(history_shape(cfg), dtype=torch.int8)
    acc = torch.zeros((nch, s, s), dtype=torch.int32)
    zero = torch.zeros((s, b))
    step = make_step(cfg, w, device="cpu")
    assert step(history, acc, c0, zero, zero, gains, None, True) == {}
    full = np.concatenate([np.zeros((s, tp, m), np.int8), frames], 1)
    np.testing.assert_array_equal(history.numpy(), full[:, b:b + tp])
    got = f_engine(c1, w, taps, nch, history=history, gains=gains).numpy()
    pad0 = tp - taps + 1
    stream = torch.from_numpy(full[:, b + pad0:].reshape(s, -1).copy())
    want = f_engine(stream, w, taps, nch, gains=gains).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", [True, False])   # with and without history
@pytest.mark.parametrize("taps", [4, 16])
def test_operand_layout_matches_jax_fused_corner_turned(taps, split):
    """``layout="operand"`` (the CMAC operand ``(K, 2, S, B)``) equals the
    JAX fused F-engine's wire output (Pallas, interpret mode) corner-turned
    as ``dc_sand_tpu/ops/xcorr.py:219-223`` does it (channel axis first,
    then ``[Ar; Ai]`` stacked), modulo certified 1-LSB boundary flips."""
    nch, s, b = 512, 2, 16
    hist, chunk, fd, ph, g, w = _inputs(taps, nch, s, b, seed=30 + taps)
    pad0 = taps_pad_for(taps) - taps + 1
    stream = np.concatenate([hist[:, pad0:], chunk], 1).reshape(s, -1)
    kw = dict(frac_delay=fd, phase=ph, gains=np_c2ri(g))
    if split:
        got = fengine_fused(torch.from_numpy(chunk), w, taps, nch,
                            history=torch.from_numpy(hist),
                            layout="operand",
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
        wire = jx_fengine_fused(jnp.asarray(chunk), w, taps, nch,
                                history=jnp.asarray(hist), interpret=True,
                                strict=True,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    else:
        got = fengine_fused(torch.from_numpy(stream), w, taps, nch,
                            layout="operand",
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
        wire = jx_fengine_fused(jnp.asarray(stream), w, taps, nch,
                                interpret=True, strict=True,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    assert got.dtype == torch.int8 and got.shape == (nch, 2, s, b)
    a = jnp.moveaxis(wire, 2, 0)                       # (K, S, B, 2)
    want = np.asarray(jnp.concatenate([a[..., 0], a[..., 1]], axis=1))
    pre = golden.f_engine(stream, w, taps, nch, frac_delay=fd,
                          phase=ph) * g                # (S, B, K)
    pre = np.moveaxis(pre, 2, 0)                        # (K, S, B)
    _certify_flips(got.reshape(nch, 2 * s, b).numpy()
                   .reshape(nch, 2, s, b).transpose(0, 2, 3, 1),
                   want.reshape(nch, 2, s, b).transpose(0, 2, 3, 1), pre)


def test_layouts_refused():
    x = torch.zeros((2, 4 * 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="layout"):
        fengine_fused(x, pfb_window(4, 64), 4, 32, layout="native")
    with pytest.raises(ValueError, match="gains"):
        fengine_fused(x, pfb_window(4, 64), 4, 32, layout="operand")
