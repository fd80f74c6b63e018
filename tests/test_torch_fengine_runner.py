"""The port's runner in fengine mode (configs pfb1k and pfb4k) against the
JAX runner (jnp arm) and the golden chain, on both F-engine paths, with a
dropped chunk and across a JAX checkpoint; the port's fengine verify; and
the fx runner through the unfused F-engine."""

import copy

import numpy as np
import pytest

from dc_sand_tpu import golden
from dc_sand_tpu import verify as jax_verify
from dc_sand_tpu.config import get_config, scaled_for_test
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner, save_state
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import verify as port_verify
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner,
                                       load_jax_checkpoint)
from dc_sand_tpu_torch.utils import np_ri2c, snr_db

FLOAT_SNR_VS_JAX = 120.0   # float32 spectra, FFTs summed in other orders
MAX_FLIP_FRACTION = 1e-3   # int8 spectra: single-LSB boundary flips only
VIS_SNR_VS_JAX = 60.0      # as tests/test_torch_runner.py


def _cfg(name):
    return scaled_for_test(get_config(name), n_chans=128,
                           spectra_per_chunk=16)


def _setup(cfg, n_chunks, seed):
    rng = np.random.default_rng(seed)
    a, p = cfg.n_ants, cfg.n_pols
    stream = golden.gaussian_noise_int8(
        (a, p, n_chunks * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    gains = np.full(cfg.n_chans, 0.05) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    max_delay = 8 if cfg.apply_delay else 0
    d0 = rng.integers(0, 8, (a, p)).astype(float) if max_delay else 0.0
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    dms = []
    for cls in (JaxDelayModel, DelayModel):
        dm = cls.zeros(a, p, max_delay=max_delay)
        if max_delay:
            dm.d0, dm.p1 = np.array(d0), p1.copy()
            dm.d1 = np.full((a, p), 2e-4)
        dms.append(dm)
    return (stream, (lambda i: stream[..., i * c:(i + 1) * c]), gains,
            gains_ri, dms, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window))


def _collect(outs, device_tensors):
    def on_output(i, o):
        outs.append({k: (v.cpu().numpy() if device_tensors else v)
                     for k, v in o.items()})
    return on_output


def _assert_close_to_jax(got, want, quantised):
    assert got.dtype == want.dtype and got.shape == want.shape
    if quantised:
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= MAX_FLIP_FRACTION
    else:
        assert snr_db(np_ri2c(want), np_ri2c(got)) >= FLOAT_SNR_VS_JAX


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["pfb1k", "pfb4k"])
def test_fengine_runner_matches_jax_and_golden(name, fused):
    """3 chunks, chunk 1 dropped: each chunk's spectra (float32 for pfb1k,
    int8 for pfb4k, ``(A, P, B, K, 2)``) within boundary flips or float32
    rounding of JAX's, and both > 50 dB against golden."""
    cfg = _cfg(name)
    stream, src, gains, gains_ri, (jdm, pdm), w = _setup(cfg, 3, 11)
    j_out, p_out = [], []
    JaxRunner(cfg, w, delay_model=jdm, gains=gains_ri, impl="jnp").run(
        src, 3, on_output=_collect(j_out, False), drop_chunks=(1,))
    dumps, counters = FXRunner(
        cfg, w, delay_model=pdm, gains=gains_ri, device="cpu",
        fused=fused).run(src, 3, on_output=_collect(p_out, True),
                         drop_chunks=(1,))
    assert dumps == [] and counters.chunks_dropped == 1
    assert counters.chunks_in == 3 and counters.dumps == 0
    faulted = stream.copy()
    faulted[..., cfg.chunk_samples:2 * cfg.chunk_samples] = 0
    spec_g = jax_verify._golden_spectra(cfg, faulted, jdm, gains, 3, w)
    b = cfg.spectra_per_chunk
    assert len(j_out) == len(p_out) == 3
    for i, (jo, po) in enumerate(zip(j_out, p_out)):
        assert set(po) == {"spectra"}
        got, want = po["spectra"], jo["spectra"]
        assert got.shape == (cfg.n_ants, cfg.n_pols, b, cfg.n_chans, 2)
        assert got.dtype == (np.int8 if cfg.apply_requant else np.float32)
        _assert_close_to_jax(got, want, cfg.apply_requant)
        ref = spec_g[:, :, i * b:(i + 1) * b]
        assert snr_db(ref, np_ri2c(want)) > 50
        assert snr_db(ref, np_ri2c(got)) > 50


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["pfb1k", "pfb4k"])
def test_verify_fengine_configs_scaled_on_cpu(name, fused):
    snrs, counters = port_verify.verify_config(name, device="cpu", scale=128,
                                               fused=fused)
    assert snrs["spectra"] > port_verify.SNR_BOUND
    assert counters.chunks_in == 4 and counters.dumps == 0


def test_resume_pfb4k_run_from_jax_checkpoint(tmp_path):
    """JAX runs 2 chunks and saves (sample-axis history, the host coarse
    tail, the rank-1 accumulator); the port loads the state and runs the
    third chunk, whose spectra match JAX's third chunk."""
    cfg = _cfg("pfb4k")
    _, src, _, gains_ri, (jdm, _), w = _setup(cfg, 3, 21)
    want = []
    JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm), gains=gains_ri,
              impl="jnp").run(src, 3, on_output=_collect(want, False))
    first = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                      gains=gains_ri, impl="jnp")
    first.run(src, 2)
    path = save_state(first, str(tmp_path / "state"))
    resumed = FXRunner(cfg, w, delay_model=DelayModel.zeros(1, 2, 8),
                       device="cpu", fused=False)
    load_jax_checkpoint(resumed, path)
    assert resumed.chunk_idx == 2 and resumed.t0 == 2 * cfg.chunk_samples
    assert tuple(resumed.vis_acc[0].shape) == (1,)
    got = []
    resumed.run(src, 1, on_output=_collect(got, True))
    _assert_close_to_jax(got[0]["spectra"], want[2]["spectra"], True)


def test_fx4_runner_through_the_unfused_fengine_matches_jax():
    """fx4 (64 channels, 8-spectra chunks, 16-spectra dumps, a dropped
    chunk) with ``fused=False`` against the JAX runner's jnp arm."""
    cfg = scaled_for_test(get_config("fx4"), n_chans=64,
                          spectra_per_chunk=8).replace(n_spectra_per_acc=16)
    stream, src, gains, gains_ri, (jdm, pdm), w = _setup(cfg, 4, 6)
    jd, _ = JaxRunner(cfg, w, delay_model=jdm, gains=gains_ri,
                      impl="jnp").run(src, 4, drop_chunks=(2,))
    pd, _ = FXRunner(cfg, w, delay_model=pdm, gains=gains_ri, device="cpu",
                     fused=False).run(src, 4, drop_chunks=(2,))
    assert len(jd) == len(pd) == 2
    faulted = stream.copy()
    faulted[..., 2 * cfg.chunk_samples:3 * cfg.chunk_samples] = 0
    spec_g = jax_verify._golden_spectra(cfg, faulted, jdm, gains, 4, w)
    for i, (a, b) in enumerate(zip(jd, pd)):
        assert (a.n_spectra, a.first_chunk) == (b.n_spectra, b.first_chunk)
        va = a.vis[..., 0] + 1j * a.vis[..., 1]
        vb = b.vis[..., 0] + 1j * b.vis[..., 1]
        assert snr_db(va, vb) > VIS_SNR_VS_JAX
        assert snr_db(golden.xcorr(spec_g[:, :, i * 16:(i + 1) * 16]),
                      vb) > 50
