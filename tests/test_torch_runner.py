"""The port's streaming fx runner against the JAX runner (jnp arm) on the
same stream and delay model, against the golden chain, and across a JAX
checkpoint; plus the numpy pieces the port copies from the JAX package."""

import copy

import numpy as np
import pytest
import torch

from dc_sand_tpu import golden
from dc_sand_tpu.config import get_config, scaled_for_test
from dc_sand_tpu.ops.fengine_fused import native_channel_perm
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner, save_state
from dc_sand_tpu.utils import snr_db as jax_snr_db
from dc_sand_tpu import verify as jax_verify
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import verify as port_verify
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner,
                                       load_jax_checkpoint,
                                       window_and_gains_from_numpy)
from dc_sand_tpu_torch.utils import snr_db

# the JAX and port F-engines round the same float32 values, except that
# a value within float32 noise of a .5 boundary may flip one LSB; the
# visibilities are bitwise equal otherwise (integer CMAC), so a flip
# costs far less than this bound
VIS_SNR_VS_JAX = 60.0


def _delay_models(cfg, seed, max_delay=8, drift=0.0):
    rng = np.random.default_rng(seed)
    a, p = cfg.n_ants, cfg.n_pols
    d0 = rng.integers(0, max_delay, (a, p)).astype(float)
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    out = []
    for cls in (JaxDelayModel, DelayModel):
        dm = cls.zeros(a, p, max_delay=max_delay)
        dm.d0, dm.p1 = d0.copy(), p1.copy()
        dm.d1 = np.full((a, p), drift)
        out.append(dm)
    return out


def _setup(cfg, n_chunks, seed):
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, n_chunks * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    gains = np.full(cfg.n_chans, 0.05) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    return stream, (lambda i: stream[..., i * c:(i + 1) * c]), gains, \
        gains_ri, w


def _vis_c(d):
    return d.vis[..., 0] + 1j * d.vis[..., 1]


@pytest.mark.parametrize("name,n_chans,drops", [
    ("fx4", 64, ()), ("fx4", 64, (1,)), ("fx64", 32, (2,))])
def test_runner_matches_jax_and_golden(name, n_chans, drops):
    """Scaled fx4 and fx64 at full antenna width (64 x 2) with narrow
    channels: equal dump metadata (drops included), visibilities equal
    to JAX's up to boundary flips, both >50 dB against golden."""
    cfg = scaled_for_test(get_config(name), n_chans=n_chans,
                          spectra_per_chunk=8).replace(n_spectra_per_acc=16)
    n_chunks = 4
    stream, src, gains, gains_ri, w = _setup(cfg, n_chunks, seed=6)
    jdm, pdm = _delay_models(cfg, seed=5)
    jd, jc = JaxRunner(cfg, w, delay_model=jdm, gains=gains_ri,
                       impl="jnp").run(src, n_chunks, drop_chunks=drops)
    pd, pc = FXRunner(cfg, w, delay_model=pdm, gains=gains_ri,
                      device="cpu").run(src, n_chunks, drop_chunks=drops)
    assert len(jd) == len(pd) == 2
    faulted = stream.copy()
    for i in drops:
        faulted[..., i * cfg.chunk_samples:(i + 1) * cfg.chunk_samples] = 0
    spec_g = jax_verify._golden_spectra(cfg, faulted, jdm, gains, n_chunks,
                                        w)
    for i, (a, b) in enumerate(zip(jd, pd)):
        assert (a.n_spectra, a.n_spectra_nominal, a.first_chunk) == \
            (b.n_spectra, b.n_spectra_nominal, b.first_chunk)
        assert b.vis.dtype == np.int32 and b.vis.shape == a.vis.shape
        assert snr_db(_vis_c(a), _vis_c(b)) > VIS_SNR_VS_JAX
        vis_g = golden.xcorr(spec_g[:, :, i * 16:(i + 1) * 16])
        assert snr_db(vis_g, _vis_c(a)) > 50
        assert snr_db(vis_g, _vis_c(b)) > 50
    assert (jc.chunks_in, jc.chunks_dropped, jc.samples_in, jc.spectra_out,
            jc.dumps) == (pc.chunks_in, pc.chunks_dropped, pc.samples_in,
                          pc.spectra_out, pc.dumps)


@pytest.mark.parametrize("native_order", [False, True])
def test_resume_from_jax_checkpoint(tmp_path, native_order):
    """JAX runs 2 chunks and saves; the port loads the checkpoint and runs
    2 more: the dump matches JAX running all 4.  Once with the sample-axis
    history of the jnp runner, once with the accumulator handed over in
    the fused path's native channel order and put back by
    ``channel_perm``."""
    cfg = scaled_for_test(get_config("fx4"), n_chans=256,
                          spectra_per_chunk=8).replace(
        n_ants=2, n_spectra_per_acc=32)
    stream, src, _, gains_ri, w = _setup(cfg, 4, seed=21)
    jdm, pdm = _delay_models(cfg, seed=22, drift=2e-4)
    want, _ = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                        gains=gains_ri, impl="jnp").run(src, 4)
    first = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                      gains=gains_ri, impl="jnp")
    first.run(src, 2)
    path = save_state(first, str(tmp_path / "state"))
    perm = None
    if native_order:
        perm = native_channel_perm(cfg.n_chans)
        z = dict(np.load(path))
        native = np.empty_like(z["vis_acc"])
        native[perm] = z["vis_acc"]
        z["vis_acc"] = native
        np.savez(path, **z)
    resumed = FXRunner(cfg, w, delay_model=DelayModel.zeros(2, 2, 8),
                       device="cpu")
    load_jax_checkpoint(resumed, path, channel_perm=perm)
    assert resumed.chunk_idx == 2 and resumed.t0 == 2 * cfg.chunk_samples
    np.testing.assert_array_equal(resumed.delay_model.d1, jdm.d1)
    got, counters = resumed.run(src, 2)
    assert counters.chunks_in == 4 and len(got) == 1
    assert (got[0].n_spectra, got[0].first_chunk) == (32, 0)
    assert snr_db(_vis_c(want[0]), _vis_c(got[0])) > VIS_SNR_VS_JAX


def test_tensor_source_equals_numpy_source():
    """A source that hands over tensors (on the card, chunks made there)
    takes the same coarse shift as a numpy source, in either layout."""
    cfg = scaled_for_test(get_config("fx4"), n_chans=32).replace(
        n_spectra_per_acc=16)
    _, src, _, gains_ri, w = _setup(cfg, 4, seed=8)
    shp = (cfg.n_ants * cfg.n_pols, cfg.spectra_per_chunk, cfg.fft_size)
    sources = (src, lambda i: torch.from_numpy(src(i).copy()),
               lambda i: torch.from_numpy(src(i).reshape(shp).copy()))
    dumps = []
    for source in sources:
        _, pdm = _delay_models(cfg, seed=9, drift=1e-3)
        d, _ = FXRunner(cfg, w, delay_model=pdm, gains=gains_ri,
                        device="cpu").run(source, 4)
        dumps.append(d)
    for d in dumps[1:]:
        for a, b in zip(dumps[0], d):
            np.testing.assert_array_equal(a.vis, b.vis)


def test_checkpoint_of_another_config_is_refused(tmp_path):
    cfg = scaled_for_test(get_config("fx4"), n_chans=32)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    path = save_state(JaxRunner(cfg, w, impl="jnp"), str(tmp_path / "s"))
    other = cfg.replace(n_spectra_per_acc=16)
    with pytest.raises(ValueError, match="config hash"):
        load_jax_checkpoint(FXRunner(other, w, device="cpu"), path)


def test_verify_fx4_scaled_on_cpu():
    snrs, counters = port_verify.verify_config("fx4", device="cpu",
                                               scale=64, n_chunks=2)
    assert snrs["visibilities"] > port_verify.SNR_BOUND
    assert counters.dumps == 2


def test_copies_equal_the_jax_package():
    """DelayModel, snr_db and the golden-oracle helpers are numpy copies
    (their JAX-package modules import jax); they must not drift."""
    rng = np.random.default_rng(0)
    jdm, pdm = JaxDelayModel.zeros(3, 2, 16), DelayModel.zeros(3, 2, 16)
    for dm in (jdm, pdm):
        dm.update(t_ref=0, d0=np.full((3, 2), 5.3), d1=1e-5, d2=1e-12,
                  p0=0.2, p1=1e-6, p2=1e-14)
        dm.update(t_ref=4096, d0=6.1)
    for t0 in (0, 8192, 10**6):
        for x, y in zip(jdm.evaluate_chunk(t0, 8, 256),
                        pdm.evaluate_chunk(t0, 8, 256)):
            np.testing.assert_array_equal(x, y)
    g = rng.normal(size=(4, 5)) + 1j * rng.normal(size=(4, 5))
    t = g + 1e-3 * rng.normal(size=(4, 5))
    for a, b in ((g, t), (g, g), (np.zeros(3), np.ones(3))):
        assert snr_db(a, b) == jax_snr_db(a, b)
    cfg = scaled_for_test(get_config("fx4"), n_chans=32).replace(n_ants=2)
    stream = golden.gaussian_noise_int8((2, 2, 2 * cfg.chunk_samples),
                                        20.0, 1)
    jdm, pdm = _delay_models(cfg, seed=2, drift=1e-3)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    gains = np.full(cfg.n_chans, 0.05) + 0j
    np.testing.assert_array_equal(
        port_verify._golden_coarse_stream(cfg, stream, pdm, 2),
        jax_verify._golden_coarse_stream(cfg, stream, jdm, 2))
    np.testing.assert_array_equal(
        port_verify._golden_spectra(cfg, stream, pdm, gains, 2, w),
        jax_verify._golden_spectra(cfg, stream, jdm, gains, 2, w))
    wt, gt = window_and_gains_from_numpy(w, gains, cfg.n_taps, "cpu")
    assert wt.shape == (cfg.n_taps, cfg.fft_size)
    np.testing.assert_array_equal(gt.numpy()[:, 0], np.float32(0.05))
