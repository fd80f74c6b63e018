"""The port's runner in beam mode against the JAX runner (jnp arm) on the
same stream, delay model and weights, against the golden chain, across a
JAX checkpoint and a mid-run re-pointing; plus the port's beam verify."""

import copy

import numpy as np
import pytest

from dc_sand_tpu import golden
from dc_sand_tpu import verify as jax_verify
from dc_sand_tpu.config import ChainConfig, get_config, scaled_for_test
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner, save_state
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import verify as port_verify
from dc_sand_tpu_torch.models.pipeline import make_step
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner,
                                       load_jax_checkpoint)
from dc_sand_tpu_torch.utils import snr_db

# the JAX and port F-engines round the same float32 values, except that a
# value within float32 noise of a .5 boundary may flip one LSB; the beams
# of two float32 beamformers agree to ~140 dB otherwise
SNR_VS_JAX = 60.0
# requant gain: spectra at about 28 LSB rms per component, where one
# boundary flip costs the beams about 81 dB.  At a gain of 0.05 (7 LSB
# rms) a flip cost 69 dB, so about ten flips in a chunk (a flip fraction
# of 4e-5, which two float32 FFTs summing in other orders can give)
# already reached the bound
GAIN = 0.2


def _beam_cfg():
    """beam64 at full antenna width (64 x 2) and 16 beams, 64 channels,
    16-spectra chunks."""
    return scaled_for_test(get_config("beam64"), n_chans=64,
                           spectra_per_chunk=16)


def _setup(cfg, n_chunks, seed):
    rng = np.random.default_rng(seed)
    a, p = cfg.n_ants, cfg.n_pols
    stream = golden.gaussian_noise_int8(
        (a, p, n_chunks * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    gains = np.full(cfg.n_chans, GAIN) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    weights = rng.normal(size=(cfg.n_beams, a, cfg.n_chans, 2)).astype(
        np.float32)
    d0 = rng.integers(0, 8, (a, p)).astype(float)
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    dms = []
    for cls in (JaxDelayModel, DelayModel):
        dm = cls.zeros(a, p, max_delay=8)
        dm.d0, dm.p1 = d0.copy(), p1.copy()
        dm.d1 = np.full((a, p), 2e-4)
        dms.append(dm)
    return (stream, (lambda i: stream[..., i * c:(i + 1) * c]), gains,
            gains_ri, weights, dms,
            pfb_window(cfg.n_taps, cfg.fft_size, cfg.window))


def _collect(outs, device_tensors):
    def on_output(i, o):
        outs.append({k: (v.cpu().numpy() if device_tensors else v)
                     for k, v in o.items()})
    return on_output


def _c(x):
    return x[..., 0] + 1j * x[..., 1]


def test_beam_runner_matches_jax_and_golden():
    """3 chunks, chunk 1 dropped: beams and incoherent beam per chunk
    within boundary flips of JAX's, and both > 50 dB against golden."""
    cfg = _beam_cfg()
    stream, src, gains, gains_ri, weights, (jdm, pdm), w = _setup(cfg, 3, 7)
    j_out, p_out = [], []
    JaxRunner(cfg, w, delay_model=jdm, gains=gains_ri, weights=weights,
              impl="jnp").run(src, 3, on_output=_collect(j_out, False),
                              drop_chunks=(1,))
    runner = FXRunner(cfg, w, delay_model=pdm, gains=gains_ri,
                      weights=weights, device="cpu")
    dumps, counters = runner.run(src, 3, on_output=_collect(p_out, True),
                                 drop_chunks=(1,))
    assert dumps == [] and counters.chunks_dropped == 1
    assert counters.chunks_in == 3 and counters.dumps == 0
    faulted = stream.copy()
    faulted[..., cfg.chunk_samples:2 * cfg.chunk_samples] = 0
    spec_g = jax_verify._golden_spectra(cfg, faulted, jdm, gains, 3, w)
    beams_g = golden.beamform(spec_g, _c(weights))
    inc_g = golden.incoherent_sum(spec_g)
    b = cfg.spectra_per_chunk
    assert len(j_out) == len(p_out) == 3
    for i, (jo, po) in enumerate(zip(j_out, p_out)):
        assert set(po) == {"beams", "incoherent"}
        assert po["beams"].shape == (16, 2, b, 64, 2)
        assert po["beams"].dtype == np.float32
        assert po["incoherent"].shape == (2, b, 64)
        sl = slice(i * b, (i + 1) * b)
        for name, ref in (("beams", beams_g[:, :, sl]),
                          ("incoherent", inc_g[:, sl])):
            got = _c(po[name]) if name == "beams" else po[name]
            want = _c(jo[name]) if name == "beams" else jo[name]
            assert snr_db(want, got) >= SNR_VS_JAX, (i, name)
            assert snr_db(ref, want) > 50 and snr_db(ref, got) > 50


def test_mid_run_repointing():
    """Weights assigned between chunks take effect on the next chunk."""
    cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=32, n_taps=16,
                      spectra_per_chunk=16, apply_requant=True, n_beams=2)
    rng = np.random.default_rng(14)
    w1 = rng.normal(size=(2, 4, 32, 2)).astype(np.float32)
    w2 = rng.normal(size=(2, 4, 32, 2)).astype(np.float32)
    stream = golden.gaussian_noise_int8((4, 2, 3 * cfg.chunk_samples), 20.0,
                                        15)
    c = cfg.chunk_samples
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    outs = []
    r = FXRunner(cfg, window, weights=w1, device="cpu")

    def on_out(i, o):
        outs.append(o["beams"].numpy())
        if i == 1:
            r.weights = w2                      # re-point mid-run

    r.run(lambda i: stream[..., i * c:(i + 1) * c], 3, on_output=on_out)
    spec_g = port_verify._golden_spectra(
        cfg, stream, DelayModel.zeros(4, 2),
        np.full(cfg.n_chans, cfg.quant_scale) + 0j, 3, window)
    for ci, wts in ((1, w1), (2, w2)):
        sl = spec_g[:, :, ci * 16:(ci + 1) * 16]
        assert snr_db(golden.beamform(sl, _c(wts)), _c(outs[ci])) > 50, ci


def test_resume_beam_run_from_jax_checkpoint(tmp_path):
    """JAX runs 2 chunks and saves; the port loads the state (weights and
    the rank-1 dummy accumulator included) and runs the third chunk,
    which matches JAX's third chunk."""
    cfg = _beam_cfg()
    _, src, _, gains_ri, weights, (jdm, _), w = _setup(cfg, 3, 21)
    want = []
    JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm), gains=gains_ri,
              weights=weights, impl="jnp").run(
        src, 3, on_output=_collect(want, False))
    first = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                      gains=gains_ri, weights=weights, impl="jnp")
    first.run(src, 2)
    path = save_state(first, str(tmp_path / "state"))
    resumed = FXRunner(cfg, w, delay_model=DelayModel.zeros(64, 2, 8),
                       device="cpu")
    load_jax_checkpoint(resumed, path)
    np.testing.assert_array_equal(resumed.weights.numpy(), weights)
    assert resumed.chunk_idx == 2
    got = []
    resumed.run(src, 1, on_output=_collect(got, True))
    assert snr_db(_c(want[2]["beams"]), _c(got[0]["beams"])) >= SNR_VS_JAX
    assert snr_db(want[2]["incoherent"], got[0]["incoherent"]) >= SNR_VS_JAX


def test_verify_beam64_scaled_on_cpu():
    snrs, counters = port_verify.verify_config("beam64", device="cpu",
                                               scale=128)
    assert snrs["beams"] > port_verify.SNR_BOUND
    assert snrs["incoherent"] > port_verify.SNR_BOUND
    assert counters.chunks_in == 4


@pytest.mark.parametrize("change,exc,match", [
    (dict(beam_stokes=True, n_pols=1), ValueError, "dual-pol"),
    (dict(beam_parallel=True), ValueError, "requires a mesh"),
    (dict(time_shards=2), ValueError, "SP mode needs a mesh"),
    (dict(apply_requant=False, n_beams=0, run_xengine=True),
     NotImplementedError, "requantisation")])
def test_modes_not_ported_raise(change, exc, match):
    """What the one-device step refuses: the JAX step's validation errors
    (Stokes of single-pol beams; beam-parallel and time-sharded modes
    without a mesh) and fx mode without requantisation, not ported (beam
    mode without it runs: ``tests/test_torch_surface.py``)."""
    cfg = _beam_cfg().replace(**change)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    with pytest.raises(exc, match=match):
        make_step(cfg, w, device="cpu")
