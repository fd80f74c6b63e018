"""The leftover pieces of the port's surface against the JAX package on
the CPU: K1's ``wire_flat`` layout, beam mode on spectra that are not
requantised (K1-float, then the float beam product), the one-shot
``ops.xcorr`` and ``ops.incoherent_sum``, and ``--profile DIR`` of the
bench entry and the command line."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_sand_tpu import ops as jax_ops
from dc_sand_tpu.config import ChainConfig as JaxChainConfig
from dc_sand_tpu.ops.fengine_fused import fengine_fused as jx_fengine_fused
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import cli, golden, ops
from dc_sand_tpu_torch.bench.__main__ import main as bench_main
from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.utils import snr_db

# float32 beams of the same float32 spectra, summed in another order:
# about 140 dB apart; a wrong weight, sign or channel is far below
BEAM_SNR = 100.0


def _c(x):
    return x[..., 0] + 1j * x[..., 1]


# ---- wire_flat -------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_wire_flat_is_the_wire_bytes_and_matches_jax(fused):
    """``layout="wire_flat"`` is the wire output's bytes viewed ``(..., B,
    2K)``, on the fused and the unfused path, and equals the JAX fused
    F-engine's ``wire_flat`` (Pallas, interpret mode) up to single-LSB
    boundary flips."""
    taps, nch, s, b = 16, 512, 2, 16
    m = 2 * nch
    tp = taps_pad_for(taps)
    rng = np.random.default_rng(5)
    hist = golden.gaussian_noise_int8((s, tp * m), 20.0, 5).reshape(s, tp, m)
    chunk = golden.gaussian_noise_int8((s, b * m), 20.0, 6).reshape(s, b, m)
    gains = np.stack([np.full(nch, 0.05), rng.uniform(-0.01, 0.01, nch)],
                     -1).astype(np.float32)
    w = pfb_window(taps, m)
    t = torch.from_numpy
    wire = f_engine(t(chunk), w, taps, nch, history=t(hist), gains=t(gains),
                    fused=fused)
    flat = f_engine(t(chunk), w, taps, nch, history=t(hist), gains=t(gains),
                    layout="wire_flat", fused=fused)
    assert flat.shape == (s, b, 2 * nch) and flat.dtype == torch.int8
    assert torch.equal(flat, wire.reshape(s, b, 2 * nch))
    want = np.asarray(jx_fengine_fused(
        jnp.asarray(chunk), w, taps, nch, history=jnp.asarray(hist),
        gains=jnp.asarray(gains), layout="wire_flat", interpret=True,
        strict=True))
    assert want.shape == flat.shape
    diff = np.abs(flat.numpy().astype(np.int16) - want)
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    # float spectra (no gains): the same view
    fl = fengine_fused(t(chunk), w, taps, nch, history=t(hist),
                       layout="wire_flat")
    assert fl.dtype == torch.float32 and fl.shape == (s, b, 2 * nch)


# ---- beam mode without requantisation -------------------------------------

def _beam_cfg(cls, **kw):
    base = dict(name="beamfloat", n_ants=8, n_pols=2, n_chans=64, n_taps=16,
                spectra_per_chunk=16, apply_delay=True, apply_requant=False,
                n_beams=4, incoherent_beam=True)
    base.update(kw)
    return cls(**base)


def _beam_setup(cfg, n_chunks, seed):
    rng = np.random.default_rng(seed)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    stream = golden.gaussian_noise_int8((a, p, n_chunks * c), 20.0, seed)
    weights = rng.normal(size=(cfg.n_beams, a, cfg.n_chans, 2)).astype(
        np.float32)
    d0 = rng.integers(0, 8, (a, p)).astype(float)
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))

    def dm(cls):
        model = cls.zeros(a, p, max_delay=8)
        model.d0, model.p1 = d0.copy(), p1.copy()
        return model

    return (lambda i: stream[..., i * c:(i + 1) * c]), weights, dm


def _collect(outs):
    return lambda i, o: outs.append({k: np.asarray(v.cpu() if isinstance(
        v, torch.Tensor) else v) for k, v in o.items()})


@pytest.mark.parametrize("stokes", [False, True])
def test_beam_mode_without_requant_matches_jax(stokes):
    """Float spectra (K1-float's plain version) into the float beam
    product: three chunks of beams, incoherent beam and Stokes against the
    JAX runner's (jnp arm), >= BEAM_SNR dB, and no beam-kernel launch."""
    src, weights, dm = _beam_setup(_beam_cfg(ChainConfig), 3, seed=11)
    w = pfb_window(16, 128)
    want, got = [], []
    JaxRunner(_beam_cfg(JaxChainConfig, beam_stokes=stokes), w,
              delay_model=dm(JaxDelayModel), weights=weights,
              impl="jnp").run(src, 3, on_output=_collect(want))
    launches = ops.beamform.launches
    FXRunner(_beam_cfg(ChainConfig, beam_stokes=stokes), w,
             delay_model=dm(DelayModel), weights=weights,
             device="cpu").run(src, 3, on_output=_collect(got))
    assert ops.beamform.launches == launches
    assert len(want) == len(got) == 3
    for j, g in zip(want, got):
        assert set(j) == set(g)
        assert g["beams"].dtype == np.float32
        assert g["beams"].shape == j["beams"].shape == (4, 2, 16, 64, 2)
        assert snr_db(_c(j["beams"]), _c(g["beams"])) >= BEAM_SNR
        assert snr_db(j["incoherent"], g["incoherent"]) >= BEAM_SNR
        if stokes:
            assert snr_db(j["stokes"], g["stokes"]) >= BEAM_SNR


@pytest.mark.parametrize("beam_parallel", [False, True])
def test_beam_mode_without_requant_on_a_mesh(beam_parallel):
    """The same on a 2-shard CPU mesh, partial float beams summed over fx
    (``psum``) or reduce-scattered (``psum_scatter``): beams and the
    incoherent beam (float sums too) >= BEAM_SNR dB from the one-device
    runner."""
    cfg = _beam_cfg(ChainConfig)
    src, weights, dm = _beam_setup(cfg, 2, seed=12)
    w = pfb_window(16, 128)
    one, got = [], []
    FXRunner(cfg, w, delay_model=dm(DelayModel), weights=weights,
             device="cpu").run(src, 2, on_output=_collect(one))
    FXRunner(cfg.replace(beam_parallel=beam_parallel), w,
             delay_model=dm(DelayModel), weights=weights,
             mesh=build_mesh(["cpu"] * 2)).run(src, 2,
                                               on_output=_collect(got))
    for a, g in zip(one, got):
        assert snr_db(_c(a["beams"]), _c(g["beams"])) >= BEAM_SNR
        assert snr_db(a["incoherent"], g["incoherent"]) >= BEAM_SNR


def test_fx_mode_without_requant_still_refused():
    cfg = _beam_cfg(ChainConfig, n_beams=0, run_xengine=True)
    with pytest.raises(NotImplementedError, match="fx mode without"):
        FXRunner(cfg, pfb_window(16, 128), device="cpu")


# ---- ops.xcorr and ops.incoherent_sum -------------------------------------

@pytest.mark.parametrize("b", [1, 13, 32])
def test_xcorr_one_shot_matches_jax(b):
    rng = np.random.default_rng(b)
    q = rng.integers(-127, 128, (6, 5, 2, b, 2), dtype=np.int8)
    got = ops.xcorr(torch.from_numpy(q))
    want = np.asarray(jax_ops.xcorr(jnp.asarray(q)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["int8", "float32", "complex64"])
def test_incoherent_sum_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "int8":
        x = rng.integers(-127, 128, (7, 2, 5, 24, 2), dtype=np.int8)
    else:
        x = rng.normal(size=(7, 2, 5, 24, 2)).astype(np.float32)
        if kind == "complex64":
            x = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    got = ops.incoherent_sum(torch.from_numpy(x))
    want = np.asarray(jax_ops.incoherent_sum(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 5,
                                                                      24)
    if kind == "int8":      # integer sums, exact in float32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---- --profile -------------------------------------------------------------

def _trace_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events
    return events


def test_bench_profile_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    assert bench_main(["pfb", "--device", "cpu", "--scale", "16",
                       "--spectra", "8", "--profile", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["name"] == "fengine_pfb_fused"
    names = {e.get("name", "") for e in _trace_events(out / "pfb_trace.json")}
    assert any(n.startswith("aten::") for n in names)


def test_cli_bench_profile_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    assert cli.main(["bench", "fft", "--cpu", "--scale", "32", "--spectra",
                     "8", "--profile", str(out)]) == 0
    assert capsys.readouterr().out.strip()
    assert os.listdir(out) == ["fft_trace.json"]
    assert _trace_events(out / "fft_trace.json")
