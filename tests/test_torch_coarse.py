"""The device coarse-delay mode (``coarse_on_host=False``) and the gather
that both coarse modes run, on the CPU against the JAX package (jnp arm):

* the plain gather against the JAX ``coarse_delay``, bitwise, in both lead
  forms (the device mode's lead-in history and the host mode's tail);
* ``make_step(..., max_delay=8, coarse_on_host=False)`` in fx, beam and
  fengine mode against the JAX step over chunks whose coarse delay steps
  at a chunk boundary;
* ``FXRunner(coarse_on_host=False)`` ``run`` and ``run_batched`` against the
  JAX runner's device mode, bitwise, on one device and on a CPU mesh; the
  two modes bitwise equal under a constant delay and not under a stepping
  one;
* ``make_sharded_fx_step(max_delay=16)`` at ``tests/test_parallel.py``'s
  shapes;
* the JAX refusals, and the dry run's device-mode legs.

Tests marked ``cuda`` hold the kernel ``csrc/coarse.cu`` to its plain
version on the card (``python -m pytest --noconftest
tests/test_torch_coarse.py -m cuda``).  The JAX package is imported inside
the tests that need it."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch import golden
from dc_sand_tpu_torch.config import ChainConfig, get_config, scaled_for_test
from dc_sand_tpu_torch.models.pipeline import (history_len, history_shape,
                                               make_step, uses_frames_io,
                                               zero_vis_acc)
from dc_sand_tpu_torch.ops.coarse import (carry_lead, coarse_gather,
                                          coarse_gather_torch)
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.utils import np_ri2c, snr_db
from dc_sand_tpu_torch.windows import pfb_window

MAX_DELAY = 8
BEAM_SNR_VS_JAX = 100.0    # two float32 beamformers, summed in other orders
MAX_FLIP_FRACTION = 1e-3   # int8 spectra: single-LSB boundary flips only
# tests/test_torch_runner.py:25-29: the JAX and port F-engines may round a
# value within float32 noise of a .5 boundary apart (an int8 spectrum one
# LSB off); the integer CMAC is bitwise otherwise, so a flip costs the
# visibilities far less than this bound
VIS_SNR_VS_JAX = 60.0


def _cfg(**kw):
    base = dict(name="coarse", n_ants=4, n_pols=2, n_chans=32, n_taps=4,
                spectra_per_chunk=8, n_spectra_per_acc=16, apply_delay=True,
                apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _jax_cfg(cfg):
    from dc_sand_tpu.config import ChainConfig as JaxChainConfig
    return JaxChainConfig(**dataclasses.asdict(cfg))


def _stream(cfg, n_chunks, seed):
    c = cfg.chunk_samples
    x = golden.gaussian_noise_int8((cfg.n_ants, cfg.n_pols, n_chunks * c),
                                   20.0, seed)
    return x, (lambda i: x[..., i * c:(i + 1) * c])


def _delays(cfg, cls, seed, step=True, max_delay=MAX_DELAY):
    """A delay model whose coarse delay steps at chunk boundaries (about
    1.5 samples a chunk) or, with ``step`` False, holds."""
    rng = np.random.default_rng(seed)
    a, p = cfg.n_ants, cfg.n_pols
    dm = cls.zeros(a, p, max_delay=max_delay)
    dm.d0 = rng.uniform(0.0, max_delay / 2, (a, p))
    dm.d1 = (rng.uniform(1.0, 2.0, (a, p)) / cfg.chunk_samples if step
             else np.zeros((a, p)))
    dm.p0 = rng.uniform(-np.pi, np.pi, (a, p))
    dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    return dm


def _gains(cfg, gain=0.05):
    return np.stack([np.full(cfg.n_chans, gain),
                     np.zeros(cfg.n_chans)], -1).astype(np.float32)


def _assert_dumps_equal(got, want, jax=False):
    """Dumps and their metadata equal: bitwise within the port, within the
    boundary flips of the two F-engines against JAX (``jax``)."""
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.n_spectra, a.n_spectra_nominal, a.first_chunk) == \
            (b.n_spectra, b.n_spectra_nominal, b.first_chunk)
        if jax:
            assert a.vis.shape == b.vis.shape
            assert snr_db(np_ri2c(b.vis), np_ri2c(a.vis)) >= VIS_SNR_VS_JAX
        else:
            np.testing.assert_array_equal(a.vis, b.vis)


# ---- the gather -------------------------------------------------------------

@pytest.mark.parametrize("lead_frames", [3, 0])
def test_gather_equals_the_jax_coarse_delay(lead_frames):
    """Delays 0, max_delay and between, in the device mode's lead form
    (``max_delay + 3`` frames) and the host mode's (``max_delay``): the
    history frames and the chunk frames hold the JAX ``coarse_delay`` of
    ``[lead | chunk]``, bitwise; the frames the F-engine skips stay zero."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.fengine import coarse_delay as jax_coarse_delay
    rng = np.random.default_rng(3 + lead_frames)
    s, m, b, md, taps_pad = 6, 32, 5, MAX_DELAY, 8
    lead = rng.integers(-127, 128, (s, md + lead_frames * m), np.int8)
    chunk = rng.integers(-127, 128, (s, b * m), np.int8)
    d = np.array([0, md, 3, 1, 7, 5], np.int32)
    want = np.asarray(jax_coarse_delay(
        jnp.asarray(np.concatenate([lead, chunk], -1)), jnp.asarray(d), md))
    hist = torch.zeros((s, taps_pad, m), dtype=torch.int8)
    out = torch.empty((s, b, m), dtype=torch.int8)
    # the lead as (A, P, L) and the chunk as frames (S, B, M)
    coarse_gather(torch.from_numpy(lead).reshape(3, 2, -1),
                  torch.from_numpy(chunk).reshape(s, b, m),
                  torch.from_numpy(d), md, out=out,
                  hist=hist if lead_frames else None)
    n_h = lead_frames * m
    np.testing.assert_array_equal(out.reshape(s, -1).numpy(), want[:, n_h:])
    h = hist.reshape(s, -1).numpy()
    np.testing.assert_array_equal(h[:, taps_pad * m - n_h:], want[:, :n_h])
    assert not h[:, :taps_pad * m - n_h].any()


def test_coarse_delay_equals_the_jax_one():
    """``models.fengine.coarse_delay`` (the gather over one buffer) on
    ``(A, P, T)`` streams, delays in range."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.fengine import coarse_delay as jax_coarse_delay
    from dc_sand_tpu_torch.models.fengine import coarse_delay
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (3, 2, 16 * 9 + 16), np.int8)
    d = rng.integers(0, 17, (3, 2)).astype(np.int32)
    got = coarse_delay(torch.from_numpy(x), d, 16).numpy()
    want = np.asarray(jax_coarse_delay(jnp.asarray(x), jnp.asarray(d), 16))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [40, 12])
def test_carry_lead_is_the_last_samples(c):
    """The next lead is ``[lead | chunk][..., C:]``, with the chunk longer
    and shorter than the lead."""
    rng = np.random.default_rng(c)
    lead = rng.integers(-127, 128, (2, 3, 24), np.int8)
    chunk = rng.integers(-127, 128, (6, c), np.int8)
    want = np.concatenate([lead, chunk.reshape(2, 3, c)], -1)[..., c:]
    t = torch.from_numpy(lead.copy())
    carry_lead(t, torch.from_numpy(chunk))
    np.testing.assert_array_equal(t.numpy(), want)


def test_history_forms_and_refusals():
    """``history_len``/``history_shape``/``uses_frames_io`` as the JAX
    package's, and its refusals: ``max_delay > 0`` outside the device mode,
    SP with ``max_delay``."""
    from dc_sand_tpu.models import pipeline as jp
    cfg = _cfg()
    assert history_len(cfg, 8) == jp.history_len(_jax_cfg(cfg), 8) \
        == 8 + 3 * cfg.fft_size
    assert history_shape(cfg, max_delay=8) == (4, 2, history_len(cfg, 8))
    assert history_shape(cfg, build_mesh(["cpu"] * 2), 8) == \
        (2, 2, history_len(cfg, 8))
    assert history_shape(cfg) == (8, 8, cfg.fft_size)
    assert history_shape(cfg, max_delay=0) == (4, 2, 3 * cfg.fft_size)
    assert not uses_frames_io(cfg, coarse_on_host=False)
    assert uses_frames_io(cfg) and uses_frames_io(
        cfg.replace(apply_delay=False), coarse_on_host=False)
    w = pfb_window(cfg.n_taps, cfg.fft_size)
    for kw in ({}, {"coarse_on_host": True}):
        with pytest.raises(ValueError, match="max_delay > 0 requires the "
                                             "device coarse path"):
            make_step(cfg, w, device="cpu", max_delay=8, **kw)
    with pytest.raises(ValueError, match="max_delay > 0 requires"):
        make_step(cfg.replace(apply_delay=False), w, device="cpu",
                  max_delay=8, coarse_on_host=False)
    sp = cfg.replace(time_shards=2, spectra_per_chunk=16,
                     n_spectra_per_acc=16)
    with pytest.raises(ValueError, match="SP mode needs coarse delay"):
        history_len(sp, 8)
    mesh = build_mesh(["cpu"] * 4, time_shards=2)
    with pytest.raises(ValueError, match=r"time-sharded \(SP\) mode"):
        make_step(sp, w, mesh=mesh, max_delay=8, coarse_on_host=False)
    with pytest.raises(ValueError, match=r"time-sharded \(SP\) mode"):
        FXRunner(sp, w, delay_model=DelayModel.zeros(4, 2, 8), mesh=mesh,
                 coarse_on_host=False)


# ---- the step ---------------------------------------------------------------

def _step_cases():
    fx = _cfg()
    beam = scaled_for_test(get_config("beam64"), n_chans=32,
                           spectra_per_chunk=8).replace(n_ants=4, n_beams=3)
    fe = scaled_for_test(get_config("pfb4k"), n_chans=64,
                         spectra_per_chunk=8).replace(n_ants=3,
                                                      apply_delay=True)
    return {"fx": fx, "beam": beam, "fengine": fe}


@pytest.mark.parametrize("mode", ["fx", "beam", "fengine"])
def test_step_matches_the_jax_device_mode(mode):
    """Three chunks through ``make_step(..., max_delay=8,
    coarse_on_host=False)`` in both packages, the coarse delays stepping
    at both chunk boundaries: the lead-in carried bitwise (raw samples),
    the fx accumulator within the boundary flips (``VIS_SNR_VS_JAX``),
    int8 spectra within single-LSB boundary flips, float beams >= 100 dB
    and the incoherent beam bitwise."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.pipeline import make_step as jax_make_step
    from dc_sand_tpu.models.pipeline import zero_vis_acc as jax_zero_acc
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    cfg = _step_cases()[mode]
    a, p, k, b = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.spectra_per_chunk
    c = cfg.chunk_samples
    x, src = _stream(cfg, 3, seed=21)
    dm = _delays(cfg, JaxDelayModel, seed=22)
    coarse = [dm.evaluate_chunk(i * c, b, cfg.fft_size) for i in range(3)]
    assert (coarse[0][0] != coarse[1][0]).any()
    assert (coarse[1][0] != coarse[2][0]).any()
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    gains = _gains(cfg)
    rng = np.random.default_rng(23)
    weights = rng.normal(size=(max(cfg.n_beams, 1), a, k, 2)).astype(
        np.float32)
    jstep = jax_make_step(_jax_cfg(cfg), w, max_delay=MAX_DELAY, impl="jnp",
                          donate=False, coarse_on_host=False)
    pstep = make_step(cfg, w, device="cpu", max_delay=MAX_DELAY,
                      coarse_on_host=False)
    jh = jnp.zeros((a, p, history_len(cfg, MAX_DELAY)), jnp.int8)
    jacc = jax_zero_acc(_jax_cfg(cfg))
    ph = torch.zeros(history_shape(cfg, max_delay=MAX_DELAY),
                     dtype=torch.int8)
    pacc = zero_vis_acc(cfg, "cpu")
    for i, (co, fr, pp) in enumerate(coarse):
        jh, jacc, jout = jstep(jh, jacc, jnp.asarray(src(i)),
                               jnp.asarray(co), jnp.asarray(fr),
                               jnp.asarray(pp), jnp.asarray(gains),
                               jnp.asarray(weights), jnp.asarray(i == 0))
        pout = pstep(ph, pacc, torch.from_numpy(src(i)),
                     torch.from_numpy(co.reshape(-1)),
                     torch.from_numpy(fr.reshape(a * p, b)),
                     torch.from_numpy(pp.reshape(a * p, b)),
                     torch.from_numpy(gains), torch.from_numpy(weights),
                     i == 0)
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
        if mode == "fengine":
            got, want = pout["spectra"].numpy(), np.asarray(jout["spectra"])
            assert got.shape == want.shape == (a, p, b, k, 2)
            diff = np.abs(got.astype(np.int16) - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= \
                MAX_FLIP_FRACTION
        if mode == "beam":
            got, want = pout["beams"].numpy(), np.asarray(jout["beams"])
            assert got.shape == want.shape
            assert snr_db(np_ri2c(want), np_ri2c(got)) >= BEAM_SNR_VS_JAX
            np.testing.assert_array_equal(pout["incoherent"].numpy(),
                                          np.asarray(jout["incoherent"]))
    if mode == "fx":
        want = np.asarray(jacc).astype(np.float64)
        err = pacc.numpy() - want
        assert 10 * np.log10((want ** 2).sum() / max((err ** 2).sum(),
                                                     1e-30)) >= \
            VIS_SNR_VS_JAX


# ---- the runner -------------------------------------------------------------

def _jax_dumps(cfg, src, n, dm, gains, batched=False, drops=(), **kw):
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    r = JaxRunner(_jax_cfg(cfg), pfb_window(cfg.n_taps, cfg.fft_size),
                  delay_model=dm, gains=gains, impl="jnp", **kw)
    fn = r.run_batched if batched else r.run
    return fn(src, n, drop_chunks=drops)[0]


def _port(cfg, dm, gains, **kw):
    if "mesh" not in kw:
        kw.setdefault("device", "cpu")
    return FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size),
                    delay_model=dm, gains=gains, **kw)


@pytest.mark.parametrize("spectra,drops", [(8, ()), (8, (2,)), (6, (1,))])
def test_runner_matches_the_jax_device_mode(spectra, drops):
    """``run`` and ``run_batched`` in the device mode, the coarse delay
    stepping every chunk (6-spectra chunks too, a ragged count): dumps
    and their metadata those of the JAX runner's device mode (within
    boundary flips), and ``run_batched`` bitwise ``run``."""
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    cfg = _cfg(spectra_per_chunk=spectra, n_spectra_per_acc=2 * spectra)
    _, src = _stream(cfg, 4, seed=31)
    gains = _gains(cfg)
    want = _jax_dumps(cfg, src, 4, _delays(cfg, JaxDelayModel, 32), gains,
                      drops=drops, coarse_on_host=False)
    got, counters = _port(cfg, _delays(cfg, DelayModel, 32), gains,
                          coarse_on_host=False).run(src, 4, drop_chunks=drops)
    _assert_dumps_equal(got, want, jax=True)
    assert counters.chunks_dropped == len(drops)
    r = _port(cfg, _delays(cfg, DelayModel, 32), gains, coarse_on_host=False)
    assert r._tail is None and not r.coarse_on_host
    assert tuple(r.history[0].shape) == (4, 2, history_len(cfg, MAX_DELAY))
    batched, _ = r.run_batched(src, 4, drop_chunks=drops)
    _assert_dumps_equal(batched, got)


@pytest.mark.parametrize("time_shards", [1, 2])
def test_mesh_runner_in_the_device_mode(time_shards):
    """On a 4-way fx CPU mesh each shard gathers its own antennas: dumps
    bitwise the one-device device mode's (stepping delays, a drop); on a
    (time 2, fx 2) mesh, coarse delay off in the model, the device mode
    runs SP as the host mode does."""
    cfg = _cfg(n_ants=8, n_chans=32, time_shards=time_shards,
               spectra_per_chunk=16, n_spectra_per_acc=32)
    _, src = _stream(cfg, 4, seed=41)
    gains = _gains(cfg)
    md = MAX_DELAY if time_shards == 1 else 0
    want, _ = _port(cfg.replace(time_shards=1),
                    _delays(cfg, DelayModel, 42, max_delay=md), gains,
                    coarse_on_host=False).run(src, 4, drop_chunks=(1,))
    mesh = build_mesh(["cpu"] * 4, time_shards=time_shards)
    r = _port(cfg, _delays(cfg, DelayModel, 42, max_delay=md), gains,
              mesh=mesh, coarse_on_host=False)
    got, _ = r.run(src, 4, drop_chunks=(1,))
    _assert_dumps_equal(got, want)


def test_modes_equal_under_a_constant_delay_only():
    """From stream start the two coarse modes give bitwise the same dumps
    while each coarse delay holds, and different dumps where it steps at
    a chunk boundary (the device mode gathers the FIR overlap again with
    the new delay)."""
    cfg = _cfg()
    _, src = _stream(cfg, 4, seed=51)
    gains = _gains(cfg)
    for step, equal in ((False, True), (True, False)):
        host, _ = _port(cfg, _delays(cfg, DelayModel, 52, step=step),
                        gains).run(src, 4)
        dev, _ = _port(cfg, _delays(cfg, DelayModel, 52, step=step), gains,
                       coarse_on_host=False).run(src, 4)
        assert all(np.array_equal(a.vis, b.vis)
                   for a, b in zip(host, dev)) == equal


@pytest.mark.parametrize("mode", ["beam", "fengine"])
def test_per_chunk_outputs_match_the_jax_device_mode(mode):
    """beam and fengine mode through the runner in the device mode: the
    per-chunk outputs within the tolerances of the step test."""
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    cfg = _step_cases()[mode]
    _, src = _stream(cfg, 3, seed=61)
    gains = _gains(cfg)
    rng = np.random.default_rng(62)
    weights = (rng.normal(size=(cfg.n_beams, cfg.n_ants, cfg.n_chans, 2))
               .astype(np.float32) if cfg.n_beams else None)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    j_out, p_out = [], []
    JaxRunner(_jax_cfg(cfg), w, delay_model=_delays(cfg, JaxDelayModel, 63),
              gains=gains, weights=weights, impl="jnp",
              coarse_on_host=False).run(
        src, 3, on_output=lambda i, o: j_out.append(o))
    FXRunner(cfg, w, delay_model=_delays(cfg, DelayModel, 63), gains=gains,
             weights=weights, device="cpu", coarse_on_host=False).run(
        src, 3, on_output=lambda i, o: p_out.append(
            {k: v.numpy() for k, v in o.items()}))
    assert len(j_out) == len(p_out) == 3
    for jo, po in zip(j_out, p_out):
        if mode == "fengine":
            diff = np.abs(po["spectra"].astype(np.int16) - jo["spectra"])
            assert diff.max() <= 1 and (diff > 0).mean() <= \
                MAX_FLIP_FRACTION
        else:
            assert snr_db(np_ri2c(jo["beams"]), np_ri2c(po["beams"])) >= \
                BEAM_SNR_VS_JAX
            np.testing.assert_array_equal(po["incoherent"],
                                          jo["incoherent"])


def test_sharded_fx_step_with_coarse_delays_matches_jax():
    """``make_sharded_fx_step(max_delay=16)`` on 4 CPU shards at the shapes
    of ``tests/test_parallel.py:125-153`` against the JAX sharded step
    (jnp arm) within boundary flips, ``fx_step_local`` bitwise the sharded
    step, and > 50 dB against golden."""
    import jax.numpy as jnp
    from dc_sand_tpu import golden as jg
    from dc_sand_tpu.models.fx import make_sharded_fx_step as jax_sharded
    from dc_sand_tpu.parallel import build_mesh as jax_build_mesh
    from dc_sand_tpu_torch.models.fx import (fx_step_local,
                                             make_sharded_fx_step)
    from dc_sand_tpu_torch.utils.cplx import np_c2ri
    taps, n_chans, m = 4, 64, 128
    n_ants, n_pols, nb = 8, 2, 8
    n = (nb + taps - 1) * m + 16
    rng = np.random.default_rng(1)
    x = golden.gaussian_noise_int8((n_ants, n_pols, n), 20.0, 2)
    cd = rng.integers(0, 16, (n_ants, n_pols))
    fd = rng.uniform(-0.5, 0.5, (n_ants, n_pols, nb))
    ph = rng.uniform(-np.pi, np.pi, (n_ants, n_pols, nb))
    g = np.full(n_chans, 0.05) * np.exp(
        1j * rng.uniform(-np.pi, np.pi, n_chans))
    w = pfb_window(taps, m)
    gri = np_c2ri(g).astype(np.float32)
    want = np.asarray(jax_sharded(
        jax_build_mesh(n_devices=4), w, taps, n_chans, n_ants, impl="jnp",
        max_delay=16)(jnp.asarray(x), jnp.asarray(fd, jnp.float32),
                      jnp.asarray(ph, jnp.float32), jnp.asarray(gri),
                      jnp.asarray(cd, jnp.int32)))
    args = (torch.from_numpy(x), torch.as_tensor(fd, dtype=torch.float32),
            torch.as_tensor(ph, dtype=torch.float32), torch.from_numpy(gri))
    got = make_sharded_fx_step(build_mesh(["cpu"] * 4), w, taps, n_chans,
                               n_ants, max_delay=16)(
        *args, torch.from_numpy(cd)).numpy()
    assert got.shape == want.shape
    assert snr_db(np_ri2c(want), np_ri2c(got)) >= VIS_SNR_VS_JAX
    local = fx_step_local(x, w, taps, n_chans, frac_delay=args[1],
                          phase=args[2], gains=args[3], coarse_delays=cd,
                          max_delay=16).numpy()
    np.testing.assert_array_equal(local, got)
    spec_g = jg.f_engine(x, w, taps, n_chans, coarse_delays=cd,
                         max_delay=16, frac_delay=fd, phase=ph, gains=g)
    assert snr_db(jg.xcorr(spec_g), np_ri2c(got)) > 50


def test_dryrun_legs_run_the_device_mode(monkeypatch):
    """``dryrun_multichip(4)`` on CPU shards: the fx, beam and
    beam_parallel legs gather in the step, one gather a shard (and no
    feed shift), the others on the feed; every leg equals one device."""
    from dc_sand_tpu_torch.dryrun import (DEVICE_COARSE, dryrun_multichip,
                                          dryrun_reference)
    from dc_sand_tpu_torch.models import pipeline
    from dc_sand_tpu_torch.runtime import runner as runner_mod
    calls = {"step": 0, "feed": 0}

    def counting(where, fn):
        def wrapped(*a, **k):
            calls[where] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(pipeline, "coarse_gather",
                        counting("step", pipeline.coarse_gather))
    monkeypatch.setattr(runner_mod, "coarse_gather",
                        counting("feed", runner_mod.coarse_gather))
    assert DEVICE_COARSE == ("fx", "beam", "beam_parallel")
    got = dryrun_multichip(4, ["cpu"] * 4)
    # 4 shards a leg; the sp legs, time_fengine and fused_fx: the feed,
    # once a runner whose model has a coarse delay
    assert calls["step"] == 4 * len(DEVICE_COARSE)
    assert calls["feed"] == 3
    ref = dryrun_reference(4, device="cpu")
    for name in DEVICE_COARSE:
        for key, v in got[name].outputs.items():
            want = ref[name].outputs[key]
            if key == "beams":
                assert snr_db(np_ri2c(want), np_ri2c(v)) >= BEAM_SNR_VS_JAX
            else:
                np.testing.assert_array_equal(v, want)


@pytest.mark.parametrize("target", ["fx", "beam-step"])
def test_cli_bench_spectra(target, capsys):
    """``cli bench --spectra`` (the JAX CLI's option) sets the step
    benches' spectra per chunk."""
    import json
    from dc_sand_tpu_torch import cli
    assert cli.main(["bench", target, "--cpu", "--scale", "32",
                     "--spectra", "8"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["extra"]["n_spectra"] == 8 and rec["extra"]["n_chans"] == 32


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the coarse gather kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,lead_frames,md", [
    (8192, 3, 15, 32), (8192, 2, 0, 32), (64, 24, 3, 8), (48, 5, 3, 7),
    (64, 1, 3, 8), (32, 8, 7, 0)])
def test_kernel_equals_plain(cuda, m, b, lead_frames, md):
    """The gather kernel against its plain version, bitwise, at delays
    0..md: wide and narrow frames, both lead forms, a frame of 48 (the
    byte path), one spectrum (the lead longer than the chunk), md 0."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + b + md)
    s, tp = 24, 16
    lead = torch.randint(-127, 128, (s, md + lead_frames * m), generator=gen,
                         device=cuda, dtype=torch.int8)
    chunk = torch.randint(-127, 128, (s, b, m), generator=gen, device=cuda,
                          dtype=torch.int8)
    d = torch.arange(s, device=cuda, dtype=torch.int32) % (md + 1)
    outs = []
    for impl in ("cuda", "torch"):
        hist = torch.zeros((s, tp, m), dtype=torch.int8, device=cuda)
        out = torch.empty((s, b, m), dtype=torch.int8, device=cuda)
        coarse_gather(lead, chunk, d, md, out=out,
                      hist=hist if lead_frames else None, impl=impl)
        outs.append((hist, out))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("on_host,spectra", [(False, 16), (True, 16),
                                             (False, 24)])
@pytest.mark.cuda
def test_runner_gathers_with_the_kernel_on_the_card(cuda, monkeypatch,
                                                    on_host, spectra):
    """Both coarse modes on the card (and the device mode at a ragged 24
    spectra): one gather launch a chunk (the step's or the feed's), dumps
    bitwise the same runs through the plain gather on the card, and in
    the device mode ``run_batched``'s graph (the gather captured) bitwise
    ``run``."""
    from dc_sand_tpu_torch.models import pipeline
    from dc_sand_tpu_torch.runtime import runner as runner_mod
    cfg = _cfg(n_chans=256, spectra_per_chunk=spectra,
               n_spectra_per_acc=4 * spectra)
    _, src = _stream(cfg, 8, seed=71)
    gains = _gains(cfg)

    def run(**kw):
        return _port(cfg, _delays(cfg, DelayModel, 72), gains, device=cuda,
                     coarse_on_host=on_host, **kw)

    coarse_gather.launches = 0
    got, _ = run().run(src, 8)
    assert coarse_gather.launches == 8
    plain = functools.partial(coarse_gather, impl="torch")
    with monkeypatch.context() as m:
        m.setattr(pipeline, "coarse_gather", plain)
        m.setattr(runner_mod, "coarse_gather", plain)
        want, _ = run().run(src, 8)
    _assert_dumps_equal(got, want)
    if on_host:
        return
    r = run()
    batched, _ = r.run_batched(src, 8)
    _assert_dumps_equal(batched, got)
    assert r.graph_launches["coarse"] == 4 and r.graph_replays == 2

