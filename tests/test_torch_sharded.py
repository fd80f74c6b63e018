"""The port's sharded steps on a CPU mesh: against the port's own
one-device step (bitwise where the JAX package's tests hold the sharded
step bitwise), against the JAX package's sharded step and runner, and
against the golden chain.

Streams, delays, gains and weights come from numpy seeds and are fed to
both packages.  The port's mesh is ``build_mesh(["cpu"] * n)``; on the
CPU every collective runs its plain version."""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dc_sand_tpu import golden, ops as jax_ops
from dc_sand_tpu import verify as jax_verify
from dc_sand_tpu.config import ChainConfig, get_config, scaled_for_test
from dc_sand_tpu.models.fx import (make_sharded_fx_step as jax_sharded_fx,
                                   make_time_sharded_fengine as jax_sp_fe)
from dc_sand_tpu.models.pipeline import make_step as jax_make_step
from dc_sand_tpu.parallel import FX_AXIS as J_FX
from dc_sand_tpu.parallel import build_mesh as jax_build_mesh
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner, save_state
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import verify as port_verify
from dc_sand_tpu_torch.models.fx import (fx_step_local, make_sharded_fx_step,
                                         make_time_sharded_fengine)
from dc_sand_tpu_torch.models.pipeline import (chunk_shape, history_shape,
                                               make_step, zero_vis_acc)
from dc_sand_tpu_torch.ops.beamform import beamform
from dc_sand_tpu_torch.parallel import (FX_AXIS, build_mesh, psum,
                                        psum_scatter)
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner,
                                       load_jax_checkpoint)
from dc_sand_tpu_torch.utils import snr_db

try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

# as tests/test_torch_runner.py: the two packages' F-engines may round a
# value within float32 noise of a .5 boundary apart; the visibilities are
# bitwise equal otherwise
VIS_SNR_VS_JAX = 60.0
# as tests/test_torch_beam_runner.py: beams of the two packages' float32
# beamformers agree to about 140 dB but for such boundary flips, each of
# which costs the beams about 81 dB at this requant gain (spectra at about
# 28 LSB rms per component)
BEAM_SNR_VS_JAX, BEAM_GAIN = 60.0, 0.2
N_CHANS, TAPS = 64, 4
M = 2 * N_CHANS


def _cfg(**kw):
    base = dict(name="t", n_ants=8, n_pols=2, n_chans=N_CHANS, n_taps=TAPS,
                spectra_per_chunk=16, n_spectra_per_acc=32,
                apply_delay=True, apply_requant=True)
    base.update(kw)
    return ChainConfig(**base)


def _stream(cfg, n_chunks, seed):
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, n_chunks * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    return stream, (lambda i: stream[..., i * c:(i + 1) * c])


def _dm(cfg, seed, cls=DelayModel):
    rng = np.random.default_rng(seed)
    dm = cls.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
    dm.d0 = rng.integers(0, 8, (cfg.n_ants, cfg.n_pols)).astype(float)
    dm.p1 = rng.uniform(-1e-6, 1e-6, (cfg.n_ants, cfg.n_pols))
    dm.d1 = np.full((cfg.n_ants, cfg.n_pols), 1e-4)
    return dm


def _mesh(n, time_shards=1):
    return build_mesh(["cpu"] * n, time_shards=time_shards)


def _run(cfg, src, n_chunks, seed=5, weights=None, drops=(), **kw):
    outs = []
    dumps, counters = FXRunner(
        cfg, pfb_window(cfg.n_taps, cfg.fft_size), delay_model=_dm(cfg, seed),
        weights=weights, **kw).run(
        src, n_chunks, drop_chunks=drops,
        on_output=lambda i, o: outs.append(o))
    return dumps, outs, counters


def _c(x):
    x = np.asarray(x)
    return x[..., 0] + 1j * x[..., 1]


# ---- the step, against the port's one-device step ------------------------

def test_fx_step_on_4_shards_accumulates_bitwise():
    """One chunk through the fx step on a 4-way fx mesh: the gathered
    channel blocks equal the one-device packed accumulator bitwise, and
    the carried history equals the one-device carry row by row."""
    cfg = _cfg(run_xengine=True)
    mesh = _mesh(4)
    rng = np.random.default_rng(1)
    w = pfb_window(TAPS, M)
    hist = rng.integers(-127, 128, history_shape(cfg)).astype(np.int8)
    chunk = rng.integers(-127, 128, chunk_shape(cfg)).astype(np.int8)
    frac = rng.uniform(-0.5, 0.5, chunk_shape(cfg)[:2]).astype(np.float32)
    phase = rng.uniform(-3, 3, chunk_shape(cfg)[:2]).astype(np.float32)
    gains = torch.tensor([[0.05, 0.01]]).expand(N_CHANS, 2).contiguous()
    t = torch.from_numpy
    h1, acc1 = t(hist.copy()), zero_vis_acc(cfg, "cpu")
    make_step(cfg, w, device="cpu")(h1, acc1, t(chunk), t(frac), t(phase),
                                    gains, None, True)
    rows = np.split(np.arange(cfg.n_ants * cfg.n_pols), 4)
    hs = [t(hist[r].copy()) for r in rows]
    accs = [zero_vis_acc(cfg, "cpu", mesh) for _ in range(4)]
    assert accs[0].shape == (N_CHANS // 4,) + acc1.shape[1:]
    assert hs[0].shape == history_shape(cfg, mesh)
    make_step(cfg, w, mesh=mesh)(
        hs, accs, [t(chunk[r]) for r in rows], [t(frac[r]) for r in rows],
        [t(phase[r]) for r in rows], [gains] * 4, [None] * 4, True)
    assert acc1.any()
    assert torch.equal(torch.cat(accs), acc1)
    assert torch.equal(torch.cat(hs), h1)


@pytest.mark.parametrize("time_shards,drops", [(1, (1,)), (2, ()),
                                               (4, (2,))])
def test_sharded_runner_dumps_equal_one_device(time_shards, drops):
    """fx on a 4-shard mesh, pure fx or SP (time 2 x fx 2, time 4 x fx 1),
    with a dropped chunk: dumps and their metadata equal the one-device
    runner's bitwise."""
    cfg = _cfg(run_xengine=True, spectra_per_chunk=32,
               n_spectra_per_acc=64)
    _, src = _stream(cfg, 4, seed=11)
    ref, _, rc = _run(cfg, src, 4, drops=drops, device="cpu")
    got, _, gc = _run(cfg.replace(time_shards=time_shards), src, 4,
                      drops=drops, mesh=_mesh(4, time_shards))
    assert len(ref) == len(got) == 2 and ref[0].vis.any()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.vis, b.vis)
        assert (a.n_spectra, a.first_chunk) == (b.n_spectra, b.first_chunk)
    assert (rc.chunks_dropped, rc.samples_in) == (gc.chunks_dropped,
                                                  gc.samples_in)


def test_sp_spectra_bitwise_over_chunks():
    """SP fengine mode on a 4-way time mesh: every chunk's spectra equal
    the one-device spectra bitwise; the history crosses chunk boundaries
    through the ring, with no cold start after chunk 0."""
    cfg = _cfg(n_ants=2, spectra_per_chunk=32)
    _, src = _stream(cfg, 3, seed=12)
    _, ref, _ = _run(cfg, src, 3, device="cpu")
    _, got, _ = _run(cfg.replace(time_shards=4), src, 3,
                     mesh=_mesh(4, 4))
    assert len(got) == 3
    for a, b in zip(ref, got):
        assert torch.equal(a["spectra"], b["spectra"])


def test_sp_fx_dumps_bitwise_on_a_2x4_mesh():
    cfg = _cfg(run_xengine=True)
    _, src = _stream(cfg, 4, seed=13)
    ref, _, _ = _run(cfg, src, 4, device="cpu")
    got, _, _ = _run(cfg.replace(time_shards=2), src, 4, mesh=_mesh(8, 2))
    assert len(ref) == len(got) == 2
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.vis, b.vis)


@pytest.mark.parametrize("time_shards,ep", [(1, False), (1, True), (2, True)])
def test_sharded_beam_runner_matches_one_device(time_shards, ep):
    """beam mode on a 4-shard mesh (fx 4; or SP time 2 x fx 2, beam
    -parallel): beams, Stokes and incoherent beam against the one-device
    runner.  Float32 sums in another order: beams >= 120 dB apart, the
    incoherent beam (integer sums) bitwise; int8 beams of a second run
    within 1 LSB.  Beam-parallel beams equal the replicated ones."""
    cfg = _cfg(n_beams=4, incoherent_beam=True, beam_stokes=True,
               spectra_per_chunk=16)
    wts = np.random.default_rng(14).normal(
        size=(4, cfg.n_ants, N_CHANS, 2)).astype(np.float32)
    _, src = _stream(cfg, 2, seed=15)
    _, ref, _ = _run(cfg, src, 2, weights=wts, device="cpu")
    mesh = _mesh(4, time_shards)
    cfg_m = cfg.replace(time_shards=time_shards, beam_parallel=ep)
    _, got, _ = _run(cfg_m, src, 2, weights=wts, mesh=mesh)
    _, rep, _ = _run(cfg_m.replace(beam_parallel=False), src, 2,
                     weights=wts, mesh=mesh)
    for a, b, r in zip(ref, got, rep):
        assert b["beams"].shape == a["beams"].shape
        assert snr_db(_c(a["beams"]), _c(b["beams"])) >= 120
        assert snr_db(a["stokes"].numpy(), b["stokes"].numpy()) >= 110
        assert torch.equal(a["incoherent"], b["incoherent"])
        assert torch.equal(b["beams"], r["beams"])
    q = cfg_m.replace(beam_quant_scale=0.02)
    _, ref_q, _ = _run(cfg.replace(beam_quant_scale=0.02), src, 2,
                       weights=wts, device="cpu")
    _, got_q, _ = _run(q, src, 2, weights=wts, mesh=mesh)
    for a, b in zip(ref_q, got_q):
        assert b["beams"].dtype == torch.int8
        d = (a["beams"].to(torch.int16) - b["beams"].to(torch.int16)).abs()
        assert int(d.max()) <= 1


# ---- against the JAX package ----------------------------------------------

def test_sharded_fx_runner_matches_jax_and_golden():
    """The port's fx runner on a 4-way fx mesh against the JAX runner over
    ``build_mesh(4)`` (``impl="jnp"``) on the same stream and delays:
    equal dump metadata, visibilities within VIS_SNR_VS_JAX, both > 50 dB
    against the float64 golden chain."""
    cfg = scaled_for_test(get_config("fx64"), n_chans=32,
                          spectra_per_chunk=8).replace(
        n_ants=16, n_spectra_per_acc=16)
    stream, src = _stream(cfg, 4, seed=16)
    jdm = _dm(cfg, 17, JaxDelayModel)
    gains = np.full(cfg.n_chans, 0.05) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    jd, _ = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                      gains=gains_ri, mesh=jax_build_mesh(n_devices=4),
                      impl="jnp").run(src, 4)
    pd, _ = FXRunner(cfg, w, delay_model=_dm(cfg, 17), gains=gains_ri,
                     mesh=_mesh(4)).run(src, 4)
    spec_g = jax_verify._golden_spectra(cfg, stream, jdm, gains, 4, w)
    assert len(jd) == len(pd) == 2
    for i, (a, b) in enumerate(zip(jd, pd)):
        assert (a.n_spectra, a.first_chunk) == (b.n_spectra, b.first_chunk)
        assert snr_db(_c(a.vis), _c(b.vis)) > VIS_SNR_VS_JAX
        vis_g = golden.xcorr(spec_g[:, :, i * 16:(i + 1) * 16])
        assert snr_db(vis_g, _c(a.vis)) > 50
        assert snr_db(vis_g, _c(b.vis)) > 50


@pytest.mark.parametrize("ep", [False, True])
def test_beam_psum_and_ep_match_jax(ep):
    """The B-engine's sum over a 4-way fx mesh on the same int8 spectra:
    the port's beam kernel's plain version per shard, then ``psum`` or
    (EP) ``psum_scatter``, against JAX's beamformer under ``shard_map``
    with ``lax.psum`` / ``lax.psum_scatter``.  rtol 1e-6, atol 1e-4:
    float32 sums of 8 antennas in other orders (beams about 100 in
    magnitude, float32 steps about 1e-5)."""
    rng = np.random.default_rng(18)
    a, p, b, k, nb = 8, 2, 4, 32, 4
    q = rng.integers(-127, 128, (a, p, b, k, 2)).astype(np.int8)
    wts = rng.normal(size=(nb, a, k, 2)).astype(np.float32)
    jmesh = jax_build_mesh(n_devices=4)

    def jstep(ql, wl):
        coh = jax_ops.beamform(ql, wl)
        coh = (jax.lax.psum_scatter(coh, J_FX, scatter_dimension=0,
                                    tiled=True) if ep
               else jax.lax.psum(coh, J_FX))
        return coh, jax.lax.psum(jax_ops.incoherent_sum(ql), J_FX)

    want, want_inc = jax.jit(shard_map_fn(
        jstep, mesh=jmesh, in_specs=(P(J_FX), P(None, J_FX)),
        out_specs=(P(J_FX) if ep else P(), P()), check_vma=False))(
        jnp.asarray(q), jnp.asarray(wts))
    mesh = _mesh(4)
    parts = [beamform(torch.from_numpy(qs), torch.from_numpy(
        np.ascontiguousarray(ws)), incoherent=True)
        for qs, ws in zip(np.split(q, 4), np.split(wts, 4, axis=1))]
    coh = [c for c, _ in parts]
    coh = (psum_scatter(coh, mesh, FX_AXIS) if ep
           else psum(coh, mesh, FX_AXIS))
    inc = psum([i for _, i in parts], mesh, FX_AXIS)
    got = torch.cat(coh) if ep else coh[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(inc[3].numpy(), np.asarray(want_inc),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("time_shards", [1, 2])
def test_sharded_beam_runner_matches_jax(time_shards):
    """beam64 at full antenna width (64 x 2, 16 beams), 64 channels, with
    Stokes, beam-parallel and the incoherent beam, on a 4-device mesh (fx
    4; SP time 2 x fx 2): the port's mesh runner against the JAX runner
    over ``build_mesh(4, time_shards)`` (``impl="jnp"``) on the same
    stream, delays and weights, 2 chunks.  Float beams, Stokes and the
    incoherent beam within BEAM_SNR_VS_JAX; with ``beam_quant_scale`` set
    (beams near 30 LSB rms), the int8 beams within 1 LSB and the Stokes,
    detected from the float beams before quantisation, as before."""
    cfg = scaled_for_test(get_config("beam64"), n_chans=64,
                          spectra_per_chunk=32).replace(
        beam_stokes=True, beam_parallel=True, time_shards=time_shards)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    rng = np.random.default_rng(22)
    wts = rng.normal(size=(cfg.n_beams, a, k, 2)).astype(np.float32)
    gains = np.stack([np.full(k, BEAM_GAIN, np.float32),
                      np.zeros(k, np.float32)], -1)
    _, src = _stream(cfg, 2, seed=23)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    # the JAX SP step takes coarse delay on the ingest path: max_delay 0
    max_delay = 8 if time_shards == 1 else 0
    d0 = rng.integers(0, max_delay + 1, (a, p)).astype(float)
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))

    def dm(cls):
        d = cls.zeros(a, p, max_delay=max_delay)
        d.d0, d.p1, d.d1 = d0.copy(), p1.copy(), np.full((a, p), 1e-4)
        return d

    def run(c, jax_runner):
        outs = []
        if jax_runner:
            JaxRunner(c, w, delay_model=dm(JaxDelayModel), gains=gains,
                      weights=wts, impl="jnp",
                      mesh=jax_build_mesh(n_devices=4,
                                          time_shards=time_shards)).run(
                src, 2, on_output=lambda i, o: outs.append(
                    {n: np.asarray(v) for n, v in o.items()}))
        else:
            FXRunner(c, w, delay_model=dm(DelayModel), gains=gains,
                     weights=wts, mesh=_mesh(4, time_shards)).run(
                src, 2, on_output=lambda i, o: outs.append(
                    {n: v.numpy() for n, v in o.items()}))
        return outs

    cfg_q = cfg.replace(beam_quant_scale=0.1)
    for c in (cfg, cfg_q):
        want, got = run(c, True), run(c, False)
        assert len(want) == len(got) == 2
        for jo, po in zip(want, got):
            assert set(po) == set(jo) == {"beams", "stokes", "incoherent"}
            for name in po:
                assert po[name].shape == jo[name].shape, name
                assert po[name].dtype == jo[name].dtype, name
            assert snr_db(jo["stokes"], po["stokes"]) >= BEAM_SNR_VS_JAX
            assert snr_db(jo["incoherent"],
                          po["incoherent"]) >= BEAM_SNR_VS_JAX
            if c.beam_quant_scale:
                d = np.abs(jo["beams"].astype(np.int16) - po["beams"])
                assert d.max() <= 1
                assert np.abs(po["beams"]).std() > 10      # not all clipped
            else:
                assert snr_db(_c(jo["beams"]),
                              _c(po["beams"])) >= BEAM_SNR_VS_JAX


def test_one_shot_fx_and_time_sharded_fengine_match_jax():
    """``make_sharded_fx_step`` == ``fx_step_local`` bitwise, both > 50 dB
    against golden with coarse delay; ``make_time_sharded_fengine`` > 100
    dB against golden and JAX's, zero history at the stream head."""
    n_ants, n_pols, nb = 8, 2, 8
    n = (nb + TAPS - 1) * M + 16
    rng = np.random.default_rng(19)
    x = golden.quantize_adc(golden.gaussian_noise((n_ants, n_pols, n), 20.0,
                                                  2))
    cd = rng.integers(0, 16, (n_ants, n_pols))
    fd = rng.uniform(-0.5, 0.5, (n_ants, n_pols, nb)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (n_ants, n_pols, nb)).astype(np.float32)
    g = np.full(N_CHANS, 0.05) * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                          N_CHANS))
    g_ri = np.stack([g.real, g.imag], -1).astype(np.float32)
    w = pfb_window(TAPS, M)
    t = torch.from_numpy
    kw = dict(frac_delay=t(fd), phase=t(ph), gains=t(g_ri),
              coarse_delays=t(cd), max_delay=16)
    local = fx_step_local(t(x), w, TAPS, N_CHANS, **kw)
    sharded = make_sharded_fx_step(_mesh(4), w, TAPS, N_CHANS, n_ants,
                                   max_delay=16)(t(x), t(fd), t(ph),
                                                 t(g_ri), t(cd))
    assert torch.equal(local, sharded)
    vis_g = golden.xcorr(golden.f_engine(x, w, TAPS, N_CHANS,
                                         coarse_delays=cd, max_delay=16,
                                         frac_delay=fd, phase=ph, gains=g))
    assert snr_db(vis_g, _c(sharded.numpy())) > 50
    jvis = jax_sharded_fx(jax_build_mesh(n_devices=4), w, TAPS, N_CHANS,
                          n_ants, impl="jnp", max_delay=16)(
        jnp.asarray(x), jnp.asarray(fd), jnp.asarray(ph), jnp.asarray(g_ri),
        jnp.asarray(cd, jnp.int32))
    assert snr_db(_c(jvis), _c(sharded.numpy())) > VIS_SNR_VS_JAX
    with pytest.raises(ValueError, match="divide"):
        make_sharded_fx_step(_mesh(3), w, TAPS, N_CHANS, n_ants)

    xs = golden.quantize_adc(golden.gaussian_noise((2, 1, 4 * 8 * M), 20.0,
                                                   4))
    fe = make_time_sharded_fengine(_mesh(4, 4), w, TAPS, N_CHANS)(t(xs))
    lead = np.zeros((2, 1, (TAPS - 1) * M))
    ref = golden.channelize(golden.pfb_fir(np.concatenate([lead, xs], -1),
                                           w, TAPS, M), N_CHANS)
    assert fe.shape == ref.shape + (2,)
    assert snr_db(ref, _c(fe.numpy())) > 100
    jfe = jax_sp_fe(jax_build_mesh(n_devices=4, time_shards=4), w, TAPS,
                    N_CHANS, impl="jnp")(jnp.asarray(xs))
    assert snr_db(_c(jfe), _c(fe.numpy())) > 100


@pytest.mark.parametrize("time_shards", [1, 2])
def test_resume_mesh_runner_from_jax_checkpoint(tmp_path, time_shards):
    """A JAX fx run on a 4-device mesh (SP: time 2 x fx 2, its history one
    block per time shard and its accumulator one partial per time shard)
    saves after 3 chunks, in the middle of a 4-chunk dump window; the
    port's runner on a mesh of the same shape loads it and runs 3 more:
    the window's dump matches JAX running all 6."""
    cfg = _cfg(run_xengine=True, spectra_per_chunk=16,
               n_spectra_per_acc=64, time_shards=time_shards)
    _, src = _stream(cfg, 6, seed=20)
    w = pfb_window(TAPS, M)
    jmesh = jax_build_mesh(n_devices=4, time_shards=time_shards)
    jdm = _dm(cfg, 21, JaxDelayModel)
    jdm.max_delay = 0          # SP: coarse delay rides the ingest path
    jdm.d0[:] = 0
    want, _ = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm), mesh=jmesh,
                        impl="jnp").run(src, 6)
    first = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm), mesh=jmesh,
                      impl="jnp")
    first.run(src, 3)
    path = save_state(first, str(tmp_path / "state"))
    resumed = FXRunner(cfg, w, delay_model=DelayModel.zeros(8, 2),
                       mesh=_mesh(4, time_shards))
    load_jax_checkpoint(resumed, path)
    assert resumed.chunk_idx == 3
    got, _ = resumed.run(src, 3)
    assert len(want) == len(got) == 1
    assert (got[0].n_spectra, got[0].first_chunk) == (64, 0)
    assert snr_db(_c(want[0].vis), _c(got[0].vis)) > VIS_SNR_VS_JAX


# ---- verify and validation -------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("fx64", dict(time_shards=1)), ("fx64", dict(time_shards=2)),
    ("beam64", dict(beam_parallel=True))])
def test_verify_on_a_cpu_mesh(name, kw):
    n = 4
    mesh = _mesh(n, kw.get("time_shards", 1))
    snrs, counters = port_verify.verify_config(
        name, mesh=mesh, scale=32, n_chunks=2, **kw)
    assert min(snrs.values()) > port_verify.SNR_BOUND
    assert counters.chunks_in == 2


def test_validation_errors_match_jax():
    """The sharded step refuses what the JAX step refuses, with the same
    message: beam-parallel with beams that do not divide over fx, outside
    beam mode, without a mesh; SP without its time axis, with antennas
    that do not divide over fx, with a chunk too short for the halo."""
    w = pfb_window(TAPS, M)
    beam = _cfg(n_beams=3, beam_parallel=True)
    cases = [
        (beam, 4, 1, "divisible"),
        (beam.replace(n_beams=0), 4, 1, "beam mode"),
        (beam.replace(n_beams=4), None, 1, "requires a mesh"),
        (_cfg(time_shards=2), 4, 1, "SP mode needs a mesh"),
        (_cfg(n_ants=3, n_pols=1, time_shards=2, spectra_per_chunk=32), 8, 2,
         "divide over the fx"),
        (_cfg(time_shards=4, spectra_per_chunk=4), 4, 4, "cannot shard"),
    ]
    for cfg, n, ts, match in cases:
        jmesh = None if n is None else jax_build_mesh(n_devices=n,
                                                      time_shards=ts)
        mesh = None if n is None else _mesh(n, ts)
        with pytest.raises(ValueError, match=match):
            jax_make_step(cfg, w, mesh=jmesh, impl="jnp")
        with pytest.raises(ValueError, match=match):
            make_step(cfg, w, device="cpu" if mesh is None else None,
                      mesh=mesh)
    with pytest.raises(ValueError, match="time_shards"):
        make_step(_cfg(), w, mesh=_mesh(4, 2))
    with pytest.raises(ValueError, match="one of them"):
        FXRunner(_cfg(), w, device="cpu", mesh=_mesh(2))
