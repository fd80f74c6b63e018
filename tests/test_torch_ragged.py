"""The fx path at any spectra count B: the F-engine writes the CMAC operand
at a pitch of B rounded up to 16 (:func:`~dc_sand_tpu_torch.ops.xcorr.
cmac_pitch`), zeros in the pad, and the CMAC's sums over a padded operand
are exact, so the step and the runner at B = 1, 8 and 24 equal the JAX
step and runner bitwise.

Tests marked ``cuda`` hold the kernels to the same contract on the card:
the CMAC at ragged B (the wrapper pads), K1's pitched operand, the runner
and ``run_batched``'s CUDA graph.  The JAX package is imported inside the
tests that need it, so that the card tests run where jax is absent
(``python -m pytest --noconftest tests/test_torch_ragged.py -m cuda``)."""

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch import golden
from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.pipeline import (history_shape, make_step,
                                               zero_vis_acc)
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import (cmac_pitch, cmac_plan_torch,
                                         wire_to_operand,
                                         xcorr_accumulate_a2,
                                         xcorr_accumulate_a2_torch)
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.windows import pfb_window

RAGGED = (1, 8, 24)
MAX_DELAY = 8
# K1 against its plain version: single-LSB boundary flips in at most this
# share of the values (PERF.md section 2)
FLIP_SHARE = 1e-4


def _cfg(b, **kw):
    base = dict(name="ragged", n_ants=4, n_pols=2, n_chans=64, n_taps=16,
                spectra_per_chunk=b, n_spectra_per_acc=2 * b,
                apply_delay=True, apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _k1_inputs(s, b, nch, taps, seed):
    rng = np.random.default_rng(seed)
    m = 2 * nch
    tp = taps_pad_for(taps)
    t = torch.from_numpy
    return dict(
        x=t(golden.gaussian_noise_int8((s, b * m), 20.0, seed)
            .reshape(s, b, m)),
        history=t(golden.gaussian_noise_int8((s, tp * m), 20.0, seed + 1)
                  .reshape(s, tp, m)),
        frac_delay=t(rng.uniform(-0.5, 0.5, (s, b)).astype(np.float32)),
        phase=t(rng.uniform(-np.pi, np.pi, (s, b)).astype(np.float32)),
        gains=t(np.stack([np.full(nch, 0.05), rng.uniform(-0.01, 0.01, nch)],
                         -1).astype(np.float32)),
        window=pfb_window(taps, m))


def _fengine(inp, nch, taps, **kw):
    kw = dict(inp, **kw)
    x, w = kw.pop("x"), kw.pop("window")
    return fengine_fused(x, w, taps, nch, **kw)


# ---- the padded operand on the CPU ----------------------------------------

@pytest.mark.parametrize("b", RAGGED + (16,))
def test_plain_operand_at_a_pitch(b):
    """The plain K1 operand at the CMAC's pitch (and 16 past it): zeros
    past B, and ``[..., :B]`` the unpitched operand bitwise."""
    nch, taps, s = 32, 16, 3
    inp = _k1_inputs(s, b, nch, taps, seed=b)
    flat = _fengine(inp, nch, taps, layout="operand")
    assert flat.shape == (nch, 2, s, b)
    for pitch in (cmac_pitch(b), cmac_pitch(b) + 16):
        got = _fengine(inp, nch, taps, layout="operand", pitch=pitch)
        assert got.shape == (nch, 2, s, pitch) and got.dtype == torch.int8
        assert torch.equal(got[..., :b], flat)
        assert not got[..., b:].any()
        assert torch.equal(wire_to_operand(
            _fengine(inp, nch, taps), pitch), got)


def test_pitch_refused_where_it_means_nothing():
    inp = _k1_inputs(2, 8, 32, 4, seed=3)
    with pytest.raises(ValueError, match="pitch"):
        _fengine(inp, 32, 4, layout="operand", pitch=7)
    with pytest.raises(ValueError, match="pitch"):
        _fengine(inp, 32, 4, layout="wire", pitch=16)
    with pytest.raises(ValueError, match="pitch"):
        wire_to_operand(_fengine(inp, 32, 4), 4)
    assert [cmac_pitch(b) for b in (1, 8, 16, 17, 24, 2040, 2048)] == \
        [16, 16, 16, 32, 32, 2048, 2048]


@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("b", RAGGED + (40,))
def test_padded_operand_accumulates_bitwise(b, keep):
    """Zero spectra add nothing: the plain CMAC, and the kernel's schedule
    (``cmac_plan_torch``), on the zero-padded operand equal the plain CMAC
    on the unpadded one bitwise."""
    gen = torch.Generator().manual_seed(b)
    k, ap = 3, 9
    a2 = torch.randint(-127, 128, (k, 2 * ap, b), generator=gen,
                       dtype=torch.int8)
    padded = torch.zeros((k, 2 * ap, cmac_pitch(b)), dtype=torch.int8)
    padded[..., :b] = a2
    acc = torch.randint(-2**20, 2**20, (k, ap, ap), generator=gen,
                        dtype=torch.int32)
    want = xcorr_accumulate_a2_torch(acc.clone(), a2, keep)
    assert torch.equal(xcorr_accumulate_a2_torch(acc.clone(), padded, keep),
                       want)
    assert torch.equal(cmac_plan_torch(acc.clone(), padded, keep), want)


# ---- the step and the runner against the JAX package ----------------------

def _jax_step_run(cfg, w, chunks, fracs, phases, gains):
    """The JAX fx step (jnp arm) over ``chunks``: its packed accumulator
    after each."""
    import jax.numpy as jnp
    from dc_sand_tpu.models.pipeline import history_len
    from dc_sand_tpu.models.pipeline import make_step as jax_make_step
    from dc_sand_tpu.models.pipeline import zero_vis_acc as jax_zero_acc
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    step = jax_make_step(cfg, w, impl="jnp", donate=False)
    hist = jnp.zeros((a, p, history_len(cfg, 0)), jnp.int8)
    acc, accs = jax_zero_acc(cfg), []
    for i, (x, fd, ph) in enumerate(zip(chunks, fracs, phases)):
        hist, acc, _ = step(hist, acc, jnp.asarray(x),
                            jnp.zeros((a, p), jnp.int32), jnp.asarray(fd),
                            jnp.asarray(ph), jnp.asarray(gains),
                            jnp.zeros((1, a, k, 2), jnp.float32),
                            jnp.asarray(i == 0))
        accs.append(np.asarray(acc))
    return accs


@pytest.mark.parametrize("b", RAGGED)
def test_fx_step_at_ragged_b_matches_jax(b):
    """Three chunks of B spectra through the port's fx step (operand
    padded to :func:`cmac_pitch`) and the JAX step: the packed accumulator
    bitwise after each."""
    cfg = _cfg(b)
    a, p, k, m = cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.fft_size
    rng = np.random.default_rng(100 + b)
    chunks = [rng.integers(-100, 100, (a, p, cfg.chunk_samples),
                           dtype=np.int8) for _ in range(3)]
    fracs = [rng.uniform(-0.5, 0.5, (a, p, b)).astype(np.float32)
             for _ in range(3)]
    phases = [rng.uniform(-3, 3, (a, p, b)).astype(np.float32)
              for _ in range(3)]
    gains = np.stack([np.full(k, 0.05), rng.uniform(-0.01, 0.01, k)],
                     -1).astype(np.float32)
    w = pfb_window(cfg.n_taps, m, cfg.window)
    want = _jax_step_run(cfg, w, chunks, fracs, phases, gains)
    step = make_step(cfg, w, device="cpu")
    hist = torch.zeros(history_shape(cfg), dtype=torch.int8)
    acc = zero_vis_acc(cfg, "cpu")
    t = torch.from_numpy
    for i, (x, fd, ph) in enumerate(zip(chunks, fracs, phases)):
        step(hist, acc, t(x.reshape(a * p, b, m)), t(fd.reshape(a * p, b)),
             t(ph.reshape(a * p, b)), t(gains), None, i == 0)
        np.testing.assert_array_equal(acc.numpy(), want[i])
    assert acc.any()


def _runner_inputs(cfg, n_chunks, seed):
    rng = np.random.default_rng(seed)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    stream = golden.gaussian_noise_int8((a, p, n_chunks * c), 20.0, seed)
    gains = np.stack([np.full(cfg.n_chans, 0.05),
                      rng.uniform(-0.01, 0.01, cfg.n_chans)],
                     -1).astype(np.float32)
    d0 = rng.uniform(0.0, MAX_DELAY / 2, (a, p))
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))

    def dm(cls=DelayModel):
        model = cls.zeros(a, p, max_delay=MAX_DELAY)
        model.d0, model.p1 = d0.copy(), p1.copy()
        return model

    return (lambda i: stream[..., i * c:(i + 1) * c]), gains, dm


@pytest.mark.parametrize("b", RAGGED)
def test_runner_at_ragged_b_matches_jax(b):
    """Four chunks of B spectra, two dumps, coarse and fine delay on: the
    port's runner dumps the JAX runner's visibilities bitwise, with the
    same bookkeeping; ``run_batched`` dumps the same."""
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    cfg = _cfg(b)
    src, gains, dm = _runner_inputs(cfg, 4, seed=200 + b)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    want, _ = JaxRunner(cfg, w, delay_model=dm(JaxDelayModel), gains=gains,
                        impl="jnp").run(src, 4)
    got, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                      device="cpu").run(src, 4)
    batched, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                          device="cpu").run_batched(src, 4)
    assert len(want) == len(got) == len(batched) == 2
    for j, g, bt in zip(want, got, batched):
        assert (g.n_spectra, g.n_spectra_nominal, g.first_chunk) == \
            (j.n_spectra, j.n_spectra_nominal, j.first_chunk)
        np.testing.assert_array_equal(g.vis, j.vis)
        np.testing.assert_array_equal(bt.vis, j.vis)
    assert np.abs(got[-1].vis).max() > 0


@pytest.mark.parametrize("b,time_shards", [(1, 1), (24, 1), (40, 2)])
def test_mesh_runner_at_ragged_b_equals_one_device(b, time_shards):
    """On a CPU mesh (the corner-turn moves rows of ``s_local * Bp``
    bytes; SP mode pads each time shard's B/2 spectra) the dumps equal the
    one-device runner's bitwise."""
    cfg = _cfg(b, time_shards=time_shards, n_taps=4)
    src, gains, dm = _runner_inputs(cfg, 4, seed=300 + b)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    one, _ = FXRunner(cfg.replace(time_shards=1), w, delay_model=dm(),
                      gains=gains, device="cpu").run(src, 4)
    mesh = build_mesh(["cpu"] * 4, time_shards=time_shards)
    got, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                      mesh=mesh).run(src, 4)
    assert len(one) == len(got) == 2
    for a, g in zip(one, got):
        np.testing.assert_array_equal(g.vis, a.vis)


# ---- the kernels on the card ----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel vs plain version)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("b", RAGGED + (40, 2040))
def test_cmac_kernel_at_ragged_b(cuda, b, keep):
    """The CMAC kernel on an unpadded ``(K, 2ap, B)`` operand: one launch,
    bitwise equal to the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b)
    k, ap = 5, 40
    a2 = torch.randint(-127, 128, (k, 2 * ap, b), generator=gen,
                       device=cuda, dtype=torch.int8)
    acc = torch.randint(-2**20, 2**20, (k, ap, ap), generator=gen,
                        device=cuda, dtype=torch.int32)
    launches = xcorr_accumulate_a2.launches
    got = xcorr_accumulate_a2(acc.clone(), a2, keep=keep, impl="cuda")
    assert xcorr_accumulate_a2.launches == launches + 1
    want = xcorr_accumulate_a2(acc.clone(), a2, keep=keep, impl="torch")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 64])
@pytest.mark.parametrize("nch,b", [(32, 8), (512, 24), (1024, 40),
                                   (4096, 24), (4096, 40), (4096, 2040)])
def test_k1_pitched_operand_kernel(cuda, nch, b, extra):
    """K1 in the operand layout at the CMAC's pitch (and 64 spectra past
    it, beyond the grid's last cluster), through both of its store paths
    (per CTA below M = 2048 with the pad memset, cluster-gathered from it
    with the pad stored by the gather): zeros in the pad of an output
    whose memory held other bytes, ``[..., :B]`` the unpitched kernel
    output bitwise and the plain version's within single-LSB flips."""
    taps, s = 16, 4
    inp = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
           for k, v in _k1_inputs(s, b, nch, taps, seed=nch + b).items()}
    pitch = cmac_pitch(b) + extra
    # the allocator hands the output this block again: stale bytes
    junk = torch.full((nch * 2 * s * pitch,), 77, dtype=torch.int8,
                      device=cuda)
    del junk
    got = _fengine(inp, nch, taps, layout="operand", pitch=pitch,
                   impl="cuda")
    flat = _fengine(inp, nch, taps, layout="operand", impl="cuda")
    assert got.shape == (nch, 2, s, pitch)
    assert not got[..., b:].any()
    assert torch.equal(got[..., :b], flat)
    plain = _fengine(inp, nch, taps, layout="operand", pitch=pitch,
                     impl="torch")
    diff = (got.to(torch.int16) - plain.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= FLIP_SHARE * diff.numel() + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 24])
def test_runner_at_ragged_b_on_the_card(cuda, b):
    """The fx runner on the card at B = 8 and 24 (K1 writing the padded
    operand, the CMAC on it): dumps within K1's boundary flips of the
    plain path on the CPU, every kernel launched; ``run_batched``'s CUDA
    graph (the pad's memset captured) dumps ``run()``'s bitwise."""
    cfg = _cfg(b, n_chans=256)
    src, gains, dm = _runner_inputs(cfg, 4, seed=400 + b)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    plain, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                        device="cpu").run(src, 4)
    k1, cmac = fengine_fused.launches, xcorr_accumulate_a2.launches
    got, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                      device=cuda).run(src, 4)
    assert fengine_fused.launches - k1 == 4
    assert xcorr_accumulate_a2.launches - cmac == 4
    batched, _ = FXRunner(cfg, w, delay_model=dm(), gains=gains,
                          device=cuda).run_batched(src, 4)
    for p, g, bt in zip(plain, got, batched):
        np.testing.assert_array_equal(bt.vis, g.vis)
        diff = np.abs(g.vis.astype(np.int64) - p.vis)
        # a flipped sample moves each of its baselines by at most 2*127
        # a spectrum
        assert diff.max() <= 2 * 127 * 2 * cfg.n_spectra_per_acc
        assert (diff != 0).mean() <= 0.01
