"""The benchmark's plain reference, written without the port, agrees with
the port's plain versions and golden models at tiny shapes (CPU)."""

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, reference

port = pytest.importorskip("dc_sand_tpu_torch")


def test_window_is_the_ports():
    from dc_sand_tpu_torch.windows import pfb_window
    for kind in ("hann-sinc", "hann", "rect"):
        np.testing.assert_array_equal(inputs.pfb_window(16, 64, kind),
                                      pfb_window(16, 64, kind))


def test_delays_evaluate_as_the_runner_does():
    from dc_sand_tpu_torch.runtime.delays import DelayModel
    d = inputs.make_inputs(5, _traffic(), _cfg(), 32, "cpu").delays
    dm = DelayModel.zeros(4, 2, 32)
    dm.d0, dm.d1, dm.p0, dm.p1 = d.d0, d.d1, d.p0, d.p1
    for t0 in (0, 4096, 3 * 10 ** 10):
        for a, b in zip(d.evaluate(t0, 16, 64),
                        dm.evaluate_chunk(t0, 16, 64)):
            np.testing.assert_array_equal(a, b)


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -12), 3.0])
    np.testing.assert_array_equal(
        reference.tf32(x).numpy(),
        np.array([1 + 2 ** -10, 1.0, 1 + 2 ** -9, -1.0, 3.0], np.float32))


def _cfg():
    from dc_sand_tpu_torch.config import get_config
    return get_config("fx64").replace(n_ants=4, n_chans=32,
                                      spectra_per_chunk=16,
                                      n_spectra_per_acc=32)


def _traffic():
    from benchmark import spec
    return spec.traffic("stream")


def test_delayed_segment_is_the_ports_gather():
    from dc_sand_tpu_torch.ops.coarse import coarse_gather_torch
    cfg = _cfg()
    ins = inputs.make_inputs(7, _traffic(), cfg, 32, "cpu")
    m, s, c = cfg.fft_size, 8, cfg.chunk_samples
    coarse = torch.arange(s) * 4 % 33
    n_h = 15 * m
    for i in (0, 1, 5):
        prev = ins.ring[(i - 1) % 4].reshape(s, c) if i else \
            torch.zeros((s, c), dtype=torch.int8)
        lead = prev[:, c - 32 - n_h:]
        hist = torch.zeros((s, n_h), dtype=torch.int8)
        out = torch.zeros((s, c), dtype=torch.int8)
        coarse_gather_torch(lead, ins.ring[i % 4].reshape(s, c), coarse, 32,
                            hist, out)
        got = reference.delayed_segment(ins.ring, i, coarse, 32, 16, m)
        assert torch.equal(got, torch.cat([hist, out], 1))


def test_fengine_is_the_ports_plain_fengine():
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused_torch
    cfg = _cfg()
    ins = inputs.make_inputs(9, _traffic(), cfg, 32, "cpu")
    m, b, k, s = cfg.fft_size, 16, cfg.n_chans, 8
    seg = reference.delayed_segment(ins.ring, 3, torch.zeros(s), 32, 16, m)
    _, frac, phase = ins.delays.evaluate(3 * cfg.chunk_samples, b, m)
    frac, phase = (torch.from_numpy(x.reshape(s, b)) for x in (frac, phase))
    re, im = reference.fengine(seg, ins.window, 16, m, frac, phase,
                               torch.from_numpy(ins.gains))
    frames = seg.reshape(s, 15 + b, m)
    hist = torch.cat([torch.zeros((s, 1, m), dtype=torch.int8),
                      frames[:, :15]], 1)
    want = fengine_fused_torch(frames[:, 15:].contiguous(), ins.window, 16,
                               k, history=hist, frac_delay=frac, phase=phase,
                               gains=torch.from_numpy(ins.gains))
    got = torch.stack([re, im], -1)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 1e-3
    assert float(got.float().std()) > 5     # requantised well inside 8 bits


def test_visibilities_are_the_golden_xcorr():
    from dc_sand_tpu_torch.golden import chain
    g = torch.Generator().manual_seed(3)
    re, im = (torch.randint(-127, 128, (6, 40, 12), generator=g,
                            dtype=torch.int8) for _ in range(2))
    got = reference.visibilities(re, im, 3, 2, block=5)
    x = (re.numpy().astype(np.float64) + 1j * im.numpy()).reshape(3, 2, 40,
                                                                  12)
    want = chain.xcorr(x)
    np.testing.assert_array_equal(got[..., 0].numpy(), want.real)
    np.testing.assert_array_equal(got[..., 1].numpy(), want.imag)


def test_beams_are_the_golden_beams():
    from dc_sand_tpu_torch.golden import chain
    g = torch.Generator().manual_seed(4)
    re, im = (torch.randint(-127, 128, (8, 5, 6), generator=g,
                            dtype=torch.int8) for _ in range(2))
    w = torch.randn((3, 4, 6, 2), generator=g).numpy()
    b, inc = reference.beams(re, im, w, 4)
    x = (re.numpy().astype(np.float64) + 1j * im.numpy()).reshape(4, 2, 5, 6)
    wc = w[..., 0].astype(np.float64) + 1j * w[..., 1]
    want = chain.beamform(x, wc)
    np.testing.assert_allclose(b[..., 0].numpy(), want.real, rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(b[..., 1].numpy(), want.imag, rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(inc.numpy(), chain.incoherent_sum(x),
                               rtol=1e-12)


def test_quantised_beams_are_the_ports():
    from dc_sand_tpu_torch.ops.beamform import quantize_beams
    g = torch.Generator().manual_seed(6)
    y = torch.randn((4, 2, 3, 50, 2), generator=g, dtype=torch.float64) * 900
    y[0, 0, 0, :4, 0] = torch.tensor([2.5, 3.5, -2.5, 1020.0]) * 8
    got = reference.quantise_beams(y, 0.125)
    want = quantize_beams(y.to(torch.float32), 0.125)
    assert torch.equal(got.to(torch.int8), want)
    assert got[0, 0, 0, :4, 0].tolist() == [2.0, 4.0, -2.0, 127.0]
    assert reference.quantise_beams(y, 0.0) is y


def test_delays_stay_in_the_budget_for_the_margin():
    from benchmark import harness
    t = _traffic()
    cfg = _cfg()
    margin = inputs.delay_margin_s(t, 32, cfg.sample_rate_hz)
    # coarse delays 10-21 of a 0-32 budget: 10 samples at the largest rate
    assert margin == pytest.approx(10 / t["delay_rate"] / 1712e6)
    d = inputs.make_inputs(8, t, cfg, 32, "cpu").delays
    end = int(margin * cfg.sample_rate_hz)
    for t0 in (0, end // 2, end - cfg.chunk_samples):
        coarse, _, _ = d.evaluate(t0, cfg.spectra_per_chunk, cfg.fft_size)
        assert 0 < coarse.min() and coarse.max() < 32
    chunks = end // cfg.chunk_samples
    assert harness.within_delay_budget(cfg, t, 32, chunks) <= margin
    with pytest.raises(RuntimeError):
        harness.within_delay_budget(cfg, t, 32, 2 * chunks)


def test_the_sample_keeps_each_answer_alike():
    from benchmark import harness
    counts = [0] * 10
    for seed in range(400):
        s = harness.Sample(seed, 3)
        for i in range(10):
            s.offer(i, lambda: None)
        kept = [i for i, _ in s.answers()]
        assert len(kept) == 3 and kept == sorted(set(kept))
        for i in kept:
            counts[i] += 1
    assert min(counts) > 80 and max(counts) < 160   # 120 each expected


def test_worst_row_sees_one_wrong_value():
    ref = torch.ones((4, 3, 5), dtype=torch.float64)
    got = ref.clone()
    assert compare.worst_row(got, ref, 2) == 0.0
    got[2, 1, 3] = -1.0
    assert compare.worst_row(got, ref, 2) == pytest.approx(2 / 5 ** 0.5)
    ok, checks = compare.judge({"a": 0.1, "b": float("nan")},
                               {"a": 0.2, "b": 1.0, "c": 1.0})
    assert not ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    assert compare.judge({"a": 0.1}, {"a": 0.2})[0]
