"""The benchmark's frozen counts of each kernel's work agree with the
port's own bench arithmetic (``dc_sand_tpu_torch/bench/harness.py``) at
the cells' shapes (CPU)."""

import pytest

from benchmark import roofline as r
from benchmark import spec
from benchmark.harness import chain_config

h = pytest.importorskip("dc_sand_tpu_torch.bench.harness")


def _cfg(name):
    return chain_config(name, spec.config(name))


def test_peaks_are_the_bench_harness_peaks():
    assert (r.HBM_BYTES_S, r.FP32_FLOPS, r.INT8_OPS, r.BF16_FLOPS,
            r.NVLINK_BYTES_S) == (h.HBM_BYTES_S, h.FP32_FLOPS, h.INT8_OPS,
                                  h.BF16_FLOPS, h.NVLINK_BYTES_S)


@pytest.mark.parametrize("name,cards", [("fx64", 1), ("beam64", 1),
                                        ("fx64", 4)])
def test_k1(name, cards):
    c = _cfg(name)
    s = c.n_ants * c.n_pols // cards
    ops = h.fengine_flops(s * c.spectra_per_chunk, c.fft_size, c.n_taps,
                          True, True)
    assert r.fengine_flops(s * c.spectra_per_chunk, c.fft_size,
                           c.n_taps) == ops
    nbytes = s * ((c.spectra_per_chunk + c.n_taps - 1) * c.fft_size
                  + c.spectra_per_chunk * c.fft_size)
    ms, by = h.bound_ms(nbytes, fp32_ops=ops)
    assert by == "operations"
    assert r.k1_bound_s(s, c.spectra_per_chunk, c.fft_size,
                        c.n_taps) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_cmac():
    c = _cfg("fx64")
    ap, b, k = c.n_ants * c.n_pols, c.spectra_per_chunk, c.n_chans
    # bench/kernels.py bench_xcorr: the operand, the accumulator read and
    # written, 8 int8 operations a complex MAC over the full ap x ap
    ms, _ = h.bound_ms(k * 2 * ap * b + 2 * k * ap * ap * 4,
                       int8_ops=8 * k * ap * ap * b)
    assert r.cmac_bound_s(k, ap, b) * 1e3 == pytest.approx(ms, rel=1e-12)
    assert ms == pytest.approx(0.801, abs=5e-4)


def test_gather():
    c = _cfg("fx64")
    s = c.n_ants * c.n_pols
    n_out = (c.n_taps - 1) * c.fft_size + c.chunk_samples
    # chip_smoke.py phase 35
    ms, _ = h.bound_ms(2 * s * n_out + s * 4)
    assert r.gather_bound_s(s, n_out) * 1e3 == pytest.approx(ms, rel=1e-12)
    assert ms == pytest.approx(1.2915, abs=5e-5)


@pytest.mark.parametrize("out_type,bound_ms", [(1, 0.1127), (4, 0.1728)])
def test_beam(out_type, bound_ms):
    c = _cfg("beam64")
    a, p, b, k, nb = (c.n_ants, c.n_pols, c.spectra_per_chunk, c.n_chans,
                      c.n_beams)
    # chip_smoke.py phase 7, its beams int8 (out_type 1) or float32 (4)
    nbytes = a * p * b * k * 2 + nb * a * k * 2 * 4 \
        + nb * p * b * k * 2 * out_type + p * b * k * 4
    ms, _ = h.bound_ms(nbytes, fp32_ops=4 * p * b * k * a,
                       bf16_ops=8 * nb * p * b * k * a)
    assert r.beam_bound_s(a, p, b, k, nb, 2 * out_type) * 1e3 == \
        pytest.approx(ms, rel=1e-12)
    assert ms == pytest.approx(bound_ms, abs=5e-5)


def test_corner_turn():
    c = _cfg("fx64")
    shard = c.n_chans * 2 * (c.n_ants * c.n_pols // 4) * c.spectra_per_chunk
    # PERF.md: 402.7 MB a card to the other three at NVLink's 450 GB/s
    assert r.corner_turn_bound_s(c.n_chans, c.n_ants * c.n_pols // 4,
                                 c.spectra_per_chunk, 4) == pytest.approx(
        shard * 3 / 4 / h.NVLINK_BYTES_S, rel=1e-12)
    assert shard * 3 / 4 / 1e6 == pytest.approx(402.65, abs=0.01)
