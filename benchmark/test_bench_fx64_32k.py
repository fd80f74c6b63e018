"""The 32k-channel configuration and its cell, ``fx64-32k-stream``: the
file builds the port's configuration, nothing in it is cut, a dump is 51
chunks (0.5 s), the frozen counts of its kernels, its delays' budget, and
the reader of ``k1_roofline_pct.fx64-32k`` (CPU)."""

import pytest

from benchmark import harness, roofline, spec, trace as trace_mod

pytest.importorskip("dc_sand_tpu_torch")

CELL = "fx64-32k-stream"


def _cfg():
    return harness.chain_config("fx64-32k", spec.config("fx64-32k"))


def test_the_configuration_builds_the_ports_chain():
    cs = spec.config("fx64-32k")
    cfg = _cfg()
    assert (cfg.n_ants, cfg.n_pols, cfg.n_chans, cfg.n_taps) == (64, 2,
                                                                 32768, 16)
    assert cfg.fft_size == 65536 and cfg.chunk_samples == 256 * 65536
    assert cfg.run_xengine and cfg.apply_delay and cfg.apply_requant
    assert not cfg.n_beams and cfg.sample_rate_hz == 1712e6
    assert set(cs["check_limits"]) == {"vis_err"} and cs["check_answers"] == 1
    assert cs["reduced"] == [] and cs["assumed"]


def test_nothing_is_cut_and_51_chunks_make_the_dump():
    from dc_sand_tpu_torch.runtime.runner import MAX_SPECTRA_PER_ACC
    bench = spec.load_benchmark()
    entry = [c for c in bench["configs"] if c["name"] == "fx64-32k"][0]
    assert entry["reduced"] == []
    assert entry["file"] == "benchmark/configs/fx64-32k.json"
    cfg = _cfg()
    assert harness.chunks_per_call(cfg, [None] * 4) == 51
    assert cfg.n_spectra_per_acc == 51 * cfg.spectra_per_chunk
    assert cfg.n_spectra_per_acc <= MAX_SPECTRA_PER_ACC
    dump_s = cfg.n_spectra_per_acc * cfg.fft_size / cfg.sample_rate_hz
    assert dump_s == pytest.approx(0.4998, abs=1e-4)
    # the whole chunks nearest 0.5 s
    per_chunk = cfg.chunk_samples / cfg.sample_rate_hz
    assert abs(dump_s - 0.5) <= per_chunk / 2


def test_the_cell_and_its_metrics():
    bench = spec.load_benchmark()
    cell = spec.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "fx64-32k", "stream", 1)
    e2e = {m["name"] for m in spec.metrics_of(bench, CELL, False)}
    assert e2e == {"gsamp_s", "chunk_p95_ms", "setup_s"}
    layer = [m["name"] for m in spec.metrics_of(bench, CELL, True)]
    assert layer == ["k1_roofline_pct.fx64-32k"]


def test_frozen_counts_at_the_cells_shapes():
    """K1's bound at a chunk is 2.724 ms (operations); the CMAC's 1.92 ms,
    bound by its 2.15 GB accumulator's bytes, not its int8 operations."""
    assert roofline.k1_bound_s(128, 256, 65536, 16) * 1e3 == pytest.approx(
        2.724, abs=1e-3)
    cmac = roofline.cmac_bound_s(32768, 128, 256)
    assert cmac * 1e3 == pytest.approx(1.92, abs=5e-3)
    ops = 8 * 32768 * 128 ** 2 * 256 / roofline.INT8_OPS
    assert ops * 1e3 == pytest.approx(0.56, abs=5e-3) and ops < cmac


def test_the_streams_delays_stay_in_budget_for_a_run():
    """A 10 s window at the pace of the cell's frozen bound (the gather,
    K1 and the CMAC of every chunk: a run cannot be faster), after the
    warm-up's two dump windows and with the window's last call run out,
    covers less stream than the traffic's delays stay in budget for."""
    cs = spec.config("fx64-32k")
    cfg = _cfg()
    traffic = spec.traffic("stream")
    chunk_s = (roofline.gather_bound_s(128, 15 * 65536 + cfg.chunk_samples)
               + roofline.k1_bound_s(128, 256, 65536, 16)
               + roofline.cmac_bound_s(32768, 128, 256))
    per_call = harness.chunks_per_call(cfg, [None] * 4)
    chunks = (cs["check_answers"] + 1) * per_call + int(10 / chunk_s) \
        + per_call
    assert harness.within_delay_budget(cfg, traffic, cs["max_delay"],
                                       chunks) < 29.2


def _trace(events, chunks=2):
    rank = trace_mod.Rank((0.0, 1e6), [(n, a, b, 0, None)
                                       for n, a, b in events], [], 0)
    return trace_mod.Trace([rank], _cfg(), 1, chunks, 0)


def test_the_k1_reader_counts_both_kernels_of_a_chunk():
    read = spec.reader("k1_roofline_pct.fx64-32k")
    bound = roofline.k1_bound_s(128, 256, 65536, 16)
    k = "void (anonymous namespace)::fengine_wide_kernel<0>(Params)"
    t = "(anonymous namespace)::fengine_wide_operand(signed char const*)"
    ev = [(k, 0, 15000), (t, 15000, 16500), (k, 20000, 35000),
          (t, 35000, 36500), ("cmac_kernel", 36500, 38500)]
    assert read(_trace(ev)) == pytest.approx(100 * 2 * bound / 0.033)
    assert read(_trace([("cmac_kernel", 0, 10)])) is None
    # fx64's reader does not see the 32k route's kernels, nor this one K1's
    assert spec.reader("k1_roofline_pct.fx64")(_trace(ev)) is None
    fx64 = "void (anonymous namespace)::fengine_kernel<3, 8192>(Params)"
    assert read(_trace([(fx64, 0, 100)])) is None
