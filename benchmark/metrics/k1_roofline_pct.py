"""K1, the fused F-engine (ops/fengine_fused.py, csrc/fengine.cu), on each
card's streams of a chunk: its share of the H100 roofline of its frozen
work (benchmark/roofline.py: k1_bound_s)."""

from benchmark.roofline import k1_bound_s


def read(trace):
    c = trace.cfg
    return trace.roofline_pct(("fengine_kernel",), k1_bound_s(
        c.n_ants * c.n_pols // trace.cards, c.spectra_per_chunk, c.fft_size,
        c.n_taps))
