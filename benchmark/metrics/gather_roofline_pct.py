"""The coarse gather (ops/coarse.py, csrc/coarse.cu) in the device coarse
mode: its share of the H100 roofline of its frozen work
(benchmark/roofline.py: gather_bound_s), the FIR overlap and the chunk
gathered a stream."""

from benchmark.roofline import gather_bound_s


def read(trace):
    c = trace.cfg
    return trace.roofline_pct(("gather_vec", "gather_byte"), gather_bound_s(
        c.n_ants * c.n_pols // trace.cards,
        (c.n_taps - 1) * c.fft_size + c.chunk_samples))
