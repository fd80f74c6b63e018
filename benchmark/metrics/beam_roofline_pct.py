"""The B-engine's beam kernel (ops/beamform.py, csrc/beamform.cu) on a
chunk, 8-bit or float32 beams as the configuration says: its share of
the H100 roofline of its frozen work
(benchmark/roofline.py: beam_bound_s)."""

from benchmark.roofline import beam_bound_s


def read(trace):
    c = trace.cfg
    return trace.roofline_pct(("beam_kernel",), beam_bound_s(
        c.n_ants // trace.cards, c.n_pols, c.spectra_per_chunk, c.n_chans,
        c.n_beams, 2 if c.beam_quant_scale else 8))
