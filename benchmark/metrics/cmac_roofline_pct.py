"""The X-engine's CMAC (ops/xcorr.py, csrc/cmac.cu) on a chunk: its share of
the H100 roofline of its frozen work (benchmark/roofline.py:
cmac_bound_s), at the operand's pitch of 16-spectrum rows."""

from benchmark.roofline import cmac_bound_s


def read(trace):
    c = trace.cfg
    pitch = -(-c.spectra_per_chunk // 16) * 16
    return trace.roofline_pct(("cmac_kernel",), cmac_bound_s(
        c.n_chans // trace.cards, c.n_ants * c.n_pols, pitch))
