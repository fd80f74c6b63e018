"""K1 at M = 65536 (ops/fengine_fused.py, csrc/fengine.cu), on each card's
streams of a chunk: the cluster kernel fengine_wide_kernel and, for the
CMAC's operand layout, its transpose fengine_wide_operand, together against
the H100 roofline of K1's frozen work (benchmark/roofline.py: k1_bound_s),
one bound a launch of the cluster kernel; None where the trace holds none
of its launches."""

from benchmark.roofline import k1_bound_s


def read(trace):
    c = trace.cfg
    n, t = trace.kernel_time(("fengine_wide_kernel",))
    _, t_operand = trace.kernel_time(("fengine_wide_operand",))
    if not n or t + t_operand <= 0:
        return None
    return 100.0 * n * k1_bound_s(
        c.n_ants * c.n_pols // trace.cards, c.spectra_per_chunk, c.fft_size,
        c.n_taps) / (t + t_operand)
