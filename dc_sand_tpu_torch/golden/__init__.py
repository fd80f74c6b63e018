"""NumPy float64 golden models: the accuracy oracle the port is graded
against (>50 dB SNR), a copy of the part of :mod:`dc_sand_tpu.golden` the
port calls.  No torch here."""

from .sources import cw_tone, gaussian_noise_int8, quantize_adc  # noqa: F401
from .chain import (  # noqa: F401
    apply_coarse_delay,
    pfb_fir,
    channelize,
    fine_delay_fringe,
    requantize,
    xcorr,
    beamform,
    incoherent_sum,
    f_engine,
    baseline_pairs,
)
