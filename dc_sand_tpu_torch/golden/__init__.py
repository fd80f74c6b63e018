"""NumPy float64 golden models: the accuracy oracle the port is graded
against (>50 dB SNR), a copy of :mod:`dc_sand_tpu.golden`.  No torch
here."""

from .sources import (cw_tone, gaussian_noise, gaussian_noise_int8,  # noqa: F401
                      quantize_adc)
from .chain import (  # noqa: F401
    apply_coarse_delay,
    pfb_fir,
    channelize,
    fine_delay_fringe,
    requantize,
    corner_turn,
    xcorr,
    beamform,
    incoherent_sum,
    f_engine,
    baseline_pairs,
    stokes,
)
