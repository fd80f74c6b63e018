"""Per-stage ops.  Four modules hold CUDA kernels beside their plain
versions: :mod:`.fengine_fused` (K1), :mod:`.pfb` (K6), :mod:`.xcorr`
(K2/K3) and :mod:`.beamform` (K4/K4p/K5)."""

from .pfb import pfb_fir  # noqa: F401
from .fft import channelize  # noqa: F401
from .phase import fine_delay_fringe  # noqa: F401
from .quant import requantize, dequantize  # noqa: F401
from .stokes import stokes  # noqa: F401
from .xcorr import (acc_shape, extract_vis, xcorr,  # noqa: F401
                    xcorr_accumulate, xcorr_accumulate_a2, xcorr_full,
                    extract_baselines)
from .beamform import beamform, incoherent_sum  # noqa: F401
