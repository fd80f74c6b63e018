"""Stokes parameters from dual-pol beams (B-engine post-processing).

PyTorch counterpart of :func:`dc_sand_tpu.ops.stokes.stokes`, plain
elementwise arithmetic (the JAX package has no Pallas kernel for it).  For
dual-pol beam voltages (x, y):

    I = |x|^2 + |y|^2        Q = |x|^2 - |y|^2
    U = 2 Re(x y*)           V = 2 Im(x y*)
"""

from __future__ import annotations

import torch

__all__ = ["stokes"]


def stokes(beams: torch.Tensor) -> torch.Tensor:
    """``beams: (beam, pol=2, b, k, 2)`` float32 wire format ->
    ``(beam, 4, b, k)`` float32 Stokes (I, Q, U, V)."""
    if beams.shape[1] != 2:
        raise ValueError("Stokes products need dual-pol beams "
                         f"(got {beams.shape[1]} pols)")
    xr, xi = beams[:, 0, ..., 0], beams[:, 0, ..., 1]
    yr, yi = beams[:, 1, ..., 0], beams[:, 1, ..., 1]
    px = xr * xr + xi * xi
    py = yr * yr + yi * yi
    re_xy = xr * yr + xi * yi      # Re(x conj(y))
    im_xy = xi * yr - xr * yi      # Im(x conj(y))
    return torch.stack([px + py, px - py, 2 * re_xy, 2 * im_xy], dim=1)
