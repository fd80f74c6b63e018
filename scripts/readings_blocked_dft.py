#!/usr/bin/env python3
"""``benchmark.readings`` with the TF32 control's DFT matrix built in row
blocks, for cells whose M makes the one-shot build too large for the card.

    python3 scripts/readings_blocked_dft.py --workload fx64-32k-stream \\
        --seeds 4000000007 --control-seeds 4000000007

``benchmark/reference.py:_dft`` builds the ``(M, M)`` float32 matrix of
the real FFT's first M/2 bins from float64 angles of the whole matrix at
once: at M = 65536 the matrix is 17 GB and its float64 temporaries some
85 GB, more than an H100 holds.  :func:`dft_blocked` gives the same
values, element for element (each depends only on its row and column),
from 4096 rows of angles at a time; this script puts it in ``_dft``'s
place and runs ``benchmark.readings`` with the arguments given, so the
control's product is the same matrix product on the same operands.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import readings, reference  # noqa: E402


def dft_blocked(m: int, k: int, device, rows: int = 4096) -> torch.Tensor:
    """``reference._dft(m, k, device)``, made ``rows`` rows at a time."""
    out = torch.empty((m, 2 * k), dtype=torch.float32, device=device)
    kk = torch.arange(k, dtype=torch.float64, device=device)
    for lo in range(0, m, rows):
        n = torch.arange(lo, min(lo + rows, m), dtype=torch.float64,
                         device=device)[:, None]
        ang = 2 * math.pi * ((n * kk) % m) / m
        out[lo:lo + rows, :k] = reference.tf32(torch.cos(ang))
        out[lo:lo + rows, k:] = reference.tf32(-torch.sin(ang))
    return out


def main(argv=None) -> int:
    reference._dft = dft_blocked
    return readings.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
