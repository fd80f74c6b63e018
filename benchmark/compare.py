"""The numbers that decide ``correct``: how far what the timed path
produced lies from the reference, each against its limit.

Every number is a relative error, the norm of the difference over the
norm of the reference, taken row by row and the worst row reported: a
row is a baseline's visibilities (all polarisation products, channels
and re/im), a coherent beam's channels at one polarisation and spectrum,
or the incoherent beam's channels at one polarisation and spectrum.  So
a single wrong visibility or beam sample shows in its row, and a
spectrum computed from the wrong history shows in its beam rows.
"""

from __future__ import annotations

import torch


def worst_row(got, ref, row_dims: int) -> float:
    """The largest ``||got - ref|| / ||ref||`` over the rows that the
    first ``row_dims`` axes index (float64)."""
    got = torch.as_tensor(got).to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    rows = ref.shape[:row_dims]
    diff = (got - ref).reshape(*rows, -1).norm(dim=-1)
    norm = ref.reshape(*rows, -1).norm(dim=-1)
    return float((diff / norm.clamp_min(1e-30)).max())


def vis_error(got, ref) -> float:
    """A dump's visibilities ``(n_bl, P, P, K, 2)``: the worst
    baseline."""
    return worst_row(got, ref, 1)


def beam_error(got, ref) -> float:
    """A chunk's beams ``(nb, P, B, K, 2)``: the worst (beam,
    polarisation, spectrum)."""
    return worst_row(got, ref, 3)


def incoherent_error(got, ref) -> float:
    """A chunk's incoherent beam ``(P, B, K)``: the worst (polarisation,
    spectrum)."""
    return worst_row(got, ref, 2)


def judge(readings: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number with its limit, in the order of
    ``limits``; correct when every number is at or below its limit (a
    number not read, a NaN, fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks
