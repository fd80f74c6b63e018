"""Corner-turn (C7): antenna-major -> channel-major over the fx axis.

PyTorch counterpart of :func:`dc_sand_tpu.parallel.corner_turn_all_to_all`
on the route of its ``impl="pallas"`` branch: a move of the channel axis to
the front, the peer-copy all-to-all K7b
(:func:`~dc_sand_tpu_torch.parallel.remote_dma.all_to_all`), then the
received blocks put back together.  Channel blocks are contiguous: fx
shard i owns channels ``[i*K/n, (i+1)*K/n)``.
"""

from __future__ import annotations

from dc_sand_tpu_torch.parallel.mesh import FX_AXIS
from dc_sand_tpu_torch.parallel.remote_dma import all_to_all

__all__ = ["corner_turn_all_to_all"]


def corner_turn_all_to_all(qs, mesh) -> list:
    """Re-shard quantised spectra from antennas to channels, per fx group.

    ``qs``: per shard ``(ant_local, pol, b, k_full, 2)`` int8 (its
    antennas, all channels).  Returns per shard the CMAC operand of its
    channel block over all antennas, ``(k_local, 2*ap, b)`` with ``a2[k,
    c*ap + s, b] = q[s, b, k, c]`` (``ap = ant_full*pol``): the JAX
    function's ``(ant_full, pol, b, k_local, 2)`` result in the layout of
    :func:`dc_sand_tpu_torch.ops.xcorr.wire_to_a2`.  Each shard moves its
    spectra to ``(k, 2, s_local, b)`` before K7b, so the reassembly after
    it copies contiguous ``s_local*b``-byte rows instead of transposing at
    2-byte grain as the JAX route's two moveaxes do.
    """
    n = mesh.shape[FX_AXIS]
    a_l, p, b, k, c = qs[0].shape
    if k % n:
        raise ValueError(f"{k} channels do not divide over {n} fx shards")
    k_l, s_l = k // n, a_l * p
    xk = [q.reshape(s_l, b, k, c).permute(2, 3, 0, 1).contiguous()
          for q in qs]                                    # (k, 2, s_l, b)
    out = all_to_all(xk, mesh, FX_AXIS)
    # row-block s of out holds MY channel block from shard s
    return [o.reshape(n, k_l, c, s_l * b).permute(1, 2, 0, 3)
            .reshape(k_l, c * n * s_l, b) for o in out]
