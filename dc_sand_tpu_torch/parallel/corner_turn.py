"""Corner-turn (C7): antenna-major -> channel-major over the fx axis.

PyTorch counterpart of :func:`dc_sand_tpu.parallel.corner_turn_all_to_all`
on the route of its ``impl="pallas"`` branch, for spectra already in the
operand layout that the fused F-engine writes
(``fengine_fused(..., layout="operand")``, the counterpart of the JAX
fused kernel's native layout).  The all-to-all K7b
(:func:`~dc_sand_tpu_torch.parallel.remote_dma.all_to_all`) runs in its
pitched mode: every sender's channel block lands row by row in the
receiver's CMAC operand, so there is no permute before the copy and no
reassembly after it.  Channel blocks are contiguous: fx shard i owns
channels ``[i*K/n, (i+1)*K/n)``.
"""

from __future__ import annotations

from dc_sand_tpu_torch.parallel.mesh import FX_AXIS
from dc_sand_tpu_torch.parallel.remote_dma import all_to_all

__all__ = ["corner_turn_all_to_all"]


def corner_turn_all_to_all(qs, mesh, out=None) -> list:
    """Re-shard quantised spectra from antennas to channels, per fx group.

    ``qs``: per shard its streams' spectra in the operand layout ``(k_full,
    2, s_local, b)`` int8 (``out[k, c, s, b]`` = wire ``[s, b, k, c]``,
    ``s_local = ant_local*pol``).  Returns per shard the CMAC operand of
    its channel block over all streams, ``(k_local, 2*ap, b)`` with ``a2[k,
    c*ap + s, b] = q[s, b, k, c]`` (``ap = n*s_local``): the JAX
    function's ``(ant_full, pol, b, k_local, 2)`` result in the layout of
    :func:`dc_sand_tpu_torch.ops.xcorr.wire_to_a2`.  K7b moves the ``2 *
    k_local`` rows of ``s_local*b`` bytes of each (sender, receiver) block
    to the receiver's rows at a pitch of ``ap*b`` bytes.  On a
    multi-process mesh on the card the rows land in the receivers'
    persistent operands ``out`` (a
    :class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers` of the
    shards' shape), through the peers' IPC mappings.
    """
    n = mesh.shape[FX_AXIS]
    k, c, s_l, b = qs[0].shape
    if k % n:
        raise ValueError(f"{k} channels do not divide over {n} fx shards")
    k_l = k // n
    got = all_to_all(qs, mesh, FX_AXIS, rows=k_l * c, out=out)
    # got viewed (k_l, c, n, s_l, b): row (k, c) of sender s at [k, c, s]
    return [o.reshape(k_l, c * n * s_l, b) for o in got]
