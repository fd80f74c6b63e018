"""Sharding and collectives (C13-C15) on a device mesh in one process.

The parallelism model is the JAX package's (:mod:`dc_sand_tpu.parallel`):
the ``fx`` axis shards antennas for the F-engine and channels for the
X-engine after the corner-turn; the ``time`` axis shards the sample stream,
with the overlap-save halo sent around a ring.  Shards travel as lists of
per-shard tensors; the corner-turn's all-to-all (K7b) and the halo ring
(K7a) are hand-written peer-copy kernels (``csrc/remote_dma.cu``), the
sums over an axis plain PyTorch.
"""

from .mesh import Mesh, build_mesh, FX_AXIS, TIME_AXIS  # noqa: F401
from .remote_dma import (ring_permute_right, all_to_all,  # noqa: F401
                         ring_permute_right_torch, all_to_all_torch)
from .corner_turn import corner_turn_all_to_all  # noqa: F401
from .halo import halo_exchange_left, ring_tails  # noqa: F401
from .reduce import psum, psum_scatter  # noqa: F401
