"""Sharding and collectives (C13-C15) on a device mesh, in one process or
over several ``torch.distributed`` ranks of one node.

The parallelism model is the JAX package's (:mod:`dc_sand_tpu.parallel`):
the ``fx`` axis shards antennas for the F-engine and channels for the
X-engine after the corner-turn; the ``time`` axis shards the sample stream,
with the overlap-save halo sent around a ring.  Shards travel as lists of
per-shard tensors; the corner-turn's all-to-all (K7b) and the halo ring
(K7a) are hand-written peer-copy kernels (``csrc/remote_dma.cu``), the
sums over an axis plain PyTorch.  Across processes (:mod:`.distributed`)
the same kernels write into the peers' buffers through CUDA IPC mappings
(:mod:`.ipc`), and the plain versions go over gloo.
"""

from .mesh import (Mesh, build_mesh, build_global_mesh,  # noqa: F401
                   FX_AXIS, TIME_AXIS)
from .remote_dma import (ring_permute_right, all_to_all,  # noqa: F401
                         ring_permute_right_torch, all_to_all_torch)
from .corner_turn import corner_turn_all_to_all  # noqa: F401
from .halo import halo_exchange_left, ring_tails  # noqa: F401
from .reduce import psum, psum_scatter, all_shards  # noqa: F401
from .distributed import init_distributed, local_antenna_range  # noqa: F401
from .ipc import SharedBuffers  # noqa: F401
