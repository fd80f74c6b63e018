"""dc_sand_tpu_torch — the F/X correlator chain in PyTorch with CUDA kernels.

A port of :mod:`dc_sand_tpu` (JAX/Pallas) to PyTorch on an NVIDIA Hopper
card.  Module paths mirror the JAX package, so each counterpart sits at
the same relative path (``ops/xcorr.py`` <-> ``ops/xcorr.py``).

This package imports ``torch`` and never ``jax``, and nothing of the
JAX package: what it needs of the JAX package's framework-free modules
it keeps as its own copies (``config``, ``windows``, ``golden``, the
float64 oracle), which CPU tests hold equal to the originals.

Layout
------
``ops/``      per-stage ops; ``fengine_fused``, ``pfb``, ``xcorr`` and
              ``beamform`` hold four of the hand-written CUDA kernels
              (``csrc/*.cu``) beside their plain PyTorch versions.
``models/``   the F-engine composition (fused, or unfused through the
              standalone FIR kernel), the fengine, fx and beam streaming
              step on one device or a mesh, the one-shot FX
              compositions, beam-steering weights.
``parallel/`` the device mesh, the peer-copy all-to-all and ring
              kernels (``csrc/remote_dma.cu``) with the corner-turn and
              the halo exchange built on them, sums over a mesh axis.
``runtime/``  delay model, the streaming runner, and loading of the JAX
              package's checkpoints.
``verify``    end-to-end grading against the golden chain.
``_build``    nvcc build of ``csrc/`` at first use, bound with ctypes.

The fengine (configs pfb1k, pfb4k), fx (FX correlator) and beam
(beamformer) modes run on one device or on a device mesh in one
process, with the JAX package's sharded modes (fx, time-sharded SP,
beam-parallel).
"""

__version__ = "0.1.0"
