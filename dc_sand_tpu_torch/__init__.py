"""dc_sand_tpu_torch — the F/X correlator chain in PyTorch with CUDA kernels.

A port of :mod:`dc_sand_tpu` (JAX/Pallas) to PyTorch on an NVIDIA Hopper
card.  Module paths mirror the JAX package, so each counterpart sits at
the same relative path (``ops/xcorr.py`` <-> ``ops/xcorr.py``).

This package imports ``torch`` and never ``jax``.  The framework-free
modules of the JAX package are reused by import:
:mod:`dc_sand_tpu.config`, :mod:`dc_sand_tpu.windows` and
:mod:`dc_sand_tpu.golden` (the float64 oracle).

Layout
------
``ops/``      per-stage ops; ``fengine_fused``, ``xcorr`` and ``beamform``
              hold the three hand-written CUDA kernels (``csrc/*.cu``)
              beside their plain PyTorch versions.
``models/``   the F-engine composition, the fx and beam streaming step,
              beam-steering weights.
``runtime/``  delay model, the streaming runner, and loading of the JAX
              package's checkpoints.
``verify``    end-to-end grading against the golden chain.
``_build``    nvcc build of ``csrc/`` at first use, bound with ctypes.

The fx (FX correlator) and beam (beamformer) modes on one device exist
so far.
"""

__version__ = "0.1.0"
