"""Benchmarks of the port on the card: the CUDA-event harness
(``harness``), per-kernel (``kernels``), pipeline (``pipelines``), memory
(``membench``), collective (``collectives``), weak-scaling (``scaling``)
and probe (``probes``, kernels P1 and P2) benchmarks, the regression
check (``regress``), and the entry, ``python -m dc_sand_tpu_torch.bench``."""
