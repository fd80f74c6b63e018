"""The benchmark of ``dc_sand_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell once (``python -m benchmark.run --workload NAME
--seed N --seconds S --trace 0|1``); see ``benchmark/README.md``.  Nothing
here imports ``jax`` or the JAX package ``dc_sand_tpu``.
"""
