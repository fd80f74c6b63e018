"""Streaming runtime: delay state, the chunked fx runner, checkpoints of
its state, and loading of the JAX package's checkpoints."""

from .delays import DelayModel  # noqa: F401
from .runner import FXRunner, RunnerCounters, Dump  # noqa: F401
from .jax_state import (load_jax_checkpoint,  # noqa: F401
                        window_and_gains_from_numpy)
from .checkpoint import save_state, load_state  # noqa: F401
