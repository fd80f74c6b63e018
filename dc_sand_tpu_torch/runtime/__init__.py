"""Streaming runtime: delay state, the chunked fx runner, checkpoints of
its state, loading of the JAX package's checkpoints, and the native ingest
that feeds the runner from SPEAD packets."""

from .delays import DelayModel  # noqa: F401
from .runner import FXRunner, RunnerCounters, Dump  # noqa: F401
from .jax_state import (load_jax_checkpoint,  # noqa: F401
                        window_and_gains_from_numpy)
from .checkpoint import save_state, load_state  # noqa: F401
from .ingest import (NativeIngest, SpeadTransmitter,  # noqa: F401
                     spead_packetize, multi_ingest_source)
