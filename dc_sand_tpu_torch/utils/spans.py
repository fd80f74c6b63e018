"""Named host spans of the streaming runner, in ``torch.profiler``'s trace.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs and a shared no-op context otherwise, so that a span costs
one check of the profiler's state when nothing is recorded.  The ranges
land in the profiler's own buffer and are written out with the rest of
the profile (``export_chrome_trace`` gives them as ``user_annotation``
events, on the same host clock as the CUDA runtime calls and the device
events they launched); there is no recorder of its own and nothing to
switch on.

The spans of :class:`~dc_sand_tpu_torch.runtime.runner.FXRunner`, by
nesting (a span's parent is the span that encloses it; the exported
events carry no arguments, so the k-th ``runner.chunk`` of a ``run``
call is chunk ``chunk_idx + k`` of the runner as the call began)::

    runner.run            FXRunner.run, the whole call
      runner.chunk        one a chunk: the wait for chunk i - 2's event
                          (cudaEventSynchronize), then the feed through
                          the output handoff
        runner.feed       _feed_chunk: source(i), the chunk's transfer,
                          the delay terms' launch on the device (with the
                          pinned upload of the coefficients when the
                          model changed), the host coarse shift, counters
        runner.upload     _step_args: the chunk and its delay terms cut
                          to the shards; nothing copied on one card, each
                          other card's rows card to card on a mesh
        runner.launch     the step's Python and its kernel launches
        runner.output     gather_outputs and on_output (beam and
                          F-engine modes)
      runner.dump         _dump's whole body: extract, the pinned copy,
                          Dump, on_dump (run_batched's dumps too)
        runner.dump.wait  the host blocked until the dump's copy has
                          landed (a card only)

``run_batched`` records its feeds, uploads (off the graph) and dumps the
same way, under no ``runner.run``.  No span is opened inside a CUDA
graph's capture.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the range ``name`` while a profiler
    runs; the shared no-op context otherwise.  The check reads the flag
    that ``torch.profiler.profile`` sets while it records (cheaper on the
    H100's host than asking the profiler's C++ state)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
