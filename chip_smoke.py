#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's main path on one NVIDIA card.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments, one card).  It imports no jax.  Phases, each of which fails
the run (non-zero exit) when it fails:

1. build the seven CUDA kernel sources from ``dc_sand_tpu_torch/csrc``,
   one nvcc per source, all started together, and beside them the CMAC's
   phases build;
2. F-engine kernel (K1) vs its plain version at the fx64 chunk shape
   (128 streams x 2048 spectra x 8192 samples): every difference a
   single LSB, at most 1e-4 of the values, and each flip of the stream
   with the most lies within 1e-3 of a .5 rounding boundary of the
   float64 golden chain; its operand layout (the CMAC operand, which the
   fx path feeds to the CMAC) bitwise equal to ``wire_to_a2`` of its wire
   layout; both layouts timed beside that corner-turn glue;
3. CMAC kernel (K2/K3) vs its plain version at the fx64 shape
   (K = 4096, ap = 128, B = 2048), keep 1 and 0: bitwise equal; keep 1
   and 0 timed at B = 2048, 1024 (an SP shard's half chunk) and 256 (the
   bench's), each beside its bound; the split of its time between its
   phases, from its build with ``clock64`` counters
   (``dc_sand_tpu_torch/bench/cmac_phases.py``, built in phase 1 beside
   the others), whose results must be bitwise equal too;
4. ``verify fx4`` at its full config through the port's runner: >50 dB
   against the float64 golden chain;
5. ``verify fx64`` at full width (64 ants x 2 pols, 4096 channels) with
   verify's short cadence (16-spectra chunks, 32-spectra dumps, every
   baseline graded): >50 dB;
6. fx64 at production cadence: 4 chunks of 2048 spectra, made on the
   card from a fixed seed, coarse + fractional delay and fringe on, make
   one 8192-spectra dump; the launch counters, zeroed just before, must
   read 4 for K1 and the CMAC and 0 for the others.  The ``run()`` rate
   it prints is with the chunks already on the card (no host-to-device
   copy);
7. beam kernel (K4/K4p/K5, on the tensor cores) vs its plain version at
   the beam64 shape (64 ants x 2 pols, 256 spectra, 4096 channels, 16
   beams): float beams >= 100 dB apart, the incoherent beam bitwise
   equal, and int8 beams at a scale that puts the rms of y*s near 30 LSB
   within 1 LSB with at most 1e-4 of the values flipped; the same three
   checks at a mesh shard's 16 antennas and at 64 beams (64 spectra);
8. ``verify beam64`` at full width with verify's short cadence (16-spectra
   chunks, 4 chunks): beams and incoherent beam each >50 dB against the
   float64 golden chain;
9. beam64 at its own cadence: 8 chunks of 256 spectra made on the card
   from a seed, coarse + fractional delay and fringe on, 16 beams
   steered with the port's ``steering_weights``, outputs kept on the
   card; the launch counters, zeroed just before, must read 8 for K1 and
   the beam kernel and 0 for the others.  It prints the device step,
   ``run()`` per chunk with device-resident chunks, and the
   device-to-host copy of one chunk's outputs;
10. PFB-FIR kernel (K6) vs its plain version at the fx64 chunk shape
    (128 streams, 16 + 2048 frames split I/O, M = 8192): bitwise equal;
11. K1's float-output variant vs its plain version at the JAX package's
    F-engine bench shape (16 streams x 512 spectra, 1024 channels), with
    and without the phasor: >= 100 dB apart (both float32, their FFTs
    summed in other orders);
12. ``verify pfb1k`` and ``verify pfb4k`` at full width, each through the
    fused and the unfused F-engine: >50 dB against the float64 golden
    chain, and the launch counters show K1-float (pfb1k fused), K1-int8
    (pfb4k fused) or K6 (unfused) and no other kernel;
13. fx64 at production cadence through the unfused F-engine (K6, then
    ``torch.fft.rfft``, the phasor and the requant as PyTorch ops): the
    chunks of phase 6 again, one 8192-spectra dump; launch counters K6 4,
    CMAC 4, all others 0; the dump >= 60 dB from phase 6's (two FFTs,
    1-LSB boundary flips).  It prints the device step, ``run()`` per chunk
    and the peak device memory.

Phases 14-18 run on a device mesh, shard i on ``cuda:(i mod the card
count)``: every shard on the one card, or spread over several cards, with
the same checks:

14. peer-copy all-to-all (K7b) vs its plain version at the fx64
    corner-turn shape, 4 shards of 537 MB, one launch: in block mode
    (int8 (4096, 16, 2, 2048, 2)) and in the corner-turn mode the fx
    mesh runs (operand-layout int8 (4096, 2, 32, 2048), each block's 2048
    rows of 64 KB landing at a pitch of 256 KB in the receiver's CMAC
    operand): bitwise equal; ``library_ms`` is ``Tensor.copy_`` of the
    same 16 blocks, in corner-turn mode into the same 16 strided
    destination views, each timed in turns with the kernel (the median of
    five rounds);
15. peer-copy ring step (K7a) vs its plain version on a 4-shard ring of
    int8 (64, 16, 8192), the SP halo at fx64, and on a 2-shard ring:
    bitwise equal; ``library_ms`` is ``Tensor.copy_`` of the same blocks;
    one call launches once per card that holds a sender (on one card the
    whole ring is one launch), and so do the two rings of two of a
    (time 2, fx 2) mesh, checked bitwise over both axes; it also prints
    the wrapper's host time per call;
16. fx64 on a 4-way fx mesh at production cadence, phase 6's chunks and
    delay model (K1 in the operand layout, K7b in corner-turn mode, the
    CMAC, no copy between them): the dump bitwise equal to phase 6's;
    launch counters K1 16, CMAC 16, all-to-all 4 x the number of cards
    (one launch a chunk and card), all others 0; it prints the device
    step, ``run()`` per chunk and the peak device memory;
17. fx64 in SP mode on a (time 2, fx 2) mesh, the same chunks: the dump
    bitwise equal to phase 6's; K1 16, CMAC 16, all-to-all and ring each
    4 x the number of cards;
18. beam64 on a 4-way fx mesh, replicated and beam-parallel, phase 9's
    chunks and weights: beams and incoherent beam >= 100 dB from phase
    9's (float sums in another order), the beam-parallel beams equal to
    the replicated ones; K1 32 and the beam kernel 32 in each run.

Phases 19-20 drive the bench path:

19. the read and write probes (P1, P2) vs their plain versions at the
    shapes of ``scripts/sweep_s10_micro.py`` (int8 (16, 527, 8192) read
    in 64-row blocks; int8 (16, 128, 512, 64) written): tile, block sums
    and written tensor bitwise equal; kernel times with the L2 flushed
    before each launch and back to back; ``library_ms`` is
    ``x[:, :512].sum(dtype=torch.int64)`` (P1) and ``Tensor.fill_`` of the
    same 67.1 MB (P2);
20. the bench entry (``python -m dc_sand_tpu_torch.bench``) in process:
    the headline, whose JSON line it prints, with the launch counters
    zeroed before and showing K1 and the CMAC and no other kernel after;
    then its ``probes`` target, showing P1 and P2 and no other kernel.

Phases 21-23 drive the checkpoint, the offline replay and the CLI:

21. phase 6's runner and chunks run 2 chunks and ``save_state``; a new
    runner built with a zero delay model ``load_state``s the file and
    runs chunks 3-4: the dump's sha256 must be phase 6's; the same on
    the 4-way fx mesh of phase 16; it prints the file's size and the
    save and load times;
22. ``run_batched`` of phase 6's window: one replay of one CUDA graph
    (``graph_launches`` K1 4 and CMAC 4, ``graph_replays`` 1; the
    counters read 5 and 5 with the uncaptured warm-up step, the others
    0), the dump bitwise phase 6's; ms a chunk of ``run_batched`` and
    ``run()`` on the same device-resident chunks, in turns, six each;
    then the bench entry's ``runner`` target (streaming ``run`` against
    ``run_batched`` at the JAX bench's shape);
23. the CLI in process: ``info``; ``run fx4 --chunks 8 --batched
    --checkpoint``, whose file a new runner loads and runs for two more
    windows, equal to an uninterrupted run's dumps; ``verify fx4`` above
    50 dB.

Phases 24-25 drive the ingest, the port's front end:

24. fx64 at full width through the ingest, the main path of that slice:
    one chunk of seeded int8 noise made on the card and copied to the host
    once, packetized once into SPEAD-64-48 datagrams (8192-byte payloads)
    and replayed for two dump windows (8 chunks) with advancing
    timestamps into 4 ``NativeIngest`` assemblers of 16 antennas with
    pinned slots, each fed by its own thread with ``submit_spead_burst``,
    every stream's seeded integer coarse delay in [0, 32] set at packet
    placement; ``multi_ingest_source`` copies each chunk on a copy stream
    into the runner's buffer while the previous chunk steps (``Feeder``),
    and the runner (d0 = d1 = 0, ``max_delay`` 0, phase 6's fringe) passes
    the chunk through with no copy; both dumps must be bitwise those of
    the same runner fed the same samples from the card with the delays as
    its d0 and ``max_delay`` 32; launch counters K1 8, CMAC 8, all others
    0; every assembler's late, bad and clipped counters 0.  It prints the
    submit ms, the copy stream's ms a chunk (events) and GB/s, the device
    step, the dump's pinned and pageable device-to-host copy, window 2's
    wall ms a chunk and its share of the array in real time, and
    ``bench_h2d`` pinned and pageable;
25. the wire leg at fx4, 128 channels, 8-spectra chunks
    (``dc_sand_tpu_torch/examples/udp_observation.py``, in process): UDP
    sink -> localhost socket -> ``UdpSpeadReceiver`` -> ``NativeIngest``
    -> ``multi_ingest_source`` -> the runner on the card; the dump bitwise
    the device-fed run's, and its onward SPEAD copy over a second socket
    bitwise; it prints the receiver's counters.

Phases 26-31 drive the fx path at any spectra count B and the rest of the
single-process surface:

26. the CMAC at fx64's K = 4096 and ap = 128 on unpadded operands of B =
    1, 8, 24 and 2040 spectra (the wrapper pads them with zero spectra to
    a multiple of 16), keep 0 and 1: bitwise equal to the plain version on
    the unpadded operand, one launch a call; B = 2040 also at pitch 2048,
    as K1 writes it; times beside phase 3's B = 2048;
27. K1 in the operand layout at fx64 width (128 streams, M = 8192) at B =
    24 and 2040, rows at a pitch of B rounded up to 16: the pad exactly
    zero, ``[..., :B]`` bitwise the unpitched kernel output and within
    phase 2's 1-LSB flip bound of the plain version; kernel times at B =
    24, 2040 and 2048 (no pad, no memset);
28. ``verify fx64`` at full width on 24-spectra chunks and 48-spectra
    dumps: >50 dB against the float64 golden chain; K1 and the CMAC
    launched, no other kernel;
29. the four examples without ingest in process (fx_observation,
    observe at 8-spectra chunks, beams, beam_pointing): each prints PASS;
    observe's K1 and CMAC launches;
30. ``dryrun_multichip(4, devices=["cuda:0"] * 4)``: every sharded mode
    runs; the fx dumps and incoherent beams bitwise equal to the same
    steps on one card, beams and time-sharded spectra >= 100 dB from
    them; K1, the CMAC, the beam kernel, K6, K7a and K7b launched; each
    mode's ms;
31. the bench entry's ``fengine`` target with ``--profile DIR``: the
    Chrome trace exists and names K1's launches;
35. the coarse gather (``csrc/coarse.cu``, one launch for all the
    streams) vs its plain version, bitwise, at fx64's chunk (128 streams
    x 2048 x 8192), beam64's (256 spectra) and B = 24, delays 0-32 over
    the streams, with the device mode's lead-in (32 + 15 frames) and the
    host mode's tail (32): timed beside its byte bound, the plain
    version (the 128 slice copies the host shift ran before) and, at
    fx64, one ``torch.gather`` with an int64 index as large as the
    output;
36. fx64 at production cadence in the device coarse mode
    (``coarse_on_host=False``), phase 6's chunks and delay model, whose
    coarse delay steps on a few streams: the dump bitwise the same run
    through the plain gather; gather 4, K1 4, CMAC 4; under a constant
    coarse delay the two modes' dumps bitwise equal; ``run_batched``
    (the gather captured in the graph) bitwise ``run()``; beam64 at its
    cadence in the device mode (gather 8, K1 8, beam kernel 8), outputs
    bitwise the plain-gather run's, ``run()`` ms a chunk and the idle
    share of a traced window beside the host shift's; ``verify fx64`` in
    the device mode > 50 dB.  Phases 35 and 36 run before 32-34, whose
    ranks read phase 36's sha256;
41. K1 at M = 65536, the 32k mode (``fengine_wide_kernel``, a spectrum
    across a cluster of 8 CTAs, and for the operand layout its transpose
    ``fengine_wide_operand``), vs its plain version at the 32k chunk
    (128 streams x 256 spectra x 32768 channels), the plain version in
    16-stream blocks: every difference a single LSB, at most 1e-3 of the
    values, each flip of the stream with the most within 1e-3 of a .5
    boundary of the float64 golden chain; the operand layout at a pitch
    past B bitwise ``wire_to_operand`` of the wire layout, pad zeros
    included; both layouts timed in turns beside their bound; then fx at
    32768 channels through ``FXRunner`` (full width, device coarse mode,
    2 chunks of 256 spectra, one dump): launch counters, zeroed just
    before, the cluster kernel 2, its transpose 2, CMAC 2, gather 2, and 0
    for the others (the one-CTA K1 and K6 among them); autocorrelations
    real and >= 0.  ``python3 chip_smoke.py --phase 41`` runs it alone
    after the build.  Phase 41 runs before 32-34;
42. the delay-terms kernel (``csrc/delays.cu``) at the runner's 128
    rows of fx64's chunk (2048 spectra) and beam64's (256), at t0 near
    5e10 (the traffic's 29 s of stream), six delay models (a drift,
    quadratic terms, coarse delays clipped at 0 and at the budget of 32,
    exact halves, an ``update()``): bitwise ``DelayModel.evaluate_chunk``
    and its plain version on the card, one launch a call; timed at
    fx64's beside both.

Every phase whose runner has a coarse delay on the host path counts one
gather launch a chunk (the feed's shift), and every runner phase one
delay-terms launch a chunk (the feed's, on the runner's card).

Phases 32-34 drive the multi-process mode: the script runs itself again
(``--rank``) as two ``torch.distributed`` ranks on the card
(``dc_sand_tpu_torch/parallel/launch.py``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``), two fx shards a
rank, each rank feeding its own antennas (``local_antenna_range``); the
corner-turn (K7b), the halo (K7a) and the beam sums reach the other
rank's buffers through CUDA IPC mappings.  A rank checks its part and
prints ``RESULT`` lines; a rank's failure fails the run:

32. fx64 at full width across the ranks, phase 6's chunks: each rank's
    dump sha256 phase 6's; per rank K1 8, CMAC 8, all-to-all 4 (one a
    chunk), ring 0; ``run()`` ms a chunk beside phase 16's, the gloo
    barriers' host ms a chunk, and a traced run's device busy time, whose
    sum over the ranks gives the idle share; then K7b across the ranks at
    phase 14's corner-turn shape bitwise its plain version over gloo, one
    launch a call a rank, timed beside it and ``copy_`` into the peers'
    mappings; then the same fx64 run in the device coarse mode, each rank
    gathering its shards' antennas (gather 8 a rank): sha256 phase 36's;
33. beam64 across the ranks, replicated and beam-parallel, phase 9's
    chunks: >= 100 dB from one card's beams (each rank runs that
    reference), the beam-parallel share equal to the replicated beams';
    K7a across the ranks on a (time 2, fx 2) mesh (the time ring crosses
    them) at phase 15's halo shape, bitwise its plain version, timed;
    fx64 in SP mode with the time axis within each rank: dump sha256
    phase 6's, ring 4 and all-to-all 4 a rank;
34. the per-rank checkpoint at fx64, in both coarse modes: 2 chunks,
    each rank saves its own file (the device mode's holds the lead-in);
    new processes load them and run chunks 3-4 to phase 6's sha256 and
    phase 36's; then ``cli verify fx4 --distributed --mesh 4`` (the
    device coarse mode, > 50 dB on every rank) and ``cli bench
    collectives --distributed`` in those processes.

Phases 37-39 drive the multi-node mode: the same ``--rank`` entry on
ranks that ``run_ranks(..., nodes=2)`` puts on two nodes of this host
(torchrun's ``GROUP_RANK``), so that a pair of ranks on different nodes
takes the staged route (``dc_sand_tpu_torch/parallel/staged.py``: the
sender's block into a pinned slot on a copy stream, gloo point-to-point
sends, the receiver's K7b or K7a placing it from the slot), and a pair on
one node CUDA IPC:

37. fx64 at full width over 2 ranks on 2 nodes (2 fx shards a rank, each
    fed its 32 antennas), phase 6's chunks: each rank's dump sha256 phase
    6's; per rank K1 8, CMAC 8, all-to-all 8 (one a chunk for its node's
    pairs, one on the receiver for the other node's: all-to-all staged
    4); ``run()`` ms a chunk, the staged route's MB and host ms a chunk,
    the barriers and the idle share of a traced run; a per-rank
    checkpoint after 2 chunks resumed in a fresh runner to phase 6's
    sha256;
38. 4 ranks as 2 nodes x 2, one fx shard a rank, both routes in every
    collective: fx64 dumps sha256 phase 6's (all-to-all 2 a chunk, 1 of
    them staged); beam64 at full width on 2 chunks, replicated and
    beam-parallel: beams >= 100 dB from one card's, beams and incoherent
    beam bitwise the one-process 4-shard mesh's (its sums add the shards
    in the same order);
39. K7b and K7a across the 2 nodes at phase 32's and 33's shapes and
    seeds: bitwise their plain versions over gloo and, by the sha256 of
    each rank's outputs, the IPC route's of phases 32-33; timed beside
    the plain version, the same route placed by ``Tensor.copy_`` and the
    receiver's placement alone from the pinned slots (landed on the card
    then the kernel, as the route does, against the kernel reading the
    slots in place across PCIe and against ``copy_``); then ``cli bench
    collectives --distributed`` across the nodes (its kernels' staged
    launches counted).

Two processes on one card time-slice it: their times are not a scaling
measurement.

Phase 40 runs on a machine of 2 or 4 cards (with one card it prints one
line saying so and goes on; ``python3 chip_smoke.py --phase 40`` runs it
alone after the fx64 runs of phases 6 and 36): it prints ``nvidia-smi
topo -m``, then runs the same ``--rank`` entry as ranks that each take
their cards with ``local_cards()`` (``LOCAL_WORLD_SIZE``): ranks of one
card each and, on 4 cards, 2 ranks of 2 cards each (the JAX package's
shape: a process holds its host's chips), 4 fx shards in all, a rank's
spread over its cards.  Every layout: fx64 in both coarse modes (sha256
phase 6's and 36's; run(), the device step, the barriers, the idle
share over all cards), K7b in corner-turn mode and K7a across the cards
bitwise their plain versions, beside ``copy_`` on the same route, K7b's
block mode and, with one card a rank, NCCL's ``all_to_all_single`` on
the same shards (K7a: NCCL's ring step, ``batch_isend_irecv``); K7a's
flag words a card waits on a call (its rounds are its ring's pairs: none
where the ring stays inside each rank, which is checked) and its
kernel's own ``sent`` signals landed.  2 ranks of 2 cards also: SP fx64
with the time axis inside each rank (its halo card to card, with no
flag round of the halo's, checked), beam64 on 2 chunks replicated
and beam-parallel (>= 100 dB from one card's, bitwise the one-process
mesh's), the cut of a chunk to a rank's cards, and a per-rank
checkpoint resumed in a fresh runner to phase 6's sha256.  Phases 14-18
are the one-process layout on the cards present.

Each kernel's time is a CUDA-event mean over back-to-back launches
(``dc_sand_tpu_torch/bench/harness.py:time_cuda``; in phase 14 the median
of five such means taken in turns with the yardstick); ``bound_ms`` is the
least time the card could take for the same work, the larger of the bytes
it must move (each input read once, each output written once) at the HBM
rate and its operations at the data sheet's peak for their type
(``harness.bound_ms``: 3.35 TB/s, 67 fp32 TFLOP/s without the tensor
cores, 1979 int8 TOP/s, 989 bf16 TFLOP/s for the beam kernel's useful
flops), from the shapes of the timed call;
``library_ms`` is one PyTorch call that computes the same function, where
there is one, timed as a yardstick and never called by the port.

The second-to-last line is ``{"kernels": [...]}``: launches from the
main-path phases (6 for K1 in the operand layout and the CMAC, 9 for K1
in the wire layout and the beam kernel, 12's fused pfb1k for K1-float, 13
for K6, 16 and 17 together for the ring and the all-to-all in
corner-turn mode, 41's 32k runner for ``fengine_wide`` (the cluster
kernel; its time the wire layout's) and ``fengine_wide_operand`` (its
time the operand layout's call, both kernels), 20's probes target for P1 and P2, and for
``all_to_all_ipc`` and ``ring_ipc``, the same kernels across processes,
both ranks' launches in phases 32 and 33, for ``all_to_all_staged`` the
receivers' launches across nodes in phases 37 and 38, for
``ring_staged`` those of phase 39's bench run, 36's device-mode fx64
and beam64 runs for the coarse gather, and 6's and 9's runs for the delay
terms), times from phases 2, 3, 7, 10, 11, 14, 15, 19, 32, 33, 35, 39,
41 and 42 (the probes with the L2 flushed; the
IPC and staged rows rank 0's; the gather's at fx64 with the lead-in);
the last is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when no
CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import hashlib
import io
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

FX64_STREAMS, FX64_SPECTRA, FX64_M, TAPS = 128, 2048, 8192, 16
FX64_SEED = 6              # the chunks of phases 6 and 13
PLAIN_BLOCK_STREAMS = 16   # bounds the plain F-engine's float32 copies
MAX_FLIP_FRACTION = 1e-4   # measured on the H100: about 1e-5
FLIP_BOUNDARY_TOL = 1e-3   # a flip's float64 pre-round value to a .5
WIDE_SPECTRA, WIDE_M = 256, 65536   # phase 41: the 32k cell's chunk
WIDE_SEED = 41
WIDE_MAX_FLIP_FRACTION = 1e-3      # the card test's limit at M = 65536
BEAMS, BEAM_SPECTRA = 16, 256
BEAM_SEED = 9              # the chunks of phases 9 and 18
SHARDS = 4                 # the mesh of phases 14-18
BEAM_SNR_DB = 100.0        # two float32 beamformers, summed in other orders
BEAM_QUANT_RMS = 30.0      # rms of y*s in LSB for the int8 epilogue check
BENCH_STREAMS, BENCH_SPECTRA, BENCH_CHANS = 16, 512, 1024
FLOAT_SNR_DB = 100.0       # two float32 F-engines, FFTs in other orders
UNFUSED_SNR_DB = 60.0      # fused vs unfused fx64 dump: 1-LSB flips
CMAC_SPECTRA = (2048, 1024, 256)   # phase 3's timings: fx64, SP, the bench
INGEST_WORKERS = 4         # phase 24: one assembler a NIC queue, 16 ants each
RANKS = 2                  # phases 32-34: processes on the card, 2 shards each
NODES = 2                  # phases 37-39: 2 ranks on 2 nodes; 38: 4 on 2
PHASE38_BEAM_CHUNKS = 2    # phase 38's beam64 runs (full width, fewer chunks)
RAGGED_SPECTRA = (1, 8, 24, 2040)  # phase 26: B not a multiple of 16
GATHER_MAX_DELAY = 32      # phase 35: the production model's lead-in
DELAY_CASES = ("drift", "quadratic", "clip_low", "clip_high", "half_even",
               "after_update")         # phase 42: the delay models
DELAY_T0 = 49_876_543_210  # near the traffic's 29 s of stream (5e10 samples)


def _events_ms(fn, n):
    """Mean device time in ms of ``fn`` over ``n`` back-to-back calls
    (CUDA events), after one warm-up call."""
    from dc_sand_tpu_torch.bench.harness import time_cuda
    return time_cuda(fn, warmup=1, iters=n) * 1e3


def _turns_ms(fns, n, rounds=5):
    """Device ms of each of ``fns``: ``_events_ms(fn, n)`` in turns, one of
    every fn a round, and the median of the rounds, so that a stall of
    the host in one round does not decide a comparison."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(_events_ms(fn, n))
    return [statistics.median(t) for t in times]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _digest(a) -> str:
    """sha256 of a numpy array's bytes (C order): a dump's identity
    across runs and commits (the chunks are made from a fixed seed)."""
    return hashlib.sha256(a.tobytes()).hexdigest()


def _snr_db(ref, got) -> float:
    """10 log10(sum |ref|^2 / sum |ref - got|^2), in float64 on the card."""
    ref, got = ref.double(), got.double()
    return float(10 * ((ref * ref).sum() / ((ref - got) ** 2).sum()).log10())


def _wrappers() -> dict:
    """Each kernel's wrapper, by the name of its launch counter."""
    from dc_sand_tpu_torch.bench.probes import read_probe, write_probe
    from dc_sand_tpu_torch.ops.beamform import beamform
    from dc_sand_tpu_torch.ops.coarse import coarse_gather
    from dc_sand_tpu_torch.ops.delay_terms import delay_terms
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
    from dc_sand_tpu_torch.ops.pfb import pfb_fir
    from dc_sand_tpu_torch.ops.xcorr import xcorr_accumulate_a2
    from dc_sand_tpu_torch.parallel import all_to_all, ring_permute_right
    return {"fengine": (fengine_fused, "launches"),
            "fengine_float": (fengine_fused, "float_launches"),
            "fengine_wide": (fengine_fused, "wide_launches"),
            "fengine_wide_operand": (fengine_fused, "wide_operand_launches"),
            "pfb": (pfb_fir, "launches"),
            "cmac": (xcorr_accumulate_a2, "launches"),
            "beamform": (beamform, "launches"),
            "all_to_all": (all_to_all, "launches"),
            "ring": (ring_permute_right, "launches"),
            "all_to_all_staged": (all_to_all, "staged_launches"),
            "ring_staged": (ring_permute_right, "staged_launches"),
            "read_probe": (read_probe, "launches"),
            "write_probe": (write_probe, "launches"),
            "coarse": (coarse_gather, "launches"),
            "delay_terms": (delay_terms, "launches")}


def _zero_counts() -> None:
    for fn, attr in _wrappers().values():
        setattr(fn, attr, 0)


def _current_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _wrappers().items()}


def _counts(**want) -> dict:
    """The launch counters, checked against ``want`` (every counter not
    named must read 0)."""
    got = _current_counts()
    if got != {k: want.get(k, 0) for k in got}:
        raise RuntimeError(f"launch counts {got}, want {want} and 0 for the "
                           "others")
    return got


def _rank_result(phase, **values) -> None:
    """One rank's numbers for the parent: a ``RESULT`` JSON line."""
    print("RESULT " + json.dumps({"phase": phase, **values}), flush=True)


def _fx64_mesh_run(dev, mesh, digest, label, trace=None,
                   coarse_on_host=True, a2a=None, staged=0,
                   step=False) -> dict:
    """fx64 at production cadence over a multi-process ``mesh``, this
    rank's antennas of phase 6's chunks, in the coarse mode
    ``coarse_on_host``: the dump's sha256 must be ``digest`` (phase 6's,
    or phase 36's in the device mode); the launch counts (the gather once
    a chunk on the host path, once a shard and chunk in the device mode;
    ``a2a`` all-to-all launches a chunk, by default one a card of the
    rank, ``staged`` of them the receiver's across nodes; the ring one a
    card that holds a sender), ``run()``'s steady ms a chunk, the
    barriers' host ms a chunk and the staged route's MB and host ms a
    chunk; with ``step`` the device step alone (CUDA events on ``dev``,
    the rank's first card, which the step's rounds make wait for its
    other cards and its peers); with ``trace`` (a path) a third run under
    ``torch.profiler`` gives this rank's device intervals by card and
    that run's host window, both in microseconds of the host's clock."""
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.parallel import (SharedBuffers, StagedRoute,
                                            local_antenna_range,
                                            ring_permute_right)
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    n_t = mesh.shape["time"]
    cfg = get_config("fx64").replace(time_shards=n_t)
    a0, a1 = local_antenna_range(cfg.n_ants)
    gen = torch.Generator(device=dev)
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev, mesh=mesh,
                                       coarse_on_host=coarse_on_host,
                                       rows=slice(a0, a1))
    n = len(chunks)

    def source(i):
        return chunks[i % n]

    torch.cuda.synchronize()
    _zero_counts()
    dumps, _ = runner.run(source, n)
    torch.cuda.synchronize()
    local = len(mesh.local_shards)
    a2a = len(mesh.local_cards) if a2a is None else a2a
    launches = _counts(fengine=n * local, cmac=n * local,
                       all_to_all=n * a2a, all_to_all_staged=n * staged,
                       ring=n * len(mesh.ring_sends("time")) if n_t > 1
                       else 0,
                       coarse=n if coarse_on_host else n * local,
                       delay_terms=n)
    if len(dumps) != 1 or _digest(dumps[0].vis) != digest:
        raise RuntimeError(f"{label}: the dump's sha256 is not "
                           + ("phase 6's" if coarse_on_host else "phase 36's"))
    b0, c0 = SharedBuffers.barrier_s, SharedBuffers.barriers
    f0, h0 = SharedBuffers.flag_rounds, ring_permute_right.flag_rounds
    s0 = (StagedRoute.sent_bytes + StagedRoute.received_bytes,
          StagedRoute.seconds)
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(source, n)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n * 1e3
    barrier_ms = (SharedBuffers.barrier_s - b0) / n * 1e3
    barriers = (SharedBuffers.barriers - c0) / n
    flag_rounds = (SharedBuffers.flag_rounds - f0) / n
    halo_rounds = (ring_permute_right.flag_rounds - h0) / n
    staged_mb = (StagedRoute.sent_bytes + StagedRoute.received_bytes
                 - s0[0]) / n / 1e6
    staged_ms = (StagedRoute.seconds - s0[1]) / n * 1e3
    out = {"launches": launches, "step_ms": step_ms,
           "barrier_ms": barrier_ms, "barriers": barriers,
           "flag_rounds": flag_rounds, "halo_flag_rounds": halo_rounds,
           "staged_mb": staged_mb,
           "staged_ms": staged_ms}
    if step:
        frames = chunks[0].reshape(-1, cfg.spectra_per_chunk, cfg.fft_size)
        zeros = torch.zeros(frames.shape[:2], device=dev)
        args = runner._step_args(frames, zeros, zeros)
        out["device_step_ms"] = _events_ms(
            lambda: runner._step(runner.history, runner.vis_acc, *args,
                                 False), 4)
        del frames, zeros, args
    print(f"[{label}] rank {mesh.rank}: {n} chunks of its antennas "
          f"[{a0}, {a1}) -> 1 dump, sha256 phase "
          f"{6 if coarse_on_host else 36}'s; launches {launches}; "
          f"steady run() per chunk {step_ms:.3f} ms, of it {barriers:.1f} "
          f"gloo barriers {barrier_ms:.3f} ms host time, {flag_rounds:.1f} "
          "rounds of device flags"
          + (f" ({halo_rounds:.1f} of them the halo's, K7a)" if n_t > 1
             else "")
          + (f", staged route {staged_mb:.1f} MB sent and received "
             f"{staged_ms:.3f} ms host time" if staged else "")
          + (f"; device step {out['device_step_ms']:.3f} ms" if step
             else ""), flush=True)
    if trace is not None:
        from dc_sand_tpu_torch.bench.fixtures import (DEVICE_CATS,
                                                      card_spans_us,
                                                      chrome_trace)
        with chrome_trace(trace):
            torch.cuda.synchronize()
            t0 = time.time()
            runner.run(source, n)
            torch.cuda.synchronize()
            out["window_us"] = (t0 * 1e6, time.time() * 1e6)
        doc = json.loads(Path(trace).read_text())
        out["spans_us"] = card_spans_us(
            doc["traceEvents"], doc.get("baseTimeNanoseconds", 0) / 1e3)
        per_name = {}
        for e in doc["traceEvents"]:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                per_name[e["name"]] = per_name.get(e["name"], 0) + e["dur"]
        top = sorted(per_name.items(), key=lambda x: -x[1])[:6]
        print(f"[{label}] rank {mesh.rank}: traced run, device ms a chunk "
              "by name: " + "; ".join(f"{v / n / 1e3:.3f} {k[:60]}"
                                      for k, v in top), flush=True)
    return out


def _idle_share(runs) -> tuple:
    """``(idle share, busy ms, wall ms)`` over every card of the ranks'
    traced runs (``bench.fixtures.idle_share``): one minus each card's union
    of every rank's device intervals, summed over the cards, over the
    cards times the span of the ranks' host windows; the share is None
    when the traces' clocks do not line up with the host's."""
    from dc_sand_tpu_torch.bench.fixtures import idle_share
    return idle_share(runs)[:3]


def _rank_kernel_check(mesh, op, xs_of, out_shape, axis, rows, label,
                       launches=None):
    """One K7 kernel across the ranks, on the routes of ``mesh``, against
    its plain version (gloo): bitwise, ``launches`` launches a call a
    rank (default one a card of the rank that holds a sender); its
    CUDA-event ms, the plain version's, the same route with every block
    placed by ``Tensor.copy_`` (``place="copy"``, the library yardstick),
    the bound of the whole call, and the sha256 of this rank's outputs;
    beside the whole call's time the kernel's alone (CUDA events around
    its launches, ``kernel_ms``) and the call on the device (events
    around it on each card's stream, its flag rounds and the waits for
    the peers in them included, ``span_ms``); where blocks cross between
    cards, the most bytes a card sends to the others and their GB/s; for
    K7b, its block mode and, where every rank holds one shard on a card
    of its own, NCCL's ``all_to_all_single`` on the same shards (bitwise
    K7b's block mode; whole calls, and each call on the device with
    events around it, like ``span_ms``); across nodes also the receiver's
    placement alone from one round's pinned slots, the kernel against
    ``copy_``."""
    import torch
    from dc_sand_tpu_torch.bench.collectives import (cross_bytes,
                                                     kernel_alone_ms,
                                                     nccl_all_to_all,
                                                     nccl_ring_step)
    from dc_sand_tpu_torch.bench.harness import NVLINK_BYTES_S, bound_ms
    from dc_sand_tpu_torch.parallel import (SharedBuffers, all_to_all,
                                            all_to_all_torch,
                                            ring_permute_right_torch)
    every = xs_of()
    flat = mesh.flat_devices
    mine = [every[d].to(flat[d]) for d in mesh.local_shards]
    nbytes = sum(_nbytes(x) for x in every)
    del every
    bufs = SharedBuffers(mesh, out_shape, torch.int8)
    kw = {"rows": rows} if op is all_to_all else {}
    sends = (mesh.all_to_all_sends(axis) if op is all_to_all
             else mesh.ring_sends(axis))
    launches = len(sends) if launches is None else launches
    before = op.launches
    got = op(mine, mesh, axis, out=bufs, impl="cuda", **kw)
    if op.launches != before + launches:
        raise RuntimeError(f"{label}: {op.launches - before} launches, want "
                           f"{launches}")
    plain = all_to_all_torch if op is all_to_all else \
        ring_permute_right_torch
    want = plain(mine, mesh, axis, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{label}: the kernel across processes != its "
                           "plain version")
    digest = hashlib.sha256(b"".join(g.cpu().numpy().tobytes()
                                     for g in got)).hexdigest()
    del got
    del want
    ms, lib_ms = _turns_ms((lambda: op(mine, mesh, axis, out=bufs,
                                       impl="cuda", **kw),
                            lambda: op(mine, mesh, axis, out=bufs,
                                       place="copy", **kw)), 3)
    kernel_ms, span_ms = (kernel_alone_ms(
        lambda: op(mine, mesh, axis, out=bufs, impl="cuda", **kw), 5,
        span=span) for span in (False, True))
    plain_ms = _events_ms(lambda: plain(mine, mesh, axis, **kw), 1)
    bound = bound_ms(2 * nbytes)
    how = "/".join(sorted(set(mesh.routes().values())))
    out = {"ms": ms, "kernel_ms": kernel_ms, "span_ms": span_ms,
           "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound[0], "bound_by": bound[1],
           "digest": digest}
    cards = len(set(flat))
    n = len(mesh.groups(axis)[0])
    cross = cross_bytes(mesh, sends, _nbytes(mine[0]) // n
                        if op is all_to_all else _nbytes(mine[0]))
    if cross:
        out.update(cross_mb=cross / 1e6, gb_s_card=cross / ms / 1e6,
                   copy_gb_s_card=cross / lib_ms / 1e6,
                   link_bound_ms=cross / NVLINK_BYTES_S * 1e3)
    if op is all_to_all and cards > 1:
        # block mode, the same bytes, and NCCL's all-to-all beside it
        got = op(mine, mesh, axis, out=bufs, impl="cuda")
        out["block_ms"] = _events_ms(
            lambda: op(mine, mesh, axis, out=bufs, impl="cuda"), 3)
        out["block_kernel_ms"], out["block_span_ms"] = (kernel_alone_ms(
            lambda: op(mine, mesh, axis, out=bufs, impl="cuda"), 5,
            span=span) for span in (False, True))
        got = op(mine, mesh, axis, out=bufs, impl="cuda")
        out["nccl_ms"], out["nccl_note"], out["nccl_kernel_ms"] = \
            nccl_all_to_all(mesh, mine, got, 5)
        del got
    if op is not all_to_all:
        # the flag words a card waits on in one call, the kernel's own
        # signals landed, and NCCL's ring step beside it
        waited, rounds = dict(bufs.waited), bufs.flagged_rounds
        got = op(mine, mesh, axis, out=bufs, impl="cuda")
        bufs.check_signals()
        out["flag_words"] = max((bufs.waited[c] - waited[c]
                                 for c in bufs.waited), default=0)
        out["flag_rounds"] = bufs.flagged_rounds - rounds
        out["nccl_ms"], out["nccl_note"], out["nccl_kernel_ms"] = \
            nccl_ring_step(mesh, axis, mine, got, 5)
        del got
    if bufs.staged is not None:
        (out["place_ms"], out["place_in_place_ms"], out["place_copy_ms"],
         out["place_mb"]) = _staged_placement_ms(mesh, op, mine, bufs, axis,
                                                 rows)
    print(f"[{label}] rank {mesh.rank}: route {how}; bitwise equal to the "
          f"plain version (gloo), {launches} launch(es) a call; kernel "
          f"{ms:.4f} ms a call, {kernel_ms:.4f} ms alone, {span_ms:.4f} "
          "ms on the device with its flag rounds, plain "
          f"{plain_ms:.3f} ms, copy_ on the same route "
          f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) for the "
          f"whole call" + (
              f"; {out['cross_mb']:.1f} MB a card to other cards: kernel "
              f"{out['gb_s_card']:.2f} GB/s a card, copy_ "
              f"{out['copy_gb_s_card']:.2f}, NVLink bound "
              f"{out['link_bound_ms']:.4f} ms" if cross else "") + (
              f"; block mode {out['block_ms']:.4f} ms a call, "
              f"{out['block_kernel_ms']:.4f} ms alone, "
              f"{out['block_span_ms']:.4f} ms on the device, NCCL "
              "all_to_all_single "
              + (f"{out['nccl_ms']:.4f} ms a call, {out['nccl_kernel_ms']:.4f}"
                 " ms on the device (bitwise K7b's block mode)"
                 if out["nccl_ms"] is not None else
                 f"not run: {out['nccl_note']}") if "block_ms" in out
              else "") + (
              f"; {out['flag_words']} flag words a card a call in "
              f"{out['flag_rounds']} flagged rounds, the kernel's signals "
              "landed; NCCL ring step " + (
                  f"{out['nccl_ms']:.4f} ms a call, "
                  f"{out['nccl_kernel_ms']:.4f} ms on the device (bitwise "
                  "K7a)" if out["nccl_ms"] is not None else
                  f"not run: {out['nccl_note']}")
              if "flag_words" in out else "") + (
              f"; the receiver's placement of {out['place_mb']:.1f} MB from "
              f"the pinned slots: landed and placed by the kernel "
              f"{out['place_ms']:.4f} ms, the kernel reading the slots in "
              f"place {out['place_in_place_ms']:.4f} ms, copy_ "
              f"{out['place_copy_ms']:.4f} ms" if "place_ms" in out else "")
          + (f" ({cards} cards)" if cards > 1
             else " (ranks time-slicing one card)"), flush=True)
    return out


def _staged_placement_ms(mesh, op, mine, bufs, axis, rows) -> tuple:
    """The receiver's placement alone on the staged route, from one
    round's blocks left in the pinned slots, CUDA events in turns, one
    rank at a time: the route's (each slot landed on the card by a
    copy-engine transfer, then K7b/K7a from there), the kernel reading
    the slots in place across PCIe (the alternative source), and
    ``Tensor.copy_`` from the slots into the destination; ``(landed ms,
    in place ms, copy_ ms, MB)``."""
    import ctypes
    import torch
    import torch.distributed as dist
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.parallel import all_to_all, remote_dma
    groups = mesh.groups(axis)
    n = len(groups[0])
    loc = {d: k for k, d in enumerate(mesh.local_shards)}
    xs_g = {d: mine[k] for d, k in loc.items()}
    esize = mine[0].element_size()
    if op is all_to_all:
        block = mine[0].numel() // n
        row_bytes = block // rows * esize
        geometry = (rows, row_bytes, n * row_bytes if rows > 1 else row_bytes)
        pos = {i: k for g in groups for k, i in enumerate(g)}
        pairs = [(i, j) for g in groups for i in g for j in g]
        sends = ((bufs.device, tuple((i, j) for i, j in pairs if i in loc)),)

        def offsets(i, j):
            return pos[j] * block * esize, pos[i] * row_bytes
    else:
        nb = mine[0].numel() * esize
        geometry = (1, nb, nb)
        pairs = [(g[k], g[(k + 1) % len(g)]) for g in groups
                 for k in range(len(g))]
        sends = mesh.ring_sends(axis)

        def offsets(i, j):
            return 0, 0
    lib = _build.library()

    def launch(ptrs, stream, staged=False):
        _build.check(lib.dcs_all_to_all(remote_dma._pairs(ptrs), len(ptrs),
                                        *geometry, stream), "placement")

    def in_place(view):
        """The device address of a pinned slot view (read across PCIe)."""
        base, got = view.untyped_storage().data_ptr(), ctypes.c_void_p()
        _build.check(lib.dcs_device_pointer(ctypes.c_void_p(base),
                                            ctypes.byref(got)),
                     "dcs_device_pointer")
        return got.value + view.data_ptr() - base

    def landed():
        views = bufs.staged.land([b for b, _, _ in blocks])
        remote_dma._place(bufs, bufs.device, [(v, j, o) for v, (_, j, o) in
                                              zip(views, blocks)], geometry,
                          launch)

    def uva():
        stream = torch.cuda.current_stream().cuda_stream
        launch([(in_place(b), bufs.views[j].data_ptr() + o)
                for b, j, o in blocks], stream)

    bufs.ready()
    blocks = remote_dma.staged_round(mesh, bufs, xs_g, sends, pairs, offsets,
                                     geometry[0] * geometry[1])
    # one rank at a time, the others waiting at a barrier: the ranks share
    # the card and its PCIe link
    for r in range(mesh.process_count):
        if r == mesh.rank:
            times = _turns_ms((
                landed, uva, lambda: remote_dma._place(
                    bufs, bufs.device, blocks, geometry, None)), 3)
            torch.cuda.synchronize()
        dist.barrier()
    bufs.staged.release()
    bufs.done()
    return (*times, sum(b.numel() for b, _, _ in blocks) / 1e6)


def _k7b_case(dev) -> tuple:
    """``(inputs, shape)`` of K7b across ranks: phase 14's corner-turn
    operands, 4 shards of int8 ``(4096, 2, 32, 2048)`` from seed 32."""
    import torch
    shape = (FX64_M // 2, 2, FX64_STREAMS // SHARDS, FX64_SPECTRA)
    gen = torch.Generator(device=dev)

    def operands():
        gen.manual_seed(32)
        return [torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(SHARDS)]

    return operands, shape


def _k7a_case(dev) -> tuple:
    """``(inputs, shape)`` of K7a across ranks: phase 15's SP halo, 4
    shards of int8 ``(64, 16, 8192)`` from seed 33."""
    import torch
    from dc_sand_tpu_torch.ops.pfb import taps_pad_for
    from dc_sand_tpu_torch.bench.fixtures import noise_int8
    shape = (FX64_STREAMS // 2, taps_pad_for(TAPS), FX64_M)
    gen = torch.Generator(device=dev)

    def halos():
        gen.manual_seed(33)
        return [noise_int8(gen, shape, dev) for _ in range(SHARDS)]

    return halos, shape


def _phases_32_33(dev, digest6, digest36, tmp) -> None:
    """This rank's part of phases 32, 33 and 34's saves."""
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            build_global_mesh,
                                            local_antenna_range,
                                            ring_permute_right)
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    from dc_sand_tpu_torch.runtime import save_state
    mesh = build_global_mesh([dev] * 2)
    rank = mesh.rank
    # ---- 32. fx64 across the ranks, K7b through the peers' mappings -----
    fx = _fx64_mesh_run(dev, mesh, digest6, "32 fx64 2 ranks",
                        trace=os.path.join(tmp, f"fx64_rank{rank}.json"))
    _rank_result(32, run=fx)
    # the device coarse mode: each rank gathers its shards' antennas
    fxd = _fx64_mesh_run(dev, mesh, digest36, "32 fx64 2 ranks device coarse",
                         coarse_on_host=False)
    _rank_result(32, dev_run=fxd)
    gen = torch.Generator(device=dev)
    k7b = _rank_kernel_check(mesh, all_to_all, *_k7b_case(dev), FX_AXIS,
                             2 * FX64_M // 2 // SHARDS,
                             "32 all_to_all across ranks")
    _rank_result(32, k7b=k7b)
    torch.cuda.empty_cache()
    # ---- 33. beam64 across the ranks; K7a across them; SP fx64 ----------
    base = get_config("beam64")
    a0, a1 = local_antenna_range(base.n_ants)
    gen.manual_seed(BEAM_SEED)
    ref_runner, chunks = production_runner(base, gen, dev)
    ref = []
    ref_runner.run(lambda i: chunks[i], len(chunks),
                   on_output=lambda i, o: ref.append(o))
    del ref_runner, chunks
    outs = {}
    nb_l = BEAMS // SHARDS
    _, fs = mesh.local_block()
    share = slice(fs[0] * nb_l, (fs[-1] + 1) * nb_l)
    for ep in (False, True):
        cfg = base.replace(beam_parallel=ep)
        gen.manual_seed(BEAM_SEED)
        runner, chunks = production_runner(cfg, gen, dev, mesh=mesh)
        n = len(chunks)
        got = []
        torch.cuda.synchronize()
        _zero_counts()
        t = time.perf_counter()
        runner.run(lambda i: chunks[i][a0:a1], n,
                   on_output=lambda i, o: got.append(o))
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) / n * 1e3
        launches = _counts(fengine=2 * n, beamform=2 * n, coarse=n,
                           delay_terms=n)
        outs[ep] = got
        snr_b = min(_snr_db(r["beams"][share if ep else slice(None)],
                            o["beams"]) for r, o in zip(ref, got))
        snr_i = min(_snr_db(r["incoherent"], o["incoherent"])
                    for r, o in zip(ref, got))
        label = "33 beam64 2 ranks" + (" beam-parallel" if ep else "")
        print(f"[{label}] rank {rank}: {n} chunks; beams {snr_b:.2f} dB, "
              f"incoherent {snr_i:.2f} dB from one card's; launches "
              f"{launches}; run() per chunk {run_ms:.3f} ms (first run)",
              flush=True)
        if not (snr_b >= BEAM_SNR_DB and snr_i >= BEAM_SNR_DB):
            raise RuntimeError(f"{label}: the beams across ranks disagree "
                               "with one card's")
        _rank_result(33, ep=ep, snr_beams=snr_b, snr_incoherent=snr_i,
                     launches=launches, run_ms=run_ms)
        del runner, chunks
    if not all(torch.equal(r["beams"][share], e["beams"])
               for r, e in zip(outs[False], outs[True])):
        raise RuntimeError("33: the beam-parallel beams != the replicated "
                           "beams' share")
    del outs, ref, got
    torch.cuda.empty_cache()
    sp = build_global_mesh([dev] * 2, time_shards=2)
    k7a = _rank_kernel_check(sp, ring_permute_right, *_k7a_case(dev),
                             TIME_AXIS, 1, "33 ring across ranks")
    _rank_result(33, k7a=k7a)
    sp_local = build_global_mesh([dev] * 2, time_shards=2, time_local=True)
    spx = _fx64_mesh_run(dev, sp_local, digest6, "33 fx64 SP 2 ranks")
    _rank_result(33, sp_run=spx)
    torch.cuda.empty_cache()
    # ---- 34. (first half) 2 chunks, then each rank saves its own file, in
    # both coarse modes (the device mode's file holds the lead-in) --------
    cfg = get_config("fx64")
    for name, on_host in (("fx64", True), ("fx64dev", False)):
        gen.manual_seed(FX64_SEED)
        runner, chunks = production_runner(cfg, gen, dev, mesh=mesh,
                                           coarse_on_host=on_host)
        runner.run(lambda i: chunks[i][a0:a1], 2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = save_state(runner, os.path.join(tmp, name))
        save_s = time.perf_counter() - t
        _rank_result(34, saved=path, save_s=save_s, device_coarse=not on_host,
                     mb=os.path.getsize(path) / 1e6)
        del runner, chunks
        torch.cuda.empty_cache()


def _phase_34(dev, digest6, digest36, tmp) -> None:
    """Phase 34 in new processes: load this rank's files of both coarse
    modes, run chunks 3-4 of each; then ``cli verify fx4 --distributed
    --mesh 4`` (the device coarse mode) and ``cli bench collectives
    --distributed``."""
    import torch
    from dc_sand_tpu_torch.cli import main as cli_main
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.parallel import (build_global_mesh,
                                            local_antenna_range)
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner, load_state
    from dc_sand_tpu_torch.windows import pfb_window
    mesh = build_global_mesh([dev] * 2)
    cfg = get_config("fx64")
    a0, a1 = local_antenna_range(cfg.n_ants)
    gen = torch.Generator(device=dev)
    gen.manual_seed(FX64_SEED)
    _, chunks = production_runner(cfg, gen, dev)
    for name, on_host, digest in (("fx64", True, digest6),
                                  ("fx64dev", False, digest36)):
        resumed = FXRunner(
            cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
            delay_model=DelayModel.zeros(cfg.n_ants, cfg.n_pols, 32),
            mesh=mesh, coarse_on_host=on_host)
        torch.cuda.synchronize()
        t = time.perf_counter()
        load_state(resumed, os.path.join(tmp, name))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        _zero_counts()
        dumps, _ = resumed.run(lambda i: chunks[i][a0:a1], 2)
        torch.cuda.synchronize()
        launches = _counts(fengine=4, cmac=4, all_to_all=2,
                           coarse=2 if on_host else 4, delay_terms=2)
        phase = 6 if on_host else 36
        if len(dumps) != 1 or _digest(dumps[0].vis) != digest:
            raise RuntimeError(f"34 ({name}): the resumed dump is not phase "
                               f"{phase}'s")
        print(f"[34 checkpoint 2 ranks{'' if on_host else ' device coarse'}]"
              f" rank {mesh.rank}: loaded its file in a new process "
              f"({load_s:.3f} s), chunks 3-4 -> dump sha256 phase {phase}'s; "
              f"launches {launches}", flush=True)
        _rank_result(34, load_s=load_s, launches=launches,
                     device_coarse=not on_host)
        del resumed, dumps
        torch.cuda.empty_cache()
    del chunks
    torch.cuda.empty_cache()
    for argv in (["verify", "fx4", "--distributed", "--mesh", "4"],
                 ["bench", "collectives", "--distributed", "--mesh", "4"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        for line in out.getvalue().splitlines():
            print(f"[34 cli {argv[0]}] rank {mesh.rank}: {line}", flush=True)
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(argv)}: exit code {rc}")
        if argv[0] == "verify":
            snr = float(out.getvalue().split("fx4:visibilities: ")[1].split()[0])
            if not snr > 50.0:
                raise RuntimeError(f"cli verify fx4 --distributed: {snr} dB")
            _rank_result(34, verify_db=snr)
        elif mesh.rank == 0:
            records = [json.loads(x) for x in out.getvalue().splitlines()
                       if x.startswith("{")]
            if not any(r["extra"].get("link") == "CUDA IPC"
                       for r in records):
                raise RuntimeError("bench collectives --distributed timed "
                                   "nothing across the ranks")
            _rank_result(34, collectives={
                r["name"]: r["wall_s"] * 1e3 for r in records})


def _phases_37_39(dev, digest6, digest36, tmp) -> None:
    """This rank's part of phases 37 and 39: two ranks on two nodes of the
    card (the staged route between them)."""
    import torch
    from dc_sand_tpu_torch.cli import main as cli_main
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            build_global_mesh,
                                            local_antenna_range,
                                            ring_permute_right)
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.windows import pfb_window
    mesh = build_global_mesh([dev] * 2)
    rank = mesh.rank
    if set(mesh.routes().values()) != {"staged"}:
        raise RuntimeError(f"37: rank {rank}'s routes {mesh.routes()}")
    print(f"[37 routes] rank {rank} on node {mesh.node_of(rank)}: "
          f"{mesh.routes()}", flush=True)
    # ---- 37. fx64 across two nodes: the corner-turn over the staged route
    fx = _fx64_mesh_run(dev, mesh, digest6, "37 fx64 2 nodes",
                        trace=os.path.join(tmp, f"fx64_node{rank}.json"),
                        a2a=2, staged=1)
    _rank_result(37, run=fx, routes=mesh.routes())
    # a per-rank checkpoint across nodes: 2 chunks, save, resume in a
    # fresh runner, chunks 3-4
    cfg = get_config("fx64")
    a0, a1 = local_antenna_range(cfg.n_ants)
    gen = torch.Generator(device=dev)
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev, mesh=mesh,
                                       rows=slice(a0, a1))
    runner.run(lambda i: chunks[i], 2)
    path = save_state(runner, os.path.join(tmp, "fx64_nodes"))
    del runner
    resumed = FXRunner(
        cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
        delay_model=DelayModel.zeros(cfg.n_ants, cfg.n_pols, 32), mesh=mesh)
    load_state(resumed, os.path.join(tmp, "fx64_nodes"))
    dumps, _ = resumed.run(lambda i: chunks[i], 2)
    torch.cuda.synchronize()
    if len(dumps) != 1 or _digest(dumps[0].vis) != digest6:
        raise RuntimeError("37: the checkpoint across nodes did not resume "
                           "to phase 6's sha256")
    print(f"[37 checkpoint 2 nodes] rank {rank}: {os.path.basename(path)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB), resumed in a fresh runner"
          f": chunks 3-4 -> dump sha256 phase 6's", flush=True)
    _rank_result(37, resumed=True)
    del resumed, chunks, dumps
    torch.cuda.empty_cache()
    # ---- 39. K7b and K7a on the staged route, then the collectives bench
    k7b = _rank_kernel_check(mesh, all_to_all, *_k7b_case(dev), FX_AXIS,
                             2 * FX64_M // 2 // SHARDS,
                             "39 all_to_all across nodes", launches=2)
    _rank_result(39, k7b=k7b)
    torch.cuda.empty_cache()
    sp = build_global_mesh([dev] * 2, time_shards=2)
    k7a = _rank_kernel_check(sp, ring_permute_right, *_k7a_case(dev),
                             TIME_AXIS, 1, "39 ring across nodes")
    _rank_result(39, k7a=k7a)
    torch.cuda.empty_cache()
    argv = ["bench", "collectives", "--distributed", "--mesh", "4"]
    out = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    counts = _current_counts()
    for line in out.getvalue().splitlines():
        print(f"[39 cli bench] rank {rank}: {line}", flush=True)
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)}: exit code {rc}")
    if rank == 0:
        records = [json.loads(x) for x in out.getvalue().splitlines()
                   if x.startswith("{")]
        if not any(r["extra"].get("link") == "staged" for r in records):
            raise RuntimeError("bench collectives --distributed timed "
                               "nothing over the staged route")
        _rank_result(39, collectives={r["name"]: r["wall_s"] * 1e3
                                      for r in records},
                     copy_ms={r["name"]: r["extra"]["copy_ms"]
                              for r in records if "copy_ms" in r["extra"]})
    _rank_result(39, bench_launches={
        k: counts[k] for k in ("all_to_all", "all_to_all_staged", "ring",
                               "ring_staged")})


def _phase_38(dev, digest6, digest36, tmp) -> None:
    """This rank's part of phase 38: four ranks as two nodes of two, one
    fx shard a rank, both routes in every collective."""
    import torch
    from dc_sand_tpu_torch.parallel import build_global_mesh
    mesh = build_global_mesh([dev])
    rank = mesh.rank
    routes = mesh.routes()
    if sorted(routes.values()) != ["ipc", "staged", "staged"]:
        raise RuntimeError(f"38: rank {rank}'s routes {routes}")
    fx = _fx64_mesh_run(dev, mesh, digest6, "38 fx64 2 nodes x 2 ranks",
                        a2a=2, staged=1)
    _rank_result(38, run=fx, routes=routes)
    torch.cuda.empty_cache()
    _beam64_ranks(dev, mesh, "38 beam64 2 nodes x 2 ranks", 38)


def _beam64_ranks(dev, mesh, label, phase) -> None:
    """beam64 at full width on PHASE38_BEAM_CHUNKS chunks over the
    multi-process ``mesh``, replicated and beam-parallel: the beams >= 100
    dB from one card's (on ``dev``, the rank's first card) and, with the
    incoherent beam, bitwise the one-process 4-shard mesh's on ``dev``,
    whose sums add the shards in the same order; the beam-parallel beams
    this rank's share of the replicated ones."""
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.parallel import build_mesh, local_antenna_range
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    base = get_config("beam64")
    a0, a1 = local_antenna_range(base.n_ants)
    n = PHASE38_BEAM_CHUNKS
    refs = {}
    for name, ref_mesh in (("card", None), ("mesh", build_mesh([dev] * 4))):
        gen = torch.Generator(device=dev)
        gen.manual_seed(BEAM_SEED)
        runner, chunks = production_runner(base, gen, dev, mesh=ref_mesh,
                                           n_chunks=n)
        refs[name] = []
        runner.run(lambda i: chunks[i], n,
                   on_output=lambda i, o: refs[name].append(o))
        del runner, chunks
    outs = {}
    nb_l = BEAMS // SHARDS
    _, fs = mesh.local_block()
    local = len(mesh.local_shards)
    for ep in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(BEAM_SEED)
        runner, chunks = production_runner(base.replace(beam_parallel=ep),
                                           gen, dev, mesh=mesh,
                                           rows=slice(a0, a1), n_chunks=n)
        got = []
        torch.cuda.synchronize()
        _zero_counts()
        t = time.perf_counter()
        runner.run(lambda i: chunks[i], n,
                   on_output=lambda i, o: got.append(o))
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) / n * 1e3
        launches = _counts(fengine=n * local, beamform=n * local, coarse=n,
                           delay_terms=n)
        outs[ep] = got
        share = (slice(fs[0] * nb_l, (fs[-1] + 1) * nb_l) if ep
                 else slice(None))
        snr = min(_snr_db(r["beams"][share], o["beams"])
                  for r, o in zip(refs["card"], got))
        same = all(torch.equal(r["beams"][share], o["beams"])
                   and torch.equal(r["incoherent"], o["incoherent"])
                   for r, o in zip(refs["mesh"], got))
        name = label + (" beam-parallel" if ep else "")
        print(f"[{name}] rank {mesh.rank}: {n} chunks; beams {snr:.2f} dB "
              f"from one card's; beams and incoherent beam bitwise the "
              f"one-process 4-shard mesh's: {same}; launches {launches}; "
              f"run() per chunk {run_ms:.3f} ms (first run)", flush=True)
        if not (snr >= BEAM_SNR_DB and same):
            raise RuntimeError(f"{name}: the beams across the ranks "
                               "disagree")
        _rank_result(phase, ep=ep, snr_beams=snr, launches=launches,
                     run_ms=run_ms)
        del runner, chunks, got
    if not all(torch.equal(r["beams"][fs[0] * nb_l:(fs[-1] + 1) * nb_l],
                           e["beams"])
               for r, e in zip(outs[False], outs[True])):
        raise RuntimeError(f"{phase}: the beam-parallel beams != the "
                           "replicated beams' share")


def _phase_40(cards, digest6, digest36, tmp) -> None:
    """This rank's part of phase 40 on several cards: ``SHARDS`` fx
    shards over the ranks, each rank's spread over its own cards
    (``local_cards``), shard k of a rank on card k mod their count.  On
    every layout: fx64 in both coarse modes (dump sha256 phase 6's and
    36's; run(), the device step, the barriers and traced runs) and K7b
    and K7a across the cards (K7a on the (time 2, fx 2) ``time_local``
    mesh).  Where a rank holds several cards also SP fx64 with the time
    axis inside each rank, beam64 replicated and beam-parallel, the cut
    of a chunk to the rank's cards, and a per-rank checkpoint resumed in
    a fresh runner to phase 6's sha256."""
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.models.pipeline import shard_inputs
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            build_global_mesh,
                                            local_antenna_range,
                                            ring_permute_right)
    from dc_sand_tpu_torch.parallel.distributed import process_count
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.windows import pfb_window
    dev = cards[0]
    devs = [cards[k % len(cards)] for k in range(SHARDS // process_count())]
    mesh = build_global_mesh(devs)
    sp = build_global_mesh(devs, time_shards=2, time_local=True)
    rank = mesh.rank
    layout = (f"{mesh.process_count} ranks x {len(mesh.local_cards)} "
              f"card{'s' if len(mesh.local_cards) > 1 else ''}")
    print(f"[40 {layout}] rank {rank}: cards {[str(c) for c in cards]}, "
          f"shards {mesh.local_shards} on {[str(d) for d in devs]}; routes "
          f"{mesh.routes()}", flush=True)
    from dc_sand_tpu_torch.parallel.ipc import stream_memops
    print(f"[40 {layout}] rank {rank}: the driver's stream memory "
          "operations (CAN_USE_STREAM_MEM_OPS_V1, CAN_FLUSH_REMOTE_WRITES) "
          + ", ".join(f"{c} {stream_memops(c)}" for c in mesh.local_cards),
          flush=True)
    _rank_result(40, layout=layout, cards=len(mesh.local_cards))
    fx = _fx64_mesh_run(dev, mesh, digest6, f"40 fx64 {layout}", step=True,
                        trace=os.path.join(tmp, f"fx64_40_{rank}.json"))
    # the device coarse mode, the JAX multi-process runner's only mode
    fxd = _fx64_mesh_run(dev, mesh, digest36,
                         f"40 fx64 {layout} device coarse",
                         coarse_on_host=False,
                         trace=os.path.join(tmp, f"fx64d_40_{rank}.json"))
    _rank_result(40, run=fx, dev_run=fxd)
    torch.cuda.empty_cache()
    k7b = _rank_kernel_check(mesh, all_to_all, *_k7b_case(dev), FX_AXIS,
                             2 * FX64_M // 2 // SHARDS,
                             f"40 all_to_all {layout}")
    _rank_result(40, k7b=k7b)
    torch.cuda.empty_cache()
    k7a = _rank_kernel_check(sp, ring_permute_right, *_k7a_case(dev),
                             TIME_AXIS, 1, f"40 ring {layout}")
    # K7a's rounds are its ring's pairs: a time ring inside each rank takes
    # no flag, one across ranks a word of each neighbour's a round
    inside = all(sp.process_of(i) == sp.process_of(j)
                 for _, ps in sp.ring_sends(TIME_AXIS) for i, j in ps)
    if (k7a["flag_rounds"] == 0) != inside or k7a["flag_words"] > 2:
        raise RuntimeError(f"40 {layout}: K7a took {k7a['flag_rounds']} "
                           f"flagged rounds and {k7a['flag_words']} words a "
                           "card in one call")
    _rank_result(40, k7a=k7a)
    torch.cuda.empty_cache()
    if len(mesh.local_cards) == 1:
        return
    spx = _fx64_mesh_run(dev, sp, digest6, f"40 fx64 SP {layout}")
    if spx["halo_flag_rounds"] != 0:
        raise RuntimeError(f"40 {layout}: the SP halo took "
                           f"{spx['halo_flag_rounds']} flag rounds a chunk")
    _rank_result(40, sp_run=spx)
    torch.cuda.empty_cache()
    _beam64_ranks(dev, mesh, f"40 beam64 {layout}", 40)
    torch.cuda.empty_cache()
    # the cut of a chunk to the rank's cards (its first card's rows stay,
    # the others' cross card to card), then the per-rank checkpoint
    cfg = get_config("fx64")
    a0, a1 = local_antenna_range(cfg.n_ants)
    gen = torch.Generator(device=dev)
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev, mesh=mesh,
                                       rows=slice(a0, a1))
    frames = chunks[0].reshape(-1, cfg.spectra_per_chunk, cfg.fft_size)
    zeros = torch.zeros(frames.shape[:2], device=dev)
    cut_ms = _events_ms(lambda: shard_inputs(mesh, frames, zeros, zeros), 4)
    runner.run(lambda i: chunks[i], 2)
    path = save_state(runner, os.path.join(tmp, "fx64_40"))
    del runner, frames, zeros
    resumed = FXRunner(
        cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
        delay_model=DelayModel.zeros(cfg.n_ants, cfg.n_pols, 32), mesh=mesh)
    load_state(resumed, os.path.join(tmp, "fx64_40"))
    if [h.device for h in resumed.history] != mesh.local_devices:
        raise RuntimeError("40: a resumed carry is not on its shard's card")
    dumps, _ = resumed.run(lambda i: chunks[i], 2)
    torch.cuda.synchronize()
    if len(dumps) != 1 or _digest(dumps[0].vis) != digest6:
        raise RuntimeError(f"40 {layout}: the checkpoint did not resume to "
                           "phase 6's sha256")
    print(f"[40 checkpoint {layout}] rank {rank}: {os.path.basename(path)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, shards of "
          f"{len(mesh.local_cards)} cards), resumed in a fresh runner: chunks "
          f"3-4 -> dump sha256 phase 6's; the cut of a chunk to the rank's "
          f"cards {cut_ms:.3f} ms", flush=True)
    _rank_result(40, resumed=True, cut_ms=cut_ms)


def _rank_main(argv) -> int:
    """A rank of phases 32-34, 37-39 and 40: ``--rank
    {32-33,34,37-39,38,40} DIGEST6 DIGEST36 DIR``.  Its cards are
    ``local_cards()``; phases 32-39 run on the first."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dc_sand_tpu_torch.parallel import ipc
    from dc_sand_tpu_torch.parallel.distributed import (init_distributed,
                                                        local_cards)
    if not torch.cuda.is_available():
        raise RuntimeError("a rank of phases 32-40 found no CUDA device")
    init_distributed()
    cards = local_cards()
    torch.cuda.set_device(cards[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which, digest6, digest36, tmp = argv
    if which == "40":
        _phase_40(cards, digest6, digest36, tmp)
    else:
        {"32-33": _phases_32_33, "34": _phase_34, "37-39": _phases_37_39,
         "38": _phase_38}[which](cards[0], digest6, digest36, tmp)
    ipc.close_all()
    dist.destroy_process_group()
    return 0


def _phase_40_main(digest6, digest36, n_cards, mesh_step_ms, card) -> None:
    """Phase 40 on a host of ``n_cards`` >= 2 cards: the cards' links
    (``nvidia-smi topo -m``, and the first card's NVLink status, which
    answers where the matrix is refused), then ``SHARDS`` fx shards over
    ranks of one card each (as many ranks as cards) and over 2 ranks of 2
    cards each (with 4 cards), through ``run_ranks`` (on 2 or 4 cards);
    each rank checks its part (:func:`_phase_40`), and this prints the
    numbers beside phase 16's one-process mesh."""
    import subprocess
    for argv in (["nvidia-smi", "topo", "-m"],
                 ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        got = subprocess.run(argv, capture_output=True, text=True,
                             timeout=60)
        print(f"[40 topology] {' '.join(argv)}:", flush=True)
        for line in (got.stdout or got.stderr).splitlines():
            print(f"    {line}", flush=True)
    # ranks of one card each, then (on 4) 2 ranks of 2 cards each
    layouts = {2: [2], 4: [4, 2]}.get(n_cards, [])
    if len(layouts) < 2:
        print(f"[40 several cards] 2 ranks of 2 cards each need 4 cards"
              + ("" if layouts else ", ranks of one card each 2 or 4")
              + f", {n_cards} present: not run", flush=True)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = [_spawn_ranks(["40", digest6, digest36, tmp], timeout=600,
                                world=w) for w in layouts]
    took = time.perf_counter() - t
    for ranks in results:
        def pick(rank, key):
            return next(r[key] for r in ranks[rank] if key in r)

        world = len(ranks)
        layout = pick(0, "layout")
        runs = [pick(r, "run") for r in range(world)]
        dev_runs = [pick(r, "dev_run") for r in range(world)]
        idle, busy, traced = _idle_share(runs)
        idle_d, busy_d, traced_d = _idle_share(dev_runs)
        print(f"[40 fx64 {layout}] every rank's dump sha256 phase 6's; "
              f"launches a rank {[x['launches'] for x in runs]}; steady run() "
              "per chunk " + ", ".join(
                  f"rank {r} {x['step_ms']:.3f} ms (device step "
                  f"{x['device_step_ms']:.3f} ms, {x['barriers']:.1f} "
                  f"barriers {x['barrier_ms']:.3f} ms host, "
                  f"{x['flag_rounds']:.1f} flag rounds)"
                  for r, x in enumerate(runs))
              + f"; traced run: device busy summed over the cards "
              f"{busy:.3f} ms in {traced:.3f} ms, idle share over all cards "
              + (f"{idle:.4f}" if idle is not None else "not measured (the "
                 "traces' clocks do not line up)")
              + "; in the device coarse mode dumps phase 36's, run() per "
              "chunk " + ", ".join(f"{x['step_ms']:.3f}" for x in dev_runs)
              + " ms (barriers a chunk " + ", ".join(
                  f"{x['barriers']:.1f}" for x in dev_runs) + ", "
              + ", ".join(f"{x['barrier_ms']:.3f}" for x in dev_runs)
              + " ms host), idle share over all cards "
              + (f"{idle_d:.4f}" if idle_d is not None else "not measured")
              + f" (busy {busy_d:.3f} ms in {traced_d:.3f} ms)"
              + (f"; phase 16's one-process 4-way mesh {mesh_step_ms[16]:.3f}"
                 " ms" if mesh_step_ms else "") + f" ({card})", flush=True)
        for key, what in (("k7b", "K7b (corner-turn mode)"),
                          ("k7a", "K7a (time ring, time_local)")):
            x = [pick(r, key) for r in range(world)]
            print(f"[40 {what} {layout}] bitwise its plain version; kernel "
                  + ", ".join(f"{k['ms']:.4f}" for k in x) + " ms a call a "
                  "rank, alone " + ", ".join(f"{k['kernel_ms']:.4f}"
                                             for k in x)
                  + " ms, on the device with its flag rounds " + ", ".join(
                      f"{k['span_ms']:.4f}" for k in x) + " ms, "
                  + ", ".join(f"{k.get('gb_s_card', 0.0):.2f}" for k in x)
                  + " GB/s a card to the others ("
                  + f"{x[0].get('cross_mb', 0.0):.1f} MB a card a call; NVLink "
                  f"bound {x[0].get('link_bound_ms', 0.0):.4f} ms); copy_ on "
                  "the same route " + ", ".join(
                      f"{k['library_ms']:.4f}" for k in x) + " ms; plain "
                  + ", ".join(f"{k['plain_ms']:.3f}" for k in x) + " ms"
                  + ("; block mode " + ", ".join(
                      f"{k['block_ms']:.4f} / {k['block_kernel_ms']:.4f} / "
                      f"{k['block_span_ms']:.4f}" for k in x)
                     + " ms (a call / alone / on the device), NCCL "
                     "all_to_all_single " + ", ".join(
                         f"{k['nccl_ms']:.4f} / {k['nccl_kernel_ms']:.4f}"
                         if k["nccl_ms"] is not None
                         else f"not run ({k['nccl_note']})" for k in x)
                     + " ms (a call / on the device)" if "block_ms" in x[0]
                     else "")
                  + ("; NCCL ring step " + ", ".join(
                      f"{k['nccl_ms']:.4f} / {k['nccl_kernel_ms']:.4f}"
                      if k["nccl_ms"] is not None
                      else f"not run ({k['nccl_note']})" for k in x)
                     + " ms (a call / on the device); flag words a card "
                     "waits on a call " + ", ".join(
                         str(k["flag_words"]) for k in x)
                     if "flag_words" in x[0] else "")
                  + f" ({card})", flush=True)
        if pick(0, "cards") == 1:
            continue
        sp = [pick(r, "sp_run") for r in range(world)]
        print(f"[40 fx64 SP, beam64, checkpoint {layout}] SP (time inside "
              f"each rank, its halo card to card) dumps phase 6's, run() per "
              "chunk " + ", ".join(f"{x['step_ms']:.3f}" for x in sp)
              + " ms, the halo's flag rounds a chunk " + ", ".join(
                  f"{x['halo_flag_rounds']:.1f}" for x in sp)
              + " (all flag rounds a chunk " + ", ".join(
                  f"{x['flag_rounds']:.1f}" for x in sp)
              + "); beam64 " + ", ".join(
                  f"{'beam-parallel' if x['ep'] else 'replicated'} "
                  f"{x['snr_beams']:.2f} dB" for r in range(world)
                  for x in ranks[r] if "ep" in x)
              + " from one card's, bitwise the one-process mesh's; the "
              "per-rank checkpoint resumed to phase 6's sha256; the cut of a "
              "chunk to a rank's cards " + ", ".join(
                  f"{pick(r, 'cut_ms'):.3f}" for r in range(world))
              + f" ms ({card})", flush=True)
    print(f"[40 several cards] {took:.1f} s ({card})", flush=True)


def _k1_against_plain(got, chunk, window, nch, history, frac_delay, phase,
                      gains) -> tuple:
    """K1's int8 wire spectra ``got`` ``(S, B, K, 2)`` against its plain
    version, :data:`PLAIN_BLOCK_STREAMS` streams at a time: ``(max |diff|,
    flips a stream, plain)``, ``plain()`` running the plain version alone
    (for the caller to time)."""
    import torch
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
    blocks = [slice(i, i + PLAIN_BLOCK_STREAMS)
              for i in range(0, chunk.shape[0], PLAIN_BLOCK_STREAMS)]

    def plain_of(sl):
        return fengine_fused(chunk[sl], window, TAPS, nch,
                             history=history[sl], frac_delay=frac_delay[sl],
                             phase=phase[sl], gains=gains, impl="torch")

    worst, flips = 0, torch.zeros(chunk.shape[0], dtype=torch.int64)
    for sl in blocks:
        d = (got[sl].to(torch.int16) - plain_of(sl).to(torch.int16)).abs()
        worst = max(worst, int(d.max()))
        flips[sl] = (d > 0).sum(dim=(1, 2, 3)).cpu()
    return worst, flips, lambda: [plain_of(sl) for sl in blocks]


def _certify_flips(got, chunk, window, nch, history, frac_delay, phase,
                   gains, w, label) -> None:
    """Each flip of stream ``w`` of ``got`` from its plain version must
    round a float64 golden pre-round value within
    :data:`FLIP_BOUNDARY_TOL` of a .5 boundary, where float32 FFTs summing
    in other orders may round either way (a wrong rounding mode or phase
    flips away from them)."""
    import numpy as np
    import torch
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
    from dc_sand_tpu_torch.ops.pfb import taps_pad_for
    hist, fd, ph, one = history, frac_delay, phase, slice(w, w + 1)
    want = fengine_fused(chunk[one], window, TAPS, nch, history=hist[one],
                         frac_delay=fd[one], phase=ph[one], gains=gains,
                         impl="torch")
    diff = (got[one].to(torch.int16) - want.to(torch.int16)).cpu().numpy()
    pad0 = taps_pad_for(TAPS) - TAPS + 1
    x = torch.cat([hist[w, pad0:], chunk[w]]).reshape(1, -1).cpu().numpy()
    g = gains.double().cpu().numpy()
    pre = golden.f_engine(x, window.double().cpu().numpy(), TAPS, nch,
                          frac_delay=fd[one].double().cpu().numpy(),
                          phase=ph[one].double().cpu().numpy()) * (
                              g[:, 0] + 1j * g[:, 1])
    v = np.stack([pre.real, pre.imag], -1)[diff != 0]
    dist = np.abs(v - np.floor(v) - 0.5)
    print(f"[{label}] stream {w}: {v.size} flips, largest distance of a "
          f"flip's golden pre-round value from a .5 boundary "
          f"{dist.max(initial=0):.2e} (limit {FLIP_BOUNDARY_TOL})", flush=True)
    if (dist >= FLIP_BOUNDARY_TOL).any():
        raise RuntimeError(f"{label}: the F-engine kernel flips a value away "
                           "from a .5 rounding boundary")


def _phase_41(dev, card) -> dict:
    """Phase 41 (see the module docstring): K1 at M = 65536 against its
    plain version at the 32k cell's chunk, then a 32k ``FXRunner``.
    Returns the numbers of its kernels' entries."""
    import numpy as np
    import torch
    from dc_sand_tpu_torch.bench.harness import bound_ms, fengine_flops
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
    from dc_sand_tpu_torch.ops.pfb import taps_pad_for
    from dc_sand_tpu_torch.ops.xcorr import cmac_pitch, wire_to_operand
    from dc_sand_tpu_torch.bench.fixtures import noise_int8, production_runner
    from dc_sand_tpu_torch.windows import pfb_window

    s, b, m, nch = FX64_STREAMS, WIDE_SPECTRA, WIDE_M, WIDE_M // 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(WIDE_SEED)
    hist = noise_int8(gen, (s, taps_pad_for(TAPS), m), dev)
    chunk = noise_int8(gen, (s, b, m), dev)
    fd = torch.rand((s, b), generator=gen, device=dev) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=dev) - 0.5) * 2 * np.pi
    ang = torch.rand((nch,), generator=gen, device=dev) * 2 * np.pi
    gains = torch.stack([0.05 * torch.cos(ang), 0.05 * torch.sin(ang)], -1)
    window = torch.as_tensor(pfb_window(TAPS, m), dtype=torch.float32,
                             device=dev)
    kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)

    def k1(layout, pitch=None):
        return fengine_fused(chunk, window, TAPS, nch, impl="cuda",
                             layout=layout, pitch=pitch, **kw)

    _zero_counts()
    got = k1("wire")
    _counts(fengine_wide=1)
    err, flips, plain = _k1_against_plain(got, chunk, window, nch, **kw)
    plain_ms = _events_ms(plain, 1)
    flip_frac = int(flips.sum()) / got.numel()
    print(f"[41 fengine 32k] kernel vs plain at {s} x {b} x {nch}: max "
          f"|diff| {err} LSB, flip fraction {flip_frac:.3e} (limit "
          f"{WIDE_MAX_FLIP_FRACTION}), plain {plain_ms:.3f} ms "
          f"({PLAIN_BLOCK_STREAMS}-stream blocks) ({card})", flush=True)
    if err > 1 or flip_frac > WIDE_MAX_FLIP_FRACTION:
        raise RuntimeError("41: the M = 65536 kernel disagrees with its "
                           "plain version")
    _certify_flips(got, chunk, window, nch, w=int(torch.argmax(flips)),
                   label="41 fengine 32k", **kw)
    pitch = cmac_pitch(b) + 16
    op = k1("operand", pitch)
    if op.shape != (nch, 2, s, pitch) or not torch.equal(
            op, wire_to_operand(got, pitch)):
        raise RuntimeError("41: the operand layout != wire_to_operand of "
                           "the wire layout")
    if op[..., b:].any():
        raise RuntimeError("41: the operand layout's pad is not zeros")
    del op
    torch.cuda.empty_cache()
    wire_ms, operand_ms = _turns_ms(
        [lambda: k1("wire"), lambda: k1("operand", cmac_pitch(b))], 3, 3)
    bound = bound_ms(_nbytes(chunk, hist, window, fd, ph, gains, got),
                     fengine_flops(s * b, m, TAPS, rotate=True, quant=True))
    print(f"[41 fengine 32k layouts] operand layout at pitch {pitch} "
          f"bitwise wire_to_operand of the wire layout, pad zeros; in turns "
          f"wire {wire_ms:.3f} ms (the cluster kernel), operand "
          f"{operand_ms:.3f} ms at pitch {cmac_pitch(b)} (its transpose "
          f"{operand_ms - wire_ms:.3f}), bound {bound[0]:.3f} ms "
          f"({bound[1]}, {100 * bound[0] / operand_ms:.2f}% of it in the "
          f"operand layout) ({card})", flush=True)
    del got, chunk, hist, fd, ph, kw
    torch.cuda.empty_cache()

    cfg = get_config("fx64").replace(n_chans=nch, spectra_per_chunk=b,
                                     n_spectra_per_acc=2 * b)
    gen.manual_seed(WIDE_SEED)
    runner, chunks = production_runner(cfg, gen, dev, coarse_on_host=False)
    n = len(chunks)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    dumps, _ = runner.run(lambda i: chunks[i % n], n)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = _counts(fengine_wide=n, fengine_wide_operand=n, cmac=n,
                       coarse=n, delay_terms=n)
    a, p = cfg.n_ants, cfg.n_pols
    if len(dumps) != 1 or dumps[0].vis.shape != (
            a * (a + 1) // 2, p, p, nch, 2):
        raise RuntimeError(f"41: expected one dump of {nch} channels, got "
                           f"{[d.vis.shape for d in dumps]}")
    vis = dumps[0].vis
    iu = np.triu_indices(a)
    autos = np.flatnonzero(iu[0] == iu[1])
    for q in range(p):
        au = vis[autos, q, q]
        if au[..., 1].any() or (au[..., 0] < 0).any() or not au.any():
            raise RuntimeError("41: an autocorrelation is not real, >= 0 "
                               "and nonzero")
    print(f"[41 fx 32k] {n} chunks of {b} spectra at {nch} channels -> 1 "
          f"dump; launches {launches}; first run {first_s:.2f} s; sha256 "
          f"{_digest(vis)} ({card})", flush=True)
    del runner, chunks, dumps, vis
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "wire_ms": wire_ms,
            "operand_ms": operand_ms, "plain_ms": plain_ms, "bound": bound}


def _delay_case(case, a, p, t0, seed=0):
    """A delay model of ``case`` whose chunk at ``t0`` exercises it, at the
    rates of the benchmark's traffic (2e-10 samples and 2e-9 rad a sample,
    referenced to sample 0): a drift, quadratic terms, coarse delays
    clipped at 0 and at the budget, exact halves (rounded to even), an
    ``update()``.  ``tests/test_torch_delay_terms.py`` uses the same."""
    import numpy as np
    from dc_sand_tpu_torch.runtime import DelayModel
    rng = np.random.default_rng(seed)
    shape = (a, p)
    dm = DelayModel(d0=rng.uniform(10, 21, shape),
                    d1=rng.uniform(-1, 1, shape) * 2e-10,
                    p0=rng.uniform(-np.pi, np.pi, shape),
                    p1=rng.uniform(-1, 1, shape) * 2e-9,
                    max_delay=GATHER_MAX_DELAY)
    if case == "quadratic":
        dm.d2 = rng.uniform(-1, 1, shape) * 1e-21
        dm.p2 = rng.uniform(-1, 1, shape) * 1e-20
    elif case in ("clip_low", "clip_high"):
        dm.d0 = dm.d0 - 40 if case == "clip_low" else dm.d0 + 30
        dm.t_ref = t0 - 1000
    elif case == "half_even":
        # exact halves at the chunk's start: 0.5, 1.5, ... round to even
        dm.d0 = (np.arange(a * p).reshape(shape) % GATHER_MAX_DELAY) + 0.5
        dm.d1 = np.zeros(shape)
        dm.t_ref = t0
    elif case == "after_update":
        dm.d2 = rng.uniform(-1, 1, shape) * 1e-21
        dm.update(t_ref=max(t0 - 4096, 0), d0=rng.uniform(10, 21, shape),
                  p1=rng.uniform(-1, 1, shape) * 2e-9)
    return dm


def _phase_42(dev, card) -> tuple:
    """The delay-terms kernel at the runner's 128 rows of fx64's and
    beam64's chunks, every case of :data:`DELAY_CASES`: bitwise
    ``DelayModel.evaluate_chunk`` and its plain version on the card; timed
    at fx64's beside both.  Returns ``(ms, plain_ms, bound, None)`` for
    the kernels line."""
    import numpy as np
    import torch
    from dc_sand_tpu_torch.bench.harness import bound_ms
    from dc_sand_tpu_torch.ops.delay_terms import (COEFFICIENTS, delay_terms,
                                                   delay_terms_torch)
    a, p, md = FX64_STREAMS // 2, 2, GATHER_MAX_DELAY

    def case_args(case, b):
        dm = _delay_case(case, a, p, DELAY_T0, seed=b)
        coef = torch.from_numpy(np.stack([
            np.asarray(getattr(dm, k), np.float64).reshape(-1)
            for k in COEFFICIENTS])).to(dev)
        return dm, (coef, float(DELAY_T0 - dm.t_ref), b, FX64_M, md)

    _zero_counts()
    for b in (FX64_SPECTRA, BEAM_SPECTRA):
        for case in DELAY_CASES:
            dm, args = case_args(case, b)
            got = delay_terms(*args)
            plain = tuple(torch.empty_like(x) for x in got)
            delay_terms_torch(*args, plain)
            want = dm.evaluate_chunk(DELAY_T0, b, FX64_M)
            for g, q, w in zip(got, plain, want):
                g_np = g.cpu().numpy()
                w = np.ascontiguousarray(w).reshape(g_np.shape)
                if not (g_np.dtype == w.dtype
                        and torch.equal(g.view(torch.int32),
                                        q.view(torch.int32))
                        and np.array_equal(g_np.view(np.int32),
                                           w.view(np.int32))):
                    raise RuntimeError(f"42 {case} B {b}: the delay-terms "
                                       "kernel != numpy or its plain "
                                       "version")
            coarse = want[0]
            if not {"clip_low": (coarse == 0).any(),
                    "clip_high": (coarse == md).any(),
                    "half_even": (coarse % 2 == 0).all()}.get(case, True):
                raise RuntimeError(f"42 {case}: the case does not reach its "
                                   "edge")
    _counts(delay_terms=2 * len(DELAY_CASES))
    _, args = case_args("quadratic", FX64_SPECTRA)
    got = delay_terms(*args)
    plain = tuple(torch.empty_like(x) for x in got)
    kernel_ms, plain_ms = _turns_ms(
        [lambda: delay_terms(*args, out=got),
         lambda: delay_terms_torch(*args, plain)], 50, 3)
    bound = bound_ms(_nbytes(args[0], *got))
    print(f"[42 delay terms] {FX64_STREAMS} rows at B {FX64_SPECTRA} and "
          f"{BEAM_SPECTRA}, t0 {DELAY_T0}, {len(DELAY_CASES)} models "
          f"({', '.join(DELAY_CASES)}): bitwise numpy's evaluate_chunk and "
          f"the plain version on the card, one launch a call; at B "
          f"{FX64_SPECTRA} kernel {kernel_ms:.4f} ms a call back to back "
          f"(the launches' host rate bounds it), plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.5f} ms ({bound[1]}) ({card})", flush=True)
    _zero_counts()
    return kernel_ms, plain_ms, bound, None


def _phase_41_alone() -> int:
    """``--phase 41``: the build, then phase 41 alone."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 1
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.bench.harness import card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    _phase_41(torch.device("cuda", 0), card())
    return 0


def _phase_40_alone() -> int:
    """``--phase 40``: phase 40 alone, after the build and the fx64 runs
    of phases 6 and 36 on the first card that give the sha256s its ranks
    check (a shorter run on several cards; the script with no arguments
    runs it after phases 1-39)."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 1
    from dc_sand_tpu_torch import _build
    from dc_sand_tpu_torch.bench.harness import card
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.bench.fixtures import production_runner
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    digests = []
    for on_host in (True, False):
        gen = torch.Generator(device=dev)
        gen.manual_seed(FX64_SEED)
        runner, chunks = production_runner(get_config("fx64"), gen, dev,
                                           coarse_on_host=on_host)
        dumps, _ = runner.run(lambda i: chunks[i], len(chunks))
        digests.append(_digest(dumps[0].vis))
        del runner, chunks, dumps
        torch.cuda.empty_cache()
    print(f"[40 alone] phase 6's sha256 {digests[0]}, phase 36's "
          f"{digests[1]} ({card()})", flush=True)
    if torch.cuda.device_count() < 2:
        print(f"[40 several cards] needs 2 or more cards, "
              f"{torch.cuda.device_count()} present", flush=True)
        return 1
    _phase_40_main(*digests, torch.cuda.device_count(), None, card())
    return 0


def _spawn_ranks(args, timeout, world=RANKS, nodes=None) -> list:
    """Run this script's ``--rank`` entry as ``world`` ranks on the card
    (on ``nodes`` nodes of this host, as ``run_ranks`` forms them);
    returns each rank's ``RESULT`` dicts after echoing its lines; raises
    if a rank failed."""
    from dc_sand_tpu_torch.parallel.launch import run_ranks
    results = run_ranks([sys.executable, str(Path(__file__).resolve()),
                         "--rank", *args], world, timeout=timeout,
                        nodes=nodes)
    parsed = []
    for rank, res in enumerate(results):
        mine = []
        for line in res.output.splitlines():
            if line.startswith("RESULT "):
                mine.append(json.loads(line[len("RESULT "):]))
            elif line.strip():
                print(f"    rank {rank}| {line}", flush=True)
        parsed.append(mine)
    bad = [r for r, res in enumerate(results) if res.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of `--rank {' '.join(args)}` "
                           f"failed (exit codes "
                           f"{[results[r].returncode for r in bad]})")
    return parsed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA "
              "device, nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    from dc_sand_tpu_torch import _build, golden
    from dc_sand_tpu_torch.bench import cmac_phases, harness
    from dc_sand_tpu_torch.bench import probes
    from dc_sand_tpu_torch.bench.__main__ import main as bench_main
    from dc_sand_tpu_torch.bench.collectives import cross_bytes
    from dc_sand_tpu_torch.bench.harness import (NVLINK_BYTES_S, bound_ms,
                                                 fengine_flops, time_cuda)
    from dc_sand_tpu_torch.cli import main as cli_main
    from dc_sand_tpu_torch.bench.probes import read_probe, write_probe
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.ops.beamform import beamform
    from dc_sand_tpu_torch.ops.coarse import coarse_gather
    from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
    from dc_sand_tpu_torch.ops.pfb import pfb_fir, taps_pad_for
    from dc_sand_tpu_torch.ops.xcorr import (cmac_pitch, extract_vis,
                                             wire_to_a2, xcorr_accumulate_a2)
    from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, all_to_all,
                                            all_to_all_torch, build_mesh,
                                            ring_permute_right,
                                            ring_permute_right_torch)
    from dc_sand_tpu_torch.bench import membench
    from dc_sand_tpu_torch.bench.ingest_bench import spead_feed
    from dc_sand_tpu_torch.bench.pipelines import ARRAY_REALTIME
    from dc_sand_tpu_torch.dryrun import dryrun_multichip, dryrun_reference
    from dc_sand_tpu_torch.examples import (beam_pointing, fx_observation,
                                            observe, udp_observation)
    from dc_sand_tpu_torch.examples import beams as ex_beams
    from dc_sand_tpu_torch.bench.fixtures import (BEAM_CHUNKS, INGEST_SEED,
                                                  card_spans_us, chrome_trace,
                                                  idle_share, ingest_setup,
                                                  noise_int8,
                                                  production_delay_model,
                                                  production_runner)
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                           save_state)
    from dc_sand_tpu_torch.utils.snr import snr_db
    from dc_sand_tpu_torch.verify import SNR_BOUND, verify_config
    from dc_sand_tpu_torch.windows import pfb_window

    zero_counts, current, counts = _zero_counts, _current_counts, _counts

    def ran(*names):
        """The launch counters, checked: each of ``names`` above 0, every
        other 0."""
        got = current()
        if any(bool(v) != (k in names) for k, v in got.items()):
            raise RuntimeError(f"launch counts {got}: want {names} above 0 "
                               "and 0 for the others")
        return got

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = harness.card()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    # ---- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the CMAC's phases build (phase 3) beside the port's own builds
        phases_build = pool.submit(cmac_phases.phases_library)
        _build.library()
        cmac_phases_lib = phases_build.result()
    print(f"[1 build] nvcc sm_90a, {time.perf_counter() - t:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            print("   ", line.strip(), flush=True)

    # ---- 2. F-engine kernel vs plain at the fx64 chunk shape --------------
    s, b, m, nch = FX64_STREAMS, FX64_SPECTRA, FX64_M, FX64_M // 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hist = noise_int8(gen, (s, TAPS, m), dev)
    chunk = noise_int8(gen, (s, b, m), dev)
    fd = torch.rand((s, b), generator=gen, device=dev) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=dev) - 0.5) * 2 * np.pi
    ang = torch.rand((nch,), generator=gen, device=dev) * 2 * np.pi
    gains = torch.stack([0.05 * torch.cos(ang), 0.05 * torch.sin(ang)], -1)
    window = torch.as_tensor(pfb_window(TAPS, m), dtype=torch.float32,
                             device=dev)
    kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)

    def k1(layout):
        return fengine_fused(chunk, window, TAPS, nch, impl="cuda",
                             layout=layout, **kw)

    got = k1("wire")
    k1_wire_ms = _events_ms(lambda: k1("wire"), 5)
    k1_ms = _events_ms(lambda: k1("operand"), 5)

    k1_err, flips, plain = _k1_against_plain(got, chunk, window, nch, **kw)
    k1_plain_ms = _events_ms(plain, 1)
    flip_frac = int(flips.sum()) / got.numel()
    k1_bound = bound_ms(
        _nbytes(chunk, hist, window, fd, ph, gains, got),
        fengine_flops(s * b, m, TAPS, rotate=True, quant=True))
    print(f"[2 fengine] kernel {k1_wire_ms:.3f} ms (wire layout), plain "
          f"{k1_plain_ms:.3f} ms "
          f"({PLAIN_BLOCK_STREAMS}-stream blocks), bound {k1_bound[0]:.3f} "
          f"ms ({k1_bound[1]}), max |diff| {k1_err} LSB, flip "
          f"fraction {flip_frac:.3e} ({card})", flush=True)
    if k1_err > 1 or flip_frac > MAX_FLIP_FRACTION:
        raise RuntimeError("F-engine kernel disagrees with its plain version")
    # certify the flips of the stream with the most
    _certify_flips(got, chunk, window, nch, w=int(torch.argmax(flips)),
                   label="2 fengine", **kw)
    op = k1("operand")
    if not torch.equal(op.reshape(nch, 2 * s, b), wire_to_a2(got)):
        raise RuntimeError("F-engine operand layout != wire_to_a2 of its "
                           "wire layout")
    ct_ms = _events_ms(lambda: wire_to_a2(got), 5)
    print(f"[2 fengine layouts] operand layout bitwise equal to wire_to_a2 "
          f"of the wire layout; kernel wire {k1_wire_ms:.3f} ms, operand "
          f"{k1_ms:.3f} ms; the corner-turn glue it replaces, wire_to_a2, "
          f"{ct_ms:.3f} ms for {got.numel() / 1e9:.2f} GB ({card})",
          flush=True)
    del got, op, chunk, hist, fd, ph
    torch.cuda.empty_cache()

    # ---- 3. CMAC kernel vs plain at the fx64 shape ------------------------
    ap = FX64_STREAMS
    a2 = torch.randint(-127, 128, (nch, 2 * ap, b), generator=gen,
                       device=dev, dtype=torch.int8)
    acc0 = torch.randint(-2 ** 24, 2 ** 24, (nch, ap, ap), generator=gen,
                         device=dev, dtype=torch.int32)
    cmac_err, plain = 0, {}
    for keep in (1, 0):
        x, y = acc0.clone(), acc0.clone()
        xcorr_accumulate_a2(x, a2, keep=keep, impl="cuda")
        xcorr_accumulate_a2(y, a2, keep=keep, impl="torch")
        cmac_err = max(cmac_err, int((x.to(torch.int64) - y).abs().max()))
        if not torch.equal(x, y):
            raise RuntimeError(f"CMAC kernel != plain version (keep={keep}): "
                               f"{int((x != y).sum())} elements differ")
        plain[keep] = y
    # timed as the main path runs 3 of every 4 chunks: keep = 1, the
    # accumulator read and written
    scratch = acc0.clone()
    cmac_ms = _events_ms(
        lambda: xcorr_accumulate_a2(scratch, a2, keep=1,
                                           impl="cuda"), 5)
    cmac_plain_ms = _events_ms(
        lambda: xcorr_accumulate_a2(scratch, a2, keep=1,
                                           impl="torch"), 1)
    ops = 10 * 2 * 64 * 64 * b * nch   # 10 of the 16 64x64 tile products
    cmac_bound = cmac_phases.cmac_bound(nch, ap, b, 1)
    print(f"[3 cmac] bitwise equal (keep 1 and 0); kernel {cmac_ms:.3f} ms "
          f"({ops / cmac_ms / 1e9:.1f} int8 TOP/s executed), plain "
          f"{cmac_plain_ms:.3f} ms, bound {cmac_bound[0]:.3f} ms "
          f"({cmac_bound[1]}) ({card})", flush=True)
    for bb in CMAC_SPECTRA:
        part = a2.view(-1)[:nch * 2 * ap * bb].view(nch, 2 * ap, bb)
        line = []
        for keep in (1, 0):
            ms = _events_ms(lambda: xcorr_accumulate_a2(
                scratch, part, keep=keep, impl="cuda"), 5)
            bound = cmac_phases.cmac_bound(nch, ap, bb, keep)
            line.append(f"keep {keep} {ms:.3f} ms (bound {bound[0]:.3f}, "
                        f"{bound[0] / ms:.2f} of it)")
        print(f"[3 cmac] B {bb}: {'; '.join(line)} ({card})", flush=True)
    # the split of the kernel's time between its phases, from its build
    # with the clock64 counters, whose result must be the kernel's too
    split = {}
    for keep in (1, 0):
        z = acc0.clone()
        split[keep] = cmac_phases.phase_split(cmac_phases_lib, a2, z, keep)
        if not torch.equal(z, plain[keep]):
            raise RuntimeError("the CMAC's phases build != plain version")
        print(f"[3 cmac] phase shares keep {keep}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in split[keep].items()), flush=True)
    del a2, acc0, x, y, z, plain, scratch, part
    torch.cuda.empty_cache()

    # ---- 4./5. verify fx4 and full-width fx64 against golden --------------
    for name in ("fx4", "fx64"):
        t = time.perf_counter()
        snrs, counters = verify_config(name, device=dev)
        snr = snrs["visibilities"]
        print(f"[verify {name}] visibilities {snr:.2f} dB vs golden over "
              f"{counters.dumps} dumps ({time.perf_counter() - t:.1f} s)",
              flush=True)
        if not snr > SNR_BOUND:
            raise RuntimeError(f"verify {name}: {snr:.2f} dB <= {SNR_BOUND}")

    # ---- 6. fx64 at production cadence ------------------------------------
    cfg = get_config("fx64")
    a, p = cfg.n_ants, cfg.n_pols
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev)
    n_chunks = len(chunks)
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    dumps, counters = runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = counts(fengine=n_chunks, cmac=n_chunks, coarse=n_chunks,
                      delay_terms=n_chunks)
    if len(dumps) != 1 or dumps[0].n_spectra != cfg.n_spectra_per_acc:
        raise RuntimeError(f"expected one {cfg.n_spectra_per_acc}-spectra "
                           f"dump, got {[d.n_spectra for d in dumps]}")
    vis = dumps[0].vis
    n_bl = a * (a + 1) // 2
    if vis.shape != (n_bl, p, p, cfg.n_chans, 2) or vis.dtype != np.int32:
        raise RuntimeError(f"dump shape {vis.shape} {vis.dtype}")
    pairs = golden.baseline_pairs(a)
    autos = np.flatnonzero(pairs[:, 0] == pairs[:, 1])
    for q in range(p):
        au = vis[autos, q, q]
        if au[..., 1].any() or (au[..., 0] < 0).any():
            raise RuntimeError("an autocorrelation is not real and >= 0")
    # steady state: the same chunks again, host clock around synchronised
    # work (coarse shift on the card, both kernels, the dump); the chunks
    # already sit on the card, so no host-to-device copy is paid
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_chunks * 1e3
    # the device step alone (F-engine kernel, corner-turn glue, CMAC
    # kernel, history carry), CUDA events over back-to-back steps
    frames = chunks[0].reshape(a * p, cfg.spectra_per_chunk, cfg.fft_size)
    zeros = torch.zeros((a * p, cfg.spectra_per_chunk), device=dev)
    args = runner._step_args(frames, zeros, zeros)
    dev_step_ms = _events_ms(
        lambda: runner._step(runner.history, runner.vis_acc,
                                    *args, False), 4)
    samples = a * p * cfg.chunk_samples
    print(f"[6 fx64 production] {n_chunks} chunks -> 1 dump of "
          f"{dumps[0].n_spectra} spectra; launches {launches}; first run "
          f"{first_s:.2f} s; steady run() per chunk {step_ms:.3f} ms = "
          f"{samples / step_ms / 1e6:.2f} Gsamp/s (device-resident chunks: "
          f"coarse shift on the card and dump included, host-to-device copy "
          f"excluded); device step {dev_step_ms:.3f} ms = "
          f"{samples / dev_step_ms / 1e6:.2f} Gsamp/s ({card})", flush=True)
    print(f"[6 fx64 production] dump digest {_digest(vis)}", flush=True)
    vis_fused = vis               # held for phases 13, 16, 17, 21, 22
    step_ms_fx64 = step_ms
    del runner, chunks, frames, zeros, args, dumps, vis
    torch.cuda.empty_cache()

    # ---- 7. beam kernel vs plain at the beam64 shape ----------------------
    na = FX64_STREAMS // 2

    def beam_check(n_ants, n_beams, n_spectra):
        """Kernel vs plain on seeded inputs: (q, weights, float beams dB,
        max |diff|, incoherent bitwise, int8 scale, int8 max |diff| in LSB,
        int8 flip fraction); raises where they disagree."""
        q = noise_int8(gen, (n_ants, 2, n_spectra, nch, 2), dev)
        bw = torch.randn((n_beams, n_ants, nch, 2), generator=gen, device=dev)
        got, inc = beamform(q, bw, incoherent=True, impl="cuda")
        want, inc_w = beamform(q, bw, incoherent=True, impl="torch")
        snr = _snr_db(want, got)
        err = float((got - want).abs().max())
        inc_equal = torch.equal(inc, inc_w)
        qs = BEAM_QUANT_RMS / float(want.double().pow(2).mean().sqrt())
        got_q, _ = beamform(q, bw, quant_scale=qs, impl="cuda")
        want_q, _ = beamform(q, bw, quant_scale=qs, impl="torch")
        dq = (got_q.to(torch.int16) - want_q.to(torch.int16)).abs()
        q_max, q_flips = int(dq.max()), float((dq > 0).double().mean())
        if not (snr >= BEAM_SNR_DB and inc_equal and q_max <= 1
                and q_flips <= MAX_FLIP_FRACTION):
            raise RuntimeError(
                f"beam kernel disagrees with its plain version at {n_ants} "
                f"antennas, {n_beams} beams: {snr:.2f} dB, incoherent "
                f"bitwise {inc_equal}, int8 max |diff| {q_max}, flips "
                f"{q_flips:.3e}")
        return q, bw, snr, err, inc_equal, qs, q_max, q_flips

    q, bw, beam_snr, beam_err, inc_equal, qs, q_max, q_flips = beam_check(
        na, BEAMS, BEAM_SPECTRA)
    beam_ms = _events_ms(
        lambda: beamform(q, bw, incoherent=True, impl="cuda"), 10)
    beam_plain_ms = _events_ms(
        lambda: beamform(q, bw, incoherent=True, impl="torch"), 2)
    # the library yardstick: the coherent beams as one complex64 matmul
    # batched over channels, (K, nb, a) @ (K, a, p*B), on inputs already
    # converted to complex64 (the conversion is not timed)
    xc = torch.complex(q[..., 0].float(), q[..., 1].float()).permute(
        3, 0, 1, 2).reshape(nch, na, 2 * BEAM_SPECTRA).contiguous()
    wc = torch.complex(bw[..., 0], bw[..., 1]).permute(2, 0, 1).contiguous()
    beam_lib_ms = _events_ms(lambda: torch.matmul(wc, xc), 5)
    del xc, wc
    # 8 useful flops per complex MAC, once, at the bf16 tensor-core peak
    # (the kernel spends three passes on them); the incoherent sum's 4
    # flops a sample at the fp32 peak; every byte once
    flops = 8 * BEAMS * 2 * BEAM_SPECTRA * nch * na
    out_bytes = BEAMS * 2 * BEAM_SPECTRA * nch * 2 * 4
    inc_bytes = 2 * BEAM_SPECTRA * nch * 4
    beam_bound = bound_ms(_nbytes(q, bw) + out_bytes + inc_bytes,
                          fp32_ops=4 * 2 * BEAM_SPECTRA * nch * na,
                          bf16_ops=flops)
    print(f"[7 beamform] float beams {beam_snr:.2f} dB vs plain (max |diff| "
          f"{beam_err:.3e}), incoherent bitwise {inc_equal}; int8 at "
          f"scale {qs:.5f}: max |diff| {q_max} LSB, flip fraction "
          f"{q_flips:.3e}; kernel {beam_ms:.3f} ms "
          f"({flops / beam_ms / 1e9:.2f} useful TFLOP/s, "
          f"{(_nbytes(q, bw) + out_bytes + inc_bytes) / beam_ms / 1e6:.1f} "
          f"GB/s), plain {beam_plain_ms:.3f} ms, complex64 matmul "
          f"{beam_lib_ms:.3f} ms, bound {beam_bound[0]:.3f} ms "
          f"({beam_bound[1]}) ({card})", flush=True)
    del q, bw
    torch.cuda.empty_cache()
    # a mesh shard's call (16 antennas) and the bench's 64-beam call
    for n_ants, n_beams, n_spectra in ((na // SHARDS, BEAMS, BEAM_SPECTRA),
                                       (na, 4 * BEAMS, 64)):
        q, bw, snr, err, _, _, q_max, q_flips = beam_check(n_ants, n_beams,
                                                           n_spectra)
        ms = _events_ms(
            lambda: beamform(q, bw, incoherent=True, impl="cuda"), 10)
        print(f"[7 beamform] {n_ants} antennas, {n_beams} beams, "
              f"{n_spectra} spectra: float beams {snr:.2f} dB vs plain (max "
              f"|diff| {err:.3e}), incoherent bitwise True, int8 max |diff| "
              f"{q_max} LSB, flip fraction {q_flips:.3e}; kernel {ms:.3f} ms "
              f"({card})", flush=True)
        del q, bw
        torch.cuda.empty_cache()

    # ---- 8. verify beam64 at full width against golden --------------------
    t = time.perf_counter()
    snrs, counters = verify_config("beam64", device=dev)
    print(f"[8 verify beam64] beams {snrs['beams']:.2f} dB, incoherent "
          f"{snrs['incoherent']:.2f} dB vs golden over {counters.chunks_in} "
          f"chunks ({time.perf_counter() - t:.1f} s)", flush=True)
    if not (snrs["beams"] > SNR_BOUND and snrs["incoherent"] > SNR_BOUND):
        raise RuntimeError(f"verify beam64: {snrs} not all > {SNR_BOUND}")

    # ---- 9. beam64 at its own cadence -------------------------------------
    cfg = get_config("beam64")
    gen.manual_seed(BEAM_SEED)
    runner, chunks = production_runner(cfg, gen, dev)
    n_chunks = len(chunks)
    outs = []
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks,
               on_output=lambda i, o: outs.append(o))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    beam_launches = counts(fengine=BEAM_CHUNKS, beamform=BEAM_CHUNKS,
                           coarse=BEAM_CHUNKS, delay_terms=BEAM_CHUNKS)
    b = cfg.spectra_per_chunk
    for o in outs:
        beams, inc = o["beams"], o["incoherent"]
        if (beams.shape != (BEAMS, 2, b, nch, 2) or inc.shape != (2, b, nch)
                or beams.dtype != torch.float32 or not beams.is_cuda):
            raise RuntimeError(f"beam outputs {beams.shape} {beams.dtype} "
                               f"{beams.device}, incoherent {inc.shape}")
        if (not torch.isfinite(beams).all() or (inc < 0).any()
                or not torch.equal(inc, torch.round(inc))):
            raise RuntimeError("beams not finite, or an incoherent value "
                               "is not a non-negative integer")
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    beam_run_ms = (time.perf_counter() - t) / n_chunks * 1e3
    frames = chunks[0].reshape(FX64_STREAMS, b, FX64_M)
    zeros = torch.zeros((FX64_STREAMS, b), device=dev)
    args = runner._step_args(frames, zeros, zeros)
    beam_step_ms = _events_ms(
        lambda: runner._step(runner.history, runner.vis_acc,
                                    *args, False), 8)
    d2h_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        {k: v.cpu() for k, v in outs[-1].items()}
        d2h_ms.append((time.perf_counter() - t) * 1e3)
    samples = FX64_STREAMS * cfg.chunk_samples
    print(f"[9 beam64 production] {n_chunks} chunks of {b} spectra; "
          f"launches {beam_launches}; first run {first_s:.2f} s; device "
          f"step {beam_step_ms:.3f} ms = {samples / beam_step_ms / 1e6:.2f} "
          f"Gsamp/s; steady run() per chunk {beam_run_ms:.3f} ms = "
          f"{samples / beam_run_ms / 1e6:.2f} Gsamp/s (device-resident "
          f"chunks, outputs left on the card) ({card})", flush=True)
    out_mb = sum(v.numel() * v.element_size() for v in outs[-1].values()) / 1e6
    print(f"[9 beam64 outputs to host] one chunk's {out_mb:.1f} MB of beams "
          f"and incoherent beam, device-to-host copy into pageable memory: "
          + ", ".join(f"{x:.3f}" for x in d2h_ms) + f" ms ({card})",
          flush=True)

    beam_ref = outs                 # held on the card for phase 18
    del runner, chunks, frames, zeros, args
    torch.cuda.empty_cache()

    # ---- 10. PFB-FIR kernel (K6) vs plain at the fx64 chunk shape ---------
    s, b, m = FX64_STREAMS, FX64_SPECTRA, FX64_M
    hist = noise_int8(gen, (s, taps_pad_for(TAPS), m), dev)
    chunk = noise_int8(gen, (s, b, m), dev)

    def k6():
        return pfb_fir(chunk, window, TAPS, m, history=hist, impl="cuda")

    got = k6()
    pfb_ms = _events_ms(k6, 5)
    pfb_errs = []

    def plain_fir(compare):
        for i in range(0, s, PLAIN_BLOCK_STREAMS):
            sl = slice(i, i + PLAIN_BLOCK_STREAMS)
            want = pfb_fir(chunk[sl], window, TAPS, m, history=hist[sl],
                           impl="torch")
            if compare:
                pfb_errs.append(float((got[sl] - want).abs().max()))
                if not torch.equal(got[sl], want):
                    raise RuntimeError(f"PFB kernel != plain version in "
                                       f"streams {sl.start}..{sl.stop - 1}")

    plain_fir(True)
    pfb_err = max(pfb_errs)
    pfb_plain_ms = _events_ms(lambda: plain_fir(False), 1)
    pfb_bound = bound_ms(_nbytes(chunk, hist, window, got),
                         2 * TAPS * s * b * m)
    # the library yardstick: a depthwise conv1d over frames, (S, M, F)
    # float32 with weights (M, 1, taps), TF32 off (set above)
    pad0 = taps_pad_for(TAPS) - TAPS + 1
    n_f = TAPS - 1 + b
    xf = torch.empty((s, m, n_f), device=dev)
    for i in range(0, s, PLAIN_BLOCK_STREAMS):
        sl = slice(i, i + PLAIN_BLOCK_STREAMS)
        xf[sl] = torch.cat([hist[sl, pad0:], chunk[sl]], 1).float().transpose(
            1, 2)
    wconv = window.reshape(TAPS, m).t().reshape(m, 1, TAPS).contiguous()
    conv = torch.nn.functional.conv1d(xf, wconv, groups=m)
    conv_diff = float((conv[:2].transpose(1, 2) - got[:2]).abs().max())
    del conv
    pfb_lib_ms = _events_ms(
        lambda: torch.nn.functional.conv1d(xf, wconv, groups=m), 3)
    print(f"[10 pfb] bitwise equal to plain (split I/O, {s} streams x "
          f"{TAPS}+{b} frames x {m}); kernel {pfb_ms:.3f} ms, plain "
          f"{pfb_plain_ms:.3f} ms ({PLAIN_BLOCK_STREAMS}-stream blocks), "
          f"conv1d(groups=M) {pfb_lib_ms:.3f} ms (max |diff| to the kernel "
          f"{conv_diff:.3e}), bound {pfb_bound[0]:.3f} ms ({pfb_bound[1]}) "
          f"({card})", flush=True)
    del got, chunk, hist, xf, wconv
    torch.cuda.empty_cache()

    # ---- 11. K1 float output vs plain at the F-engine bench shape ---------
    bs, bb, bm = BENCH_STREAMS, BENCH_SPECTRA, 2 * BENCH_CHANS
    xs = noise_int8(gen, (bs, (bb + TAPS - 1) * bm), dev)
    wb = torch.as_tensor(pfb_window(TAPS, bm, "hann"), dtype=torch.float32,
                         device=dev)
    fdb = torch.rand((bs, bb), generator=gen, device=dev) - 0.5
    phb = (torch.rand((bs, bb), generator=gen, device=dev) - 0.5) * 2 * np.pi
    float_snr, float_err = float("inf"), 0.0
    for kw in ({}, {"frac_delay": fdb, "phase": phb}):
        got = fengine_fused(xs, wb, TAPS, BENCH_CHANS, impl="cuda", **kw)
        want = fengine_fused(xs, wb, TAPS, BENCH_CHANS, impl="torch", **kw)
        if got.dtype != torch.float32 or got.shape != (bs, bb,
                                                       BENCH_CHANS, 2):
            raise RuntimeError(f"float F-engine output {got.dtype} "
                               f"{tuple(got.shape)}")
        float_snr = min(float_snr, _snr_db(want, got))
        float_err = max(float_err, float((got - want).abs().max()))
    float_ms = _events_ms(
        lambda: fengine_fused(xs, wb, TAPS, BENCH_CHANS,
                                     impl="cuda"), 10)
    float_plain_ms = _events_ms(
        lambda: fengine_fused(xs, wb, TAPS, BENCH_CHANS,
                                     impl="torch"), 3)
    float_bound = bound_ms(_nbytes(xs, wb, got),
                           fengine_flops(bs * bb, bm, TAPS, rotate=False,
                                         quant=False))
    print(f"[11 fengine float] {float_snr:.2f} dB vs plain, worst of "
          f"without and with the phasor (max |diff| {float_err:.3e}); "
          f"kernel {float_ms:.3f} ms, plain {float_plain_ms:.3f} ms, bound "
          f"{float_bound[0]:.4f} ms ({float_bound[1]}) at {bs} streams x "
          f"{bb} spectra x {BENCH_CHANS} channels, no phasor ({card})",
          flush=True)
    if not float_snr >= FLOAT_SNR_DB:
        raise RuntimeError(f"float F-engine kernel {float_snr:.2f} dB from "
                           f"its plain version, want >= {FLOAT_SNR_DB}")
    del xs, wb, fdb, phb, got, want

    # ---- 12. verify pfb1k and pfb4k on both F-engine paths ----------------
    fengine_launches = {}
    for name in ("pfb1k", "pfb4k"):
        for fused in (True, False):
            zero_counts()
            t = time.perf_counter()
            snrs, counters = verify_config(name, device=dev, fused=fused)
            torch.cuda.synchronize()
            n = counters.chunks_in
            want = ({"fengine_float" if name == "pfb1k" else "fengine": n}
                    if fused else {"pfb": n})
            want["delay_terms"] = n     # the feed's, delay or none
            if get_config(name).apply_delay:     # the feed's coarse shift
                want["coarse"] = n
            got_counts = counts(**want)
            fengine_launches[(name, fused)] = got_counts
            snr = snrs["spectra"]
            print(f"[12 verify {name} {'fused' if fused else 'unfused'}] "
                  f"spectra {snr:.2f} dB vs golden over {n} chunks; "
                  f"launches {got_counts} ({time.perf_counter() - t:.1f} s)",
                  flush=True)
            if not snr > SNR_BOUND:
                raise RuntimeError(f"verify {name} fused={fused}: "
                                   f"{snr:.2f} dB <= {SNR_BOUND}")
    torch.cuda.empty_cache()

    # ---- 13. fx64 production cadence through the unfused F-engine --------
    cfg = get_config("fx64")
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev, fused=False)
    n_chunks = len(chunks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    dumps, _ = runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    unfused_launches = counts(pfb=n_chunks, cmac=n_chunks, coarse=n_chunks,
                              delay_terms=n_chunks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(dumps) != 1 or dumps[0].vis.shape != vis_fused.shape:
        raise RuntimeError("the unfused fx64 run made no dump of phase 6's "
                           "shape")
    vis_snr = snr_db(vis_fused[..., 0] + 1j * vis_fused[..., 1],
                     dumps[0].vis[..., 0] + 1j * dumps[0].vis[..., 1])
    print(f"[13 fx64 unfused] dump digest {_digest(dumps[0].vis)}",
          flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_chunks * 1e3
    frames = chunks[0].reshape(a * p, cfg.spectra_per_chunk, cfg.fft_size)
    zeros = torch.zeros((a * p, cfg.spectra_per_chunk), device=dev)
    args = runner._step_args(frames, zeros, zeros)
    dev_step_ms = _events_ms(
        lambda: runner._step(runner.history, runner.vis_acc,
                                    *args, False), 4)
    samples = a * p * cfg.chunk_samples
    print(f"[13 fx64 unfused] {n_chunks} chunks -> 1 dump, {vis_snr:.2f} dB "
          f"from phase 6's fused dump; launches {unfused_launches}; first "
          f"run {first_s:.2f} s; steady run() per chunk {step_ms:.3f} ms = "
          f"{samples / step_ms / 1e6:.2f} Gsamp/s (device-resident chunks); "
          f"device step {dev_step_ms:.3f} ms = "
          f"{samples / dev_step_ms / 1e6:.2f} Gsamp/s; peak device memory "
          f"{peak_gb:.2f} GB ({card})", flush=True)
    if not vis_snr >= UNFUSED_SNR_DB:
        raise RuntimeError(f"unfused fx64 dump {vis_snr:.2f} dB from the "
                           f"fused one, want >= {UNFUSED_SNR_DB}")

    del runner, chunks, dumps, frames, zeros, args
    torch.cuda.empty_cache()

    # ---- 14. peer-copy all-to-all (K7b) vs plain at the fx64 corner-turn --
    shard_devs = [torch.device("cuda", i % torch.cuda.device_count())
                  for i in range(SHARDS)]
    n_cards = len(set(shard_devs))
    fx_mesh = build_mesh(shard_devs)
    ct_shape = (nch, FX64_STREAMS // 2 // SHARDS, 2, FX64_SPECTRA, 2)
    xs = [torch.randint(-127, 128, ct_shape, generator=gen, device=dev,
                        dtype=torch.int8).to(d) for d in shard_devs]
    zero_counts()
    got = all_to_all(xs, fx_mesh, FX_AXIS, impl="cuda")
    if all_to_all.launches != n_cards:
        raise RuntimeError(f"all-to-all: {all_to_all.launches} launches, "
                           f"expected one a card ({n_cards})")
    want = all_to_all_torch(xs, fx_mesh, FX_AXIS)
    if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
        raise RuntimeError("all-to-all kernel != plain version")
    del got, want
    a2a_block_plain_ms = _events_ms(
        lambda: all_to_all_torch(xs, fx_mesh, FX_AXIS), 3)
    rows = nch // SHARDS
    outs_lib = [torch.empty_like(x) for x in xs]

    def copy_blocks(blocks):
        for dst, src, d_rows, s_rows in blocks:
            dst[d_rows].copy_(src[s_rows])

    a2a_blocks = [(outs_lib[j], xs[s], slice(s * rows, (s + 1) * rows),
                   slice(j * rows, (j + 1) * rows))
                  for j in range(SHARDS) for s in range(SHARDS)]
    a2a_block_ms, a2a_block_lib_ms = _turns_ms(
        (lambda: all_to_all(xs, fx_mesh, FX_AXIS, impl="cuda"),
         lambda: copy_blocks(a2a_blocks)), 5)
    a2a_bound = bound_ms(2 * _nbytes(*xs))
    # across cards: the most bytes one card sends to the others a call
    a2a_cross = cross_bytes(fx_mesh, fx_mesh.all_to_all_sends(FX_AXIS),
                            _nbytes(xs[0]) // SHARDS)

    def across(ms, lib_ms):
        if not a2a_cross:
            return ""
        return (f"; {a2a_cross / 1e6:.1f} MB a card to the other cards: "
                f"kernel {a2a_cross / ms / 1e6:.2f} GB/s a card, copy_ "
                f"{a2a_cross / lib_ms / 1e6:.2f}, NVLink bound "
                f"{a2a_cross / NVLINK_BYTES_S * 1e3:.4f} ms")

    print(f"[14 all_to_all block mode] bitwise equal to plain, {SHARDS} "
          f"shards of int8 {ct_shape} on {[str(d) for d in shard_devs]}; "
          f"kernel {a2a_block_ms:.3f} ms "
          f"({_nbytes(*xs) / a2a_block_ms / 1e6:.1f} GB/s of payload), plain "
          f"{a2a_block_plain_ms:.3f} ms, copy_ of the {SHARDS * SHARDS} "
          f"blocks {a2a_block_lib_ms:.3f} ms, bound {a2a_bound[0]:.3f} ms "
          f"({a2a_bound[1]}){across(a2a_block_ms, a2a_block_lib_ms)} "
          f"({card})", flush=True)
    del xs, outs_lib, a2a_blocks
    torch.cuda.empty_cache()
    # corner-turn mode: operand-layout shards (K, 2, s_l, b), each block's
    # 2 * k_l rows landing at the receiver's pitch of SHARDS * s_l * b
    s_l, k_l = FX64_STREAMS // SHARDS, nch // SHARDS
    xs = [torch.randint(-127, 128, (nch, 2, s_l, FX64_SPECTRA),
                        generator=gen, device=dev, dtype=torch.int8).to(d)
          for d in shard_devs]
    ct_rows = 2 * k_l
    got = all_to_all(xs, fx_mesh, FX_AXIS, rows=ct_rows, impl="cuda")
    want = all_to_all_torch(xs, fx_mesh, FX_AXIS, rows=ct_rows)
    if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
        raise RuntimeError("all-to-all kernel != plain version (corner-turn "
                           "mode)")
    del got, want
    a2a_plain_ms = _events_ms(lambda: all_to_all_torch(
        xs, fx_mesh, FX_AXIS, rows=ct_rows), 3)
    outs_lib = [torch.empty_like(x) for x in xs]
    views = [(o.view(ct_rows, SHARDS, -1)[:, my],
              x.view(SHARDS, ct_rows, -1)[r])
             for r, o in enumerate(outs_lib) for my, x in enumerate(xs)]

    def copy_views():
        for dst, src in views:
            dst.copy_(src)

    a2a_ms, a2a_lib_ms = _turns_ms(
        (lambda: all_to_all(xs, fx_mesh, FX_AXIS, rows=ct_rows, impl="cuda"),
         copy_views), 5)
    print(f"[14 all_to_all corner-turn mode] bitwise equal to plain, "
          f"{SHARDS} shards of operand-layout int8 {tuple(xs[0].shape)}, "
          f"{ct_rows} rows a block; kernel {a2a_ms:.3f} ms "
          f"({_nbytes(*xs) / a2a_ms / 1e6:.1f} GB/s of payload), plain "
          f"{a2a_plain_ms:.3f} ms, copy_ into the {SHARDS * SHARDS} strided "
          f"views {a2a_lib_ms:.3f} ms, bound {a2a_bound[0]:.3f} ms "
          f"({a2a_bound[1]}){across(a2a_ms, a2a_lib_ms)} ({card})",
          flush=True)
    del xs, outs_lib, views
    torch.cuda.empty_cache()

    # ---- 15. peer-copy ring step (K7a) vs plain ---------------------------
    halo_shape = (FX64_STREAMS // 2, taps_pad_for(TAPS), FX64_M)
    for n in (SHARDS, 2):
        ring_mesh = build_mesh(shard_devs[:n], time_shards=n)
        xs = [torch.randint(-127, 128, halo_shape, generator=gen, device=dev,
                            dtype=torch.int8).to(d) for d in shard_devs[:n]]
        got = ring_permute_right(xs, ring_mesh, TIME_AXIS, impl="cuda")
        want = ring_permute_right_torch(xs, ring_mesh, TIME_AXIS)
        if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
            raise RuntimeError(f"ring kernel != plain version ({n} shards)")
        ms = _events_ms(lambda: ring_permute_right(
            xs, ring_mesh, TIME_AXIS, impl="cuda"), 20)
        plain = _events_ms(lambda: ring_permute_right_torch(
            xs, ring_mesh, TIME_AXIS), 20)
        outs_lib = [torch.empty_like(x) for x in xs]
        blocks = [(outs_lib[(i + 1) % n], xs[i], slice(None), slice(None))
                  for i in range(n)]
        lib = _events_ms(lambda: copy_blocks(blocks), 20)
        bound = bound_ms(2 * _nbytes(*xs))
        print(f"[15 ring] bitwise equal to plain, {n}-shard ring of int8 "
              f"{halo_shape}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"copy_ of the {n} blocks {lib:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}) ({card})", flush=True)
        if n == SHARDS:
            ring_ms, ring_plain_ms, ring_lib_ms, ring_bound = (ms, plain, lib,
                                                               bound)
        del xs, got, want, outs_lib, blocks
    # both rings of two of a (time 2, fx 2) mesh ride in one launch a card
    sp_mesh = build_mesh(shard_devs, time_shards=2)
    xs = [noise_int8(gen, halo_shape, dev).to(d) for d in shard_devs]
    for axis in (TIME_AXIS, FX_AXIS):
        zero_counts()
        got = ring_permute_right(xs, sp_mesh, axis, impl="cuda")
        n_launches = ring_permute_right.launches
        want = ring_permute_right_torch(xs, sp_mesh, axis)
        if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
            raise RuntimeError(f"ring kernel != plain version on the (2, 2) "
                               f"mesh, axis {axis}")
        if n_launches != n_cards:
            raise RuntimeError(f"(2, 2) ring over {axis}: {n_launches} "
                               f"launches, expected one a card ({n_cards})")
    del got, want
    # the wrapper's host time per call, the card left to run behind
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        ring_permute_right(xs, sp_mesh, TIME_AXIS, impl="cuda")
    ring_host_ms = (time.perf_counter() - t) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"[15 ring] (time 2, fx 2) mesh: both axes bitwise equal to plain, "
          f"{n_cards} launch(es) a call for {SHARDS} shards; wrapper host "
          f"time {ring_host_ms:.4f} ms a call ({card})", flush=True)
    del xs

    # ---- 16./17. fx64 on a 4-way fx mesh and on a (2, 2) SP mesh ----------
    mesh_launches, mesh_step_ms = {}, {}
    for phase, time_shards in ((16, 1), (17, 2)):
        cfg = get_config("fx64").replace(time_shards=time_shards)
        mesh = build_mesh(shard_devs, time_shards=time_shards)
        gen.manual_seed(FX64_SEED)
        runner, chunks = production_runner(cfg, gen, shard_devs[0],
                                           mesh=mesh)
        n_chunks = len(chunks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t = time.perf_counter()
        dumps, _ = runner.run(lambda i: chunks[i % n_chunks], n_chunks)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        n_sh = n_chunks * SHARDS
        got_counts = counts(fengine=n_sh, cmac=n_sh,
                            all_to_all=n_chunks * n_cards,
                            ring=n_chunks * n_cards if time_shards > 1 else 0,
                            coarse=n_chunks, delay_terms=n_chunks)
        mesh_launches[phase] = got_counts
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(dumps) != 1 or not np.array_equal(dumps[0].vis, vis_fused):
            raise RuntimeError(f"phase {phase}: the sharded fx64 dump is not "
                               "bitwise equal to phase 6's")
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.run(lambda i: chunks[i % n_chunks], n_chunks)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) / n_chunks * 1e3
        mesh_step_ms[phase] = step_ms
        frames = chunks[0].reshape(a * p, cfg.spectra_per_chunk, cfg.fft_size)
        zeros = torch.zeros((a * p, cfg.spectra_per_chunk), device=dev)
        args = runner._step_args(frames, zeros, zeros)
        dev_step_ms = _events_ms(
            lambda: runner._step(runner.history, runner.vis_acc,
                                        *args, False), 4)
        samples = a * p * cfg.chunk_samples
        print(f"[{phase} fx64 mesh time {time_shards} x fx "
              f"{SHARDS // time_shards}] {n_chunks} chunks -> 1 dump bitwise "
              f"equal to phase 6's; launches {got_counts}; first run "
              f"{first_s:.2f} s; steady run() per chunk {step_ms:.3f} ms = "
              f"{samples / step_ms / 1e6:.2f} Gsamp/s (device-resident "
              f"chunks); device step {dev_step_ms:.3f} ms = "
              f"{samples / dev_step_ms / 1e6:.2f} Gsamp/s; peak device memory "
              f"{peak_gb:.2f} GB on {shard_devs[0]} ({card})", flush=True)
        del runner, chunks, dumps, frames, zeros, args
        torch.cuda.empty_cache()

    # ---- 18. beam64 on a 4-way fx mesh, replicated and beam-parallel ------
    beam_outs = {}
    for ep in (False, True):
        cfg = get_config("beam64").replace(beam_parallel=ep)
        gen.manual_seed(BEAM_SEED)
        runner, chunks = production_runner(cfg, gen, shard_devs[0],
                                           mesh=fx_mesh)
        n_chunks = len(chunks)
        outs = []
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        runner.run(lambda i: chunks[i % n_chunks], n_chunks,
                   on_output=lambda i, o: outs.append(o))
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) / n_chunks * 1e3
        n_sh = n_chunks * SHARDS
        got_counts = counts(fengine=n_sh, beamform=n_sh, coarse=n_chunks,
                            delay_terms=n_chunks)
        beam_outs[ep] = outs
        snr_b = min(_snr_db(r["beams"], o["beams"])
                    for r, o in zip(beam_ref, outs))
        snr_i = min(_snr_db(r["incoherent"], o["incoherent"])
                    for r, o in zip(beam_ref, outs))
        print(f"[18 beam64 mesh fx {SHARDS}{' beam-parallel' if ep else ''}] "
              f"{n_chunks} chunks; beams {snr_b:.2f} dB, incoherent "
              f"{snr_i:.2f} dB from phase 9's; launches {got_counts}; run() "
              f"per chunk {run_ms:.3f} ms, first run, outputs left on the "
              f"card ({card})", flush=True)
        if not (snr_b >= BEAM_SNR_DB and snr_i >= BEAM_SNR_DB):
            raise RuntimeError("sharded beam64 disagrees with phase 9")
        del runner, chunks
    if not all(torch.equal(r["beams"], e["beams"])
               for r, e in zip(beam_outs[False], beam_outs[True])):
        raise RuntimeError("beam-parallel beams != the replicated beams")
    print(f"[18 beam64 mesh] each fx shard's {BEAMS // SHARDS} beam-parallel "
          f"beams equal its slice of the replicated beams, bitwise",
          flush=True)
    del beam_outs, beam_ref, outs
    torch.cuda.empty_cache()

    # ---- 19. read and write probes (P1, P2) vs plain ----------------------
    xp = torch.randint(-128, 128, (probes.S, probes.NF, probes.M),
                       generator=gen, device=dev, dtype=torch.int8)
    pk = dict(tb=probes.TB, nb=probes.NB)
    wk = (probes.S, probes.NB, probes.TB, probes.M2, probes.K1N)
    tile, sums = read_probe(xp, impl="cuda", **pk)
    tile_w, sums_w = read_probe(xp, impl="torch", **pk)
    wp = write_probe(*wk, device=dev, impl="cuda")
    wp_w = write_probe(*wk, device=dev, impl="torch")
    torch.cuda.synchronize()
    if not (torch.equal(tile, tile_w) and torch.equal(sums, sums_w)):
        raise RuntimeError("read probe kernel != plain version")
    if not torch.equal(wp, wp_w):
        raise RuntimeError("write probe kernel != plain version")
    rows = probes.NB * probes.TB
    n_read = probes.S * rows * probes.M
    wp_lib = torch.empty_like(wp)
    probe_times = {}
    for name, kernel, plain, lib, nbytes, adds in (
            ("read_probe", lambda: read_probe(xp, impl="cuda", **pk),
             lambda: read_probe(xp, impl="torch", **pk),
             lambda: xp[:, :rows].sum(dtype=torch.int64),
             n_read + _nbytes(tile, sums), n_read),
            ("write_probe", lambda: write_probe(*wk, device=dev, impl="cuda"),
             lambda: write_probe(*wk, device=dev, impl="torch"),
             lambda: wp_lib.fill_(1), _nbytes(wp), 0)):
        cold = time_cuda(kernel, warmup=2, iters=200, flush_l2=True) * 1e3
        warm = _events_ms(kernel, 200)
        plain_ms = time_cuda(plain, warmup=1, iters=20, flush_l2=True) * 1e3
        lib_ms = time_cuda(lib, warmup=1, iters=20, flush_l2=True) * 1e3
        bound = bound_ms(nbytes, int8_ops=adds)
        probe_times[name] = (cold, plain_ms, bound, lib_ms)
        print(f"[19 {name}] bitwise equal to plain; kernel {cold:.4f} ms "
              f"with the L2 flushed ({nbytes / cold / 1e6:.1f} GB/s), "
              f"{warm:.4f} ms back to back ({nbytes / warm / 1e6:.1f} GB/s); "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) for {nbytes / 1e6:.1f} MB "
              f"({card})", flush=True)
    del xp, tile, sums, tile_w, sums_w, wp, wp_w, wp_lib
    torch.cuda.empty_cache()

    # ---- 20. the bench entry: its headline, then its probes target -------
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    if bench_main([]) != 0:
        raise RuntimeError("the bench entry's headline failed")
    torch.cuda.synchronize()
    headline_counts = ran("fengine", "cmac")
    print(f"[20 bench headline] launches {headline_counts} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    zero_counts()
    t = time.perf_counter()
    if bench_main(["probes"]) != 0:
        raise RuntimeError("the bench entry's probes target failed")
    torch.cuda.synchronize()
    probe_counts = ran("read_probe", "write_probe")
    print(f"[20 bench probes] launches {probe_counts} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # ---- 21. checkpoint at full width: save after 2 chunks, resume ------
    digest6 = _digest(vis_fused)
    with tempfile.TemporaryDirectory() as tmp:
        for label, mesh in (("one card", None),
                            (f"{SHARDS}-way fx mesh", fx_mesh)):
            cfg = get_config("fx64")
            gen.manual_seed(FX64_SEED)
            first, chunks = production_runner(
                cfg, gen, shard_devs[0] if mesh else dev, mesh=mesh)
            first.run(lambda i: chunks[i], 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = save_state(first, os.path.join(tmp, "fx64"))
            save_s = time.perf_counter() - t
            size_mb = os.path.getsize(path) / 1e6
            resumed = FXRunner(
                cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                delay_model=DelayModel.zeros(cfg.n_ants, cfg.n_pols, 32),
                device=None if mesh else dev, mesh=mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            load_state(resumed, path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            zero_counts()
            dumps, _ = resumed.run(lambda i: chunks[i], 2)
            torch.cuda.synchronize()
            n_sh = 2 * (mesh.size if mesh else 1)
            got_counts = counts(fengine=n_sh, cmac=n_sh,
                                all_to_all=2 * n_cards if mesh else 0,
                                coarse=2, delay_terms=2)
            if len(dumps) != 1 or _digest(dumps[0].vis) != digest6:
                raise RuntimeError(f"phase 21 ({label}): the resumed dump is "
                                   "not phase 6's")
            print(f"[21 checkpoint {label}] saved after chunk 2, resumed for "
                  f"chunks 3-4: dump sha256 equal to phase 6's; file "
                  f"{size_mb:.1f} MB, save {save_s:.3f} s, load {load_s:.3f} "
                  f"s; launches {got_counts} ({card})", flush=True)
            os.remove(path)
            del first, resumed, chunks, dumps
            torch.cuda.empty_cache()

    # ---- 22. run_batched at fx64: one window, one CUDA-graph replay -------
    cfg = get_config("fx64")
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev)
    n_chunks = len(chunks)
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    dumps, _ = runner.run_batched(lambda i: chunks[i % n_chunks], n_chunks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    # the wrappers count calls: one warm-up step, then the captured window
    batched_counts = counts(fengine=n_chunks + 1, cmac=n_chunks + 1,
                            coarse=n_chunks,   # the feed's, not captured
                            delay_terms=n_chunks)
    captured, replays = runner.graph_launches, runner.graph_replays
    if (captured != {"fengine": n_chunks, "pfb": 0, "cmac": n_chunks,
                     "coarse": 0} or replays != 1):
        raise RuntimeError(f"run_batched captured {captured} in {replays} "
                           f"replays, want K1 and the CMAC {n_chunks} each "
                           "in 1")
    if len(dumps) != 1 or not np.array_equal(dumps[0].vis, vis_fused):
        raise RuntimeError("run_batched's fx64 dump is not phase 6's")
    # steady state: the same chunks through both, in turns, host clock
    # around synchronised work (feed, coarse shift, steps, dump)
    per_chunk = {"run_batched": [], "run": []}
    for name in ("run_batched", "run", "run", "run_batched") * 3:
        fn = getattr(runner, name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(lambda i: chunks[i % n_chunks], n_chunks)
        torch.cuda.synchronize()
        per_chunk[name].append((time.perf_counter() - t) / n_chunks * 1e3)
    print(f"[22 run_batched fx64] {n_chunks} chunks -> 1 dump bitwise equal "
          f"to phase 6's in {replays} replay of one CUDA "
          f"graph (K1 {captured['fengine']}, CMAC {captured['cmac']} "
          f"captured); launches {batched_counts} (one warm-up step "
          f"uncaptured); first call {first_s:.2f} s (build, capture); ms "
          f"a chunk in turns, median run_batched "
          f"{statistics.median(per_chunk['run_batched']):.3f} against run() "
          f"{statistics.median(per_chunk['run']):.3f} (phase 6: "
          f"{step_ms_fx64:.3f}); run_batched "
          + ", ".join(f"{x:.3f}" for x in per_chunk["run_batched"])
          + "; run() " + ", ".join(f"{x:.3f}" for x in per_chunk["run"])
          + f"; device-resident chunks ({card})", flush=True)
    del runner, chunks, dumps
    torch.cuda.empty_cache()
    zero_counts()
    t = time.perf_counter()
    if bench_main(["runner"]) != 0:
        raise RuntimeError("the bench entry's runner target failed")
    torch.cuda.synchronize()
    runner_counts = ran("fengine", "cmac", "delay_terms")
    print(f"[22 bench runner] launches {runner_counts} "
          f"({time.perf_counter() - t:.1f} s) ({card})", flush=True)

    # ---- 23. the command line, in process ---------------------------------
    def cli_lines(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        lines = out.getvalue().splitlines()
        for line in lines:
            print(f"[23 cli {argv[0]}] {line}", flush=True)
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(argv)}: exit code {rc}")
        return lines

    cli_lines(["info"])
    cfg = get_config("fx4")
    g = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        lines = cli_lines(["run", "fx4", "--chunks", str(8 * g), "--batched",
                           "--checkpoint", os.path.join(tmp, "cli")])
        cli_counts = ran("fengine", "cmac", "delay_terms")
        path = lines[-1].removeprefix("state saved to ")
        window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
        shape = (cfg.n_ants, cfg.n_pols, cfg.chunk_samples)

        def source(i):
            return golden.gaussian_noise_int8(shape, 20.0, i)

        want, _ = FXRunner(cfg, window, device=dev).run(source, 10 * g)
        resumed = FXRunner(cfg, window, device=dev)
        load_state(resumed, path)
        got, _ = resumed.run_batched(source, 2 * g)
    if len(got) != 2 or not all(np.array_equal(a.vis, b.vis)
                                for a, b in zip(got, want[8:])):
        raise RuntimeError("cli run --checkpoint: the resumed dumps are not "
                           "the uninterrupted run's")
    print(f"[23 cli run] 8 windows batched, checkpoint resumed for 2 more: "
          f"dumps equal to an uninterrupted run's; launches {cli_counts} "
          f"({card})", flush=True)
    lines = cli_lines(["verify", "fx4"])
    snr = float(lines[0].split(": ")[1].split()[0])
    if not snr > SNR_BOUND:
        raise RuntimeError(f"cli verify fx4: {snr} dB <= {SNR_BOUND}")

    # ---- 24. fx64 at full width through the ingest ------------------------
    # the slice's main path: SPEAD bursts -> 4 pinned assemblers of 16
    # antennas (coarse delay at placement) -> the copy stream -> the runner
    cfg = get_config("fx64")
    a, p = cfg.n_ants, cfg.n_pols
    g = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    samples = a * p * cfg.chunk_samples
    gen.manual_seed(INGEST_SEED)
    chunk, host, delays, runner_dm, reference_dm = ingest_setup(cfg, gen,
                                                                dev)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    t = time.perf_counter()
    feeder, ingests, submit_ms = spead_feed(
        host, 2 * g, n_workers=INGEST_WORKERS, delays=delays, max_delay=32,
        cfg=cfg, device=dev)
    setup_s = time.perf_counter() - t
    if not all(ing.pinned for ing in ingests):
        raise RuntimeError("an assembler's slots are not pinned")
    pinned_gb = sum(ing.n_slots for ing in ingests) * samples / len(
        ingests) / 1e9
    runner = FXRunner(cfg, window, delay_model=runner_dm, device=dev)
    dump_at = []
    torch.cuda.synchronize()
    zero_counts()
    try:
        dumps, _ = runner.run(
            feeder, 2 * g,
            on_dump=lambda d: dump_at.append(time.perf_counter()))
        torch.cuda.synchronize()
    finally:
        feeder.close()
    ingest_counts = counts(fengine=2 * g, cmac=2 * g, delay_terms=2 * g)
    ingest_stats = [ing.stats() for ing in ingests]
    for ing in ingests:
        ing.close()
    if any(st["packets_late"] or st["packets_bad"] or st["packets_clipped"]
           for st in ingest_stats):
        raise RuntimeError(f"the assemblers lost packets: {ingest_stats}")
    ref_dumps, _ = FXRunner(cfg, window, delay_model=reference_dm,
                            device=dev).run(lambda i: chunk, 2 * g)
    if len(dumps) != 2 or not all(np.array_equal(d.vis, r.vis)
                                  for d, r in zip(dumps, ref_dumps)):
        raise RuntimeError("the fx64 dumps fed through the ingest are not "
                           "the device-fed reference's")
    window2_ms = (dump_at[1] - dump_at[0]) / g * 1e3
    copy_ms = list(feeder.source.copy_ms)
    frames = chunk.view(a * p, cfg.spectra_per_chunk, cfg.fft_size)
    zeros = torch.zeros((a * p, cfg.spectra_per_chunk), device=dev)
    args = runner._step_args(frames, zeros, zeros)
    ingest_step_ms = _events_ms(
        lambda: runner._step(runner.history, runner.vis_acc, *args, False), 4)
    vis_dev = extract_vis(runner._acc_total(), a, p).contiguous()
    pinned_vis = torch.empty(vis_dev.shape, dtype=vis_dev.dtype,
                             pin_memory=True)
    d2h = {"pinned": [], "pageable": []}
    for kind in ("pinned", "pageable", "pageable", "pinned") * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "pinned":
            pinned_vis.copy_(vis_dev, non_blocking=True)
        else:
            vis_dev.cpu()
        torch.cuda.synchronize()
        d2h[kind].append((time.perf_counter() - t) * 1e3)
    dump_mb = vis_dev.numel() * vis_dev.element_size() / 1e6
    h2d = membench.bench_h2d(device=dev)
    print(f"[24 fx64 ingest] {2 * g} chunks through {len(ingests)} pinned "
          f"assemblers of {a // len(ingests)} antennas ({pinned_gb:.2f} GB "
          f"of slots; packetize and pin {setup_s:.1f} s) -> 2 dumps bitwise "
          f"equal to the device-fed reference (coarse delay at placement "
          f"against on the card); launches {ingest_counts}; ingest "
          f"counters {ingest_stats}", flush=True)
    print(f"[24 fx64 ingest] dump digests {_digest(dumps[0].vis)} "
          f"{_digest(dumps[1].vis)}", flush=True)
    print(f"[24 fx64 ingest] submit ms ({len(ingests)} threads, median) "
          f"{statistics.median(submit_ms):.3f}; host-to-device ms a chunk "
          f"on the copy stream (events) median "
          f"{statistics.median(copy_ms):.3f} = "
          f"{samples / statistics.median(copy_ms) / 1e6:.2f} GB/s ("
          + ", ".join(f"{x:.3f}" for x in copy_ms) + f"); device step "
          f"{ingest_step_ms:.3f} ms; dump device-to-host of {dump_mb:.1f} MB "
          f"pinned median {statistics.median(d2h['pinned']):.3f} ms = "
          f"{dump_mb / statistics.median(d2h['pinned']):.2f} GB/s, pageable "
          f"{statistics.median(d2h['pageable']):.3f} ms; window 2 wall "
          f"{window2_ms:.3f} ms a chunk = {samples / window2_ms / 1e6:.2f} "
          f"Gsamp/s, {samples / window2_ms * 1e3 / ARRAY_REALTIME:.4f} of the "
          f"array in real time (feed overlapped); bench_h2d "
          f"{h2d.bytes_moved / 1e6:.0f} MB pinned "
          f"{h2d.extra['pinned_gb_s']:.2f} GB/s, pageable "
          f"{h2d.value:.2f} GB/s ({card})", flush=True)
    del runner, chunk, host, frames, zeros, args, dumps, ref_dumps, vis_dev
    del pinned_vis, feeder
    torch.cuda.empty_cache()

    # ---- 25. the wire leg at a small shape --------------------------------
    out = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(out):
        rc = udp_observation.main([])
    wire_counts = ran("fengine", "cmac", "delay_terms")
    for line in out.getvalue().splitlines():
        print(f"[25 udp wire leg] {line}", flush=True)
    if rc != 0:
        raise RuntimeError("the wire leg's dump is not the device-fed run's, "
                           "or its onward SPEAD copy is not bitwise")
    print(f"[25 udp wire leg] launches {wire_counts} ({card})", flush=True)

    # ---- 26. the CMAC at ragged B, fx64's K and ap ------------------------
    ap, nch = FX64_STREAMS, FX64_M // 2
    gen.manual_seed(26)
    ragged_ms = {}
    for bb in RAGGED_SPECTRA:
        a2 = torch.randint(-127, 128, (nch, 2 * ap, bb), generator=gen,
                           device=dev, dtype=torch.int8)
        acc0 = torch.randint(-2 ** 24, 2 ** 24, (nch, ap, ap), generator=gen,
                             device=dev, dtype=torch.int32)
        for keep in (0, 1):
            x, y = acc0.clone(), acc0.clone()
            before = xcorr_accumulate_a2.launches
            xcorr_accumulate_a2(x, a2, keep=keep, impl="cuda")
            if xcorr_accumulate_a2.launches != before + 1:
                raise RuntimeError("the CMAC wrapper did not count one launch "
                                   f"a call at B={bb}")
            xcorr_accumulate_a2(y, a2, keep=keep, impl="torch")
            if not torch.equal(x, y):
                raise RuntimeError(f"CMAC kernel != plain version at B={bb} "
                                   f"(keep={keep}): {int((x != y).sum())} "
                                   "elements differ")
        ragged_ms[bb] = _events_ms(lambda: xcorr_accumulate_a2(
            x, a2, keep=1, impl="cuda"), 5)
    # B = 2040 as the fx step hands it over: K1's operand at pitch 2048
    padded = torch.zeros((nch, 2 * ap, cmac_pitch(bb)), dtype=torch.int8,
                         device=dev)
    padded[..., :bb] = a2
    z = xcorr_accumulate_a2(acc0.clone(), padded, keep=0, impl="cuda")
    if not torch.equal(z, xcorr_accumulate_a2(acc0.clone(), a2, keep=0,
                                              impl="torch")):
        raise RuntimeError("CMAC on the pitched operand != plain version")
    pitched_ms = _events_ms(lambda: xcorr_accumulate_a2(
        z, padded, keep=1, impl="cuda"), 5)
    print(f"[26 cmac ragged] K {nch}, ap {ap}, B {RAGGED_SPECTRA}, keep 0 and "
          f"1: bitwise equal to the plain version, one launch a call; keep 1 "
          + ", ".join(f"B {k} {v:.3f} ms" for k, v in ragged_ms.items())
          + f" (unpadded operand: the wrapper's pad copy and the kernel); "
          f"B {bb} at pitch {cmac_pitch(bb)} (K1's operand) {pitched_ms:.3f} "
          f"ms; B {FX64_SPECTRA} {cmac_ms:.3f} ms (phase 3) ({card})",
          flush=True)
    del a2, acc0, x, y, z, padded
    torch.cuda.empty_cache()

    # ---- 27. K1 in the operand layout at a pitch, fx64 width --------------
    s, m, nch = FX64_STREAMS, FX64_M, FX64_M // 2
    gen.manual_seed(27)
    hist = noise_int8(gen, (s, TAPS, m), dev)
    window = torch.as_tensor(pfb_window(TAPS, m), dtype=torch.float32,
                             device=dev)
    pitched = {}
    for bb in (24, 2040, FX64_SPECTRA):
        chunk = noise_int8(gen, (s, bb, m), dev)
        fd = torch.rand((s, bb), generator=gen, device=dev) - 0.5
        ph = (torch.rand((s, bb), generator=gen, device=dev) - 0.5) * 2 * np.pi
        kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)

        def k1_op(pitch=None):
            return fengine_fused(chunk, window, TAPS, nch, impl="cuda",
                                 layout="operand", pitch=pitch, **kw)

        pitch = cmac_pitch(bb)
        # the output reuses this block of stale bytes: the pad must be stored
        junk = torch.full((nch * 2 * s * pitch,), 77, dtype=torch.int8,
                          device=dev)
        del junk
        got = k1_op(pitch)
        pitched[bb] = _events_ms(lambda: k1_op(pitch), 5)
        if bb == FX64_SPECTRA:
            continue
        if got[..., bb:].any():
            raise RuntimeError(f"K1's operand pad is not zero at B={bb}")
        if not torch.equal(got[..., :bb], k1_op()):
            raise RuntimeError(f"K1's pitched operand != its unpitched one at "
                               f"B={bb}")
        worst, flips = 0, 0
        for i in range(0, s, PLAIN_BLOCK_STREAMS):
            sl = slice(i, i + PLAIN_BLOCK_STREAMS)
            want = fengine_fused(chunk[sl], window, TAPS, nch,
                                 history=hist[sl], frac_delay=fd[sl],
                                 phase=ph[sl], gains=gains, impl="torch")
            d = (got[:, :, sl, :bb].permute(2, 3, 0, 1).to(torch.int16)
                 - want.to(torch.int16)).abs()
            worst, flips = max(worst, int(d.max())), flips + int((d > 0).sum())
        frac = flips / (s * bb * nch * 2)
        print(f"[27 fengine pitched] B {bb} at pitch {pitch}: pad zero, "
              f"[..., :B] bitwise the unpitched kernel's, max |diff| "
              f"{worst} LSB and flip fraction {frac:.3e} against the plain "
              f"version", flush=True)
        if worst > 1 or frac > MAX_FLIP_FRACTION:
            raise RuntimeError(f"K1's pitched operand disagrees with its plain "
                               f"version at B={bb}")
    print(f"[27 fengine pitched] kernel, operand layout: B 24 at pitch 32 "
          f"{pitched[24]:.3f} ms; B 2040 at pitch 2048 {pitched[2040]:.3f} "
          f"ms; B {FX64_SPECTRA} {pitched[FX64_SPECTRA]:.3f} ms ({card})",
          flush=True)
    del hist, chunk, fd, ph, got, want, d
    torch.cuda.empty_cache()

    # ---- 28. verify fx64 at full width on 24-spectra chunks ---------------
    zero_counts()
    t = time.perf_counter()
    snrs, counters = verify_config("fx64", device=dev, spectra_per_chunk=24,
                                   n_spectra_per_acc=48)
    verify_counts = ran("fengine", "cmac", "coarse", "delay_terms")
    snr = snrs["visibilities"]
    print(f"[28 verify fx64 ragged] 24-spectra chunks, 48-spectra dumps: "
          f"visibilities {snr:.2f} dB vs golden over {counters.dumps} dumps "
          f"({time.perf_counter() - t:.1f} s); launches {verify_counts} "
          f"({card})", flush=True)
    if not snr > SNR_BOUND:
        raise RuntimeError(f"verify fx64 at 24 spectra: {snr:.2f} dB <= "
                           f"{SNR_BOUND}")

    # ---- 29. the four examples without ingest, in process -----------------
    for ex in (fx_observation, observe, ex_beams, beam_pointing):
        name = ex.__name__.rsplit(".", 1)[1]
        out = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(out):
            rc = ex.main([])
        ex_counts = current()
        for line in out.getvalue().splitlines():
            if line.strip():
                print(f"[29 {name}] {line}", flush=True)
        if rc != 0 or "PASS" not in out.getvalue().split():
            raise RuntimeError(f"example {name} did not pass on the card")
        if name == "observe":
            ran("fengine", "cmac", "coarse", "delay_terms")
            print(f"[29 observe] launches: K1 {ex_counts['fengine']}, CMAC "
                  f"{ex_counts['cmac']} (8-spectra chunks) ({card})",
                  flush=True)

    # ---- 30. dryrun_multichip on 4 shards of the card ---------------------
    zero_counts()
    dry = dryrun_multichip(SHARDS, devices=[f"cuda:{dev.index or 0}"] * SHARDS)
    dry_counts = current()
    ref = dryrun_reference(SHARDS, device=f"cuda:{dev.index or 0}")
    for name, r in dry.items():
        for key, v in r.outputs.items():
            want = ref[name].outputs[key]
            if v.shape != want.shape or not np.abs(v).max() > 0:
                raise RuntimeError(f"dry run {name}: {key} {v.shape}, want "
                                   f"{want.shape}, nonzero")
            if key in ("vis", "incoherent"):
                ok = np.array_equal(v, want)
            else:
                c = v[..., 0] + 1j * v[..., 1] if key == "beams" else v
                cw = (want[..., 0] + 1j * want[..., 1] if key == "beams"
                      else want)
                ok = snr_db(cw, c) >= BEAM_SNR_DB
            if not ok:
                raise RuntimeError(f"dry run {name}: {key} on {SHARDS} shards "
                                   "!= one card")
    if not all(dry_counts[k] for k in ("fengine", "cmac", "beamform",
                                       "all_to_all", "ring", "pfb",
                                       "coarse")):
        raise RuntimeError(f"the dry run missed a kernel: {dry_counts}")
    print(f"[30 dryrun] {SHARDS} shards on one card: " + ", ".join(
        f"{k} {r.ms:.1f} ms" for k, r in dry.items()) + "; fx dumps and "
        f"incoherent beams bitwise one card's, beams and spectra >= "
        f"{BEAM_SNR_DB} dB from it; launches {dry_counts} ({card})",
        flush=True)

    # ---- 31. bench fengine --profile --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench_main(["fengine", "--profile", tmp])
        trace = Path(tmp) / "fengine_trace.json"
        if rc != 0 or not trace.is_file():
            raise RuntimeError("bench fengine --profile wrote no trace")
        events = json.loads(trace.read_text())["traceEvents"]
        k1_events = [e for e in events if e.get("cat") == "kernel"
                     and "fengine_kernel" in e.get("name", "")]
        if not k1_events:
            raise RuntimeError("the bench's trace names no K1 launch")
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"[31 bench --profile] {trace.name}: {len(events)} events, "
              f"{len(k1_events)} launches of {k1_events[0]['name']}; record "
              f"{rec['name']} {rec['value']:.4g} {rec['unit']} ({card})",
              flush=True)

    # ---- 35. the coarse gather kernel vs plain ----------------------------
    # fx64's chunk, beam64's and a ragged B = 24, 128 streams of M = 8192,
    # delays 0-32 over the streams; the device mode's lead-in (32 + 15
    # frames, history frames written) and the host mode's tail (32)
    md = GATHER_MAX_DELAY
    n_h = (TAPS - 1) * FX64_M
    tp = taps_pad_for(TAPS)
    d = torch.arange(FX64_STREAMS, device=dev, dtype=torch.int32) % (md + 1)
    gather_times = {}
    for label, b in (("fx64", FX64_SPECTRA), ("beam64", BEAM_SPECTRA),
                     ("B 24", 24)):
        gen.manual_seed(35)
        chunk = noise_int8(gen, (FX64_STREAMS, b, FX64_M), dev)
        for lead_len in (md + n_h, md):
            lead = noise_int8(gen, (FX64_STREAMS, lead_len), dev)
            bufs = {}
            for impl in ("cuda", "torch"):
                hist = (torch.zeros((FX64_STREAMS, tp, FX64_M),
                                    dtype=torch.int8, device=dev)
                        if lead_len > md else None)
                out = torch.empty_like(chunk)
                coarse_gather(lead, chunk, d, md, out=out, hist=hist,
                              impl=impl)
                bufs[impl] = (hist, out)
            for x, y in zip(bufs["cuda"], bufs["torch"]):
                if x is not None and not torch.equal(x, y):
                    raise RuntimeError(f"35 {label}, lead {lead_len}: the "
                                       "gather kernel != its plain version")
            hist, out = bufs["cuda"]
            del bufs
            n_out = lead_len - md + chunk.shape[1] * FX64_M
            bound = bound_ms(2 * FX64_STREAMS * n_out + d.numel() * 4)
            kernel_ms, plain_ms = _turns_ms(
                [lambda: coarse_gather(lead, chunk, d, md, out=out,
                                       hist=hist, impl="cuda"),
                 lambda: coarse_gather(lead, chunk, d, md, out=out,
                                       hist=hist, impl="torch")], 3, 3)
            lib_ms = None
            if label == "fx64":
                # the library yardstick: one torch.gather of the delayed
                # stream from [lead | chunk] with an int64 index as large
                # as the output (index and concat made outside the timing)
                buf = torch.cat([lead, chunk.reshape(FX64_STREAMS, -1)], 1)
                idx = ((md - d).to(torch.int64)[:, None]
                       + torch.arange(n_out, device=dev))
                dst = torch.empty((FX64_STREAMS, n_out), dtype=torch.int8,
                                  device=dev)
                lib_ms = _events_ms(
                    lambda: torch.gather(buf, 1, idx, out=dst), 3)
                if not torch.equal(dst[:, lead_len - md:], out.reshape(
                        FX64_STREAMS, -1)):
                    raise RuntimeError("35: torch.gather's delayed stream != "
                                       "the kernel's")
                del buf, idx, dst
            gather_times[(label, lead_len > md)] = (kernel_ms, plain_ms,
                                                    bound, lib_ms)
            print(f"[35 coarse gather {label} "
                  f"{'lead-in' if lead_len > md else 'tail'} {lead_len}] "
                  f"{FX64_STREAMS} x {n_out} samples out, delays 0-{md}: "
                  f"bitwise its plain version; kernel {kernel_ms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]}, "
                  f"{bound[0] / kernel_ms:.2f} of it), plain (cat and "
                  f"{FX64_STREAMS} slice copies, the host shift before) "
                  f"{plain_ms:.3f} ms"
                  + (f", torch.gather {lib_ms:.3f} ms" if lib_ms else "")
                  + f" ({card})", flush=True)
            del lead, hist, out
            torch.cuda.empty_cache()
        del chunk
    torch.cuda.empty_cache()

    # ---- 36. fx64 and beam64 in the device coarse mode --------------------
    from dc_sand_tpu_torch.models import pipeline as pipeline_mod
    window = pfb_window(TAPS, FX64_M)

    @contextlib.contextmanager
    def plain_gather():
        """The step's gather through its plain version (comparison runs
        only; their launches are not counted)."""
        pipeline_mod.coarse_gather = functools.partial(coarse_gather,
                                                       impl="torch")
        try:
            yield
        finally:
            pipeline_mod.coarse_gather = coarse_gather

    def steps_in(cfg, n):
        """Streams whose coarse delay steps within the first n chunks of
        the production model."""
        dm = production_delay_model(cfg, np.random.default_rng(6))
        cs = [dm.evaluate_chunk(i * cfg.chunk_samples, 1, cfg.fft_size)[0]
              for i in range(n)]
        return int(sum((cs[i] != cs[i - 1]).sum() for i in range(1, n)))

    def traced(fn, name):
        """(wall ms, busy ms, idle share) of ``fn`` under the profiler:
        the card's union of device intervals over the host's window, the
        share "not measured" where the trace's clock does not line up with
        the host's."""
        trace = os.path.join(tmp36, f"{name}.json")
        with chrome_trace(trace):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            window = (t * 1e6, time.time() * 1e6)
        doc = json.loads(Path(trace).read_text())
        share, busy, wall, _ = idle_share([{"window_us": window, "spans_us":
            card_spans_us(doc["traceEvents"],
                          doc.get("baseTimeNanoseconds", 0) / 1e3)}])
        return wall, busy, ("not measured" if share is None
                            else f"{share:.4f}")

    tmp36_dir = tempfile.TemporaryDirectory()
    tmp36 = tmp36_dir.name
    cfg = get_config("fx64")
    gen.manual_seed(FX64_SEED)
    runner, chunks = production_runner(cfg, gen, dev, coarse_on_host=False)
    n_chunks = len(chunks)
    src = (lambda i: chunks[i % n_chunks])
    start = save_state(runner, os.path.join(tmp36, "start"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    dumps, _ = runner.run(src, n_chunks)
    torch.cuda.synchronize()
    dev_launches = counts(fengine=n_chunks, cmac=n_chunks, coarse=n_chunks,
                          delay_terms=n_chunks)
    peak36_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(dumps) != 1 or dumps[0].vis.shape != vis_fused.shape:
        raise RuntimeError("36: the device-mode fx64 run made no dump of "
                           "phase 6's shape")
    vis36 = dumps[0].vis
    digest36 = _digest(vis36)
    load_state(runner, start)
    with plain_gather():
        plain_dumps, _ = runner.run(src, n_chunks)
    if not np.array_equal(plain_dumps[0].vis, vis36):
        raise RuntimeError("36: the device-mode fx64 dump != the same run "
                           "through the plain gather")
    n_steps = steps_in(cfg, n_chunks)
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.run(src, n_chunks)
    torch.cuda.synchronize()
    dev_step_ms = (time.perf_counter() - t) / n_chunks * 1e3
    print(f"[36 fx64 device coarse] {n_chunks} chunks -> 1 dump bitwise the "
          f"same run through the plain gather, sha256 {digest36} ("
          + ("equal to" if digest36 == _digest(vis_fused) else "not")
          + f" phase 6's: the model steps {n_steps} streams' coarse delay "
          f"at a chunk boundary, where the device mode gathers the FIR "
          f"overlap again); launches {dev_launches}; steady run() per "
          f"chunk {dev_step_ms:.3f} ms beside phase 6's host shift "
          f"{step_ms_fx64:.3f} ms; peak device memory {peak36_gb:.2f} GB "
          f"(the window's {n_chunks} chunks of "
          f"{chunks[0].numel() / 1e9:.2f} GB resident, the delayed frames "
          f"a buffer of one more) ({card})", flush=True)
    # a constant coarse delay: the two modes bitwise equal from stream start
    const = production_delay_model(cfg, np.random.default_rng(6))
    const.d1 = np.zeros_like(const.d1)
    const_vis = []
    for on_host in (True, False):
        r = FXRunner(cfg, window, delay_model=copy.deepcopy(const),
                     device=dev, coarse_on_host=on_host)
        const_vis.append(r.run(src, n_chunks)[0][0].vis)
        del r
    if not np.array_equal(*const_vis):
        raise RuntimeError("36: under a constant coarse delay the device "
                           "mode's fx64 dump != the host shift's")
    print(f"[36 fx64 constant delay] d1 = 0: the device mode's dump bitwise "
          f"the host shift's, sha256 {_digest(const_vis[1])} ({card})",
          flush=True)
    # run_batched: the gather captured inside the window's graph
    load_state(runner, start)
    zero_counts()
    batched, _ = runner.run_batched(src, n_chunks)
    torch.cuda.synchronize()
    dev_batched_counts = counts(fengine=n_chunks + 1, cmac=n_chunks + 1,
                                coarse=n_chunks + 1, delay_terms=n_chunks)
    captured = runner.graph_launches
    if captured != {"fengine": n_chunks, "pfb": 0, "cmac": n_chunks,
                    "coarse": n_chunks} or runner.graph_replays != 1:
        raise RuntimeError(f"36: run_batched captured {captured} in "
                           f"{runner.graph_replays} replays")
    if not np.array_equal(batched[0].vis, vis36):
        raise RuntimeError("36: run_batched's device-mode dump != run()'s")
    print(f"[36 fx64 device coarse run_batched] 1 replay, the gather "
          f"captured ({captured}); dump bitwise run()'s; launches "
          f"{dev_batched_counts} ({card})", flush=True)
    del runner, chunks, dumps, plain_dumps, batched, const_vis
    torch.cuda.empty_cache()
    # beam64 at its cadence in the device mode, beside the host shift
    cfg = get_config("beam64")
    gen.manual_seed(BEAM_SEED)
    runner, chunks = production_runner(cfg, gen, dev, coarse_on_host=False)
    n_chunks = len(chunks)
    src = (lambda i: chunks[i % n_chunks])
    start = save_state(runner, os.path.join(tmp36, "beam_start"))
    outs, plain_outs = [], []
    zero_counts()
    runner.run(src, n_chunks, on_output=lambda i, o: outs.append(o))
    torch.cuda.synchronize()
    dev_beam_launches = counts(fengine=n_chunks, beamform=n_chunks,
                               coarse=n_chunks, delay_terms=n_chunks)
    load_state(runner, start)
    with plain_gather():
        runner.run(src, n_chunks, on_output=lambda i, o: plain_outs.append(o))
    if not all(torch.equal(x[k], y[k]) for x, y in zip(outs, plain_outs)
               for k in x):
        raise RuntimeError("36: the device-mode beam64 outputs != the same "
                           "run through the plain gather")
    host = FXRunner(cfg, window, delay_model=production_delay_model(
        cfg, np.random.default_rng(6)), weights=runner.weights.cpu().numpy(),
        device=dev)
    beam_idle = {}
    for name, r in (("host", host), ("device", runner), ("host", host),
                    ("device", runner)):
        beam_idle[name] = traced(lambda: r.run(src, n_chunks),
                                 f"beam64_{name}")
    print(f"[36 beam64 device coarse] {n_chunks} chunks; beams and "
          f"incoherent beam bitwise the same run through the plain gather "
          f"({steps_in(cfg, n_chunks)} streams step); launches "
          f"{dev_beam_launches}; run() per chunk (traced window) device mode "
          f"{beam_idle['device'][0] / n_chunks:.3f} ms, idle share "
          f"{beam_idle['device'][2]}, beside the host shift "
          f"{beam_idle['host'][0] / n_chunks:.3f} ms, idle share "
          f"{beam_idle['host'][2]} (phase 9: {beam_run_ms:.3f} ms "
          f"untraced) ({card})", flush=True)
    del runner, host, chunks, outs, plain_outs
    tmp36_dir.cleanup()
    torch.cuda.empty_cache()
    # verify fx64 at full width in the device mode
    zero_counts()
    t = time.perf_counter()
    snrs, counters = verify_config("fx64", device=dev, coarse_on_host=False)
    dev_verify_counts = ran("fengine", "cmac", "coarse", "delay_terms")
    snr = snrs["visibilities"]
    print(f"[36 verify fx64 device coarse] visibilities {snr:.2f} dB vs "
          f"golden over {counters.dumps} dumps ({time.perf_counter() - t:.1f}"
          f" s); launches {dev_verify_counts} ({card})", flush=True)
    if not snr > SNR_BOUND:
        raise RuntimeError(f"36 verify fx64 device coarse: {snr:.2f} dB")
    gather_launches = dev_launches["coarse"] + dev_beam_launches["coarse"]

    # ---- 41. K1 at M = 65536 vs plain; fx at 32768 channels -------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wide = _phase_41(dev, card)

    # ---- 42. the delay-terms kernel vs numpy and its plain version -------
    delay_times = _phase_42(dev, card)

    # ---- 32.-34. two processes on the card -------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = [a + b for a, b in zip(
            _spawn_ranks(["32-33", digest6, digest36, tmp], timeout=600),
            _spawn_ranks(["34", digest6, digest36, tmp], timeout=300))]
    ranks_s = time.perf_counter() - t

    def pick(rank, phase, key):
        return next(r[key] for r in ranks[rank]
                    if r["phase"] == phase and key in r)

    runs = {label: [pick(r, ph, key) for r in range(RANKS)]
            for label, ph, key in (("fx", 32, "run"), ("sp", 33, "sp_run"))}
    k7b, k7a = pick(0, 32, "k7b"), pick(0, 33, "k7a")
    idle, busy_ms, traced_ms = _idle_share(runs["fx"])
    print(f"[32 fx64 {RANKS} ranks] every rank's dump sha256 phase 6's; "
          f"launches a rank {[x['launches'] for x in runs['fx']]}; steady "
          f"run() per chunk " + ", ".join(
              f"rank {r} {x['step_ms']:.3f} ms ({x['barriers']:.1f} barriers, "
              f"{x['barrier_ms']:.3f} ms host)" for r, x in
              enumerate(runs["fx"])) + f"; traced run: device busy (union "
          f"over the ranks) {busy_ms:.3f} ms of {traced_ms:.3f} ms, idle "
          f"share " + (f"{idle:.4f}" if idle is not None else "not measured "
                       "(the traces' clocks do not line up)")
          + f", beside phase 16's "
          f"{mesh_step_ms[16]:.3f} ms in one process; K7b across the ranks "
          f"{k7b['ms']:.4f} ms (plain over gloo {k7b['plain_ms']:.3f}, copy_ "
          f"into the peers' mappings {k7b['library_ms']:.4f}) beside phase "
          f"14's {a2a_ms:.4f} ms in one process; {RANKS} processes "
          f"time-slice one card: not a scaling number ({card})", flush=True)
    dev_runs = [pick(r, 32, "dev_run") for r in range(RANKS)]
    print(f"[32 fx64 {RANKS} ranks device coarse] every rank's dump sha256 "
          f"phase 36's; launches a rank {[x['launches'] for x in dev_runs]}"
          f"; steady run() per chunk " + ", ".join(
              f"rank {r} {x['step_ms']:.3f} ms" for r, x in
              enumerate(dev_runs)) + f" ({card})", flush=True)
    print(f"[33 beam64 {RANKS} ranks] beams "
          + ", ".join(f"{'beam-parallel' if x['ep'] else 'replicated'} "
                      f"{x['snr_beams']:.2f} dB" for r in range(RANKS)
                      for x in ranks[r] if x["phase"] == 33 and "ep" in x)
          + f" from one card's; K7a across the ranks {k7a['ms']:.4f} ms "
          f"(plain {k7a['plain_ms']:.3f}, copy_ {k7a['library_ms']:.4f}) "
          f"beside phase 15's {ring_ms:.4f}; SP fx64 (time within each "
          f"rank) dumps phase 6's, run() per chunk "
          + ", ".join(f"{x['step_ms']:.3f}" for x in runs["sp"])
          + f" ms ({card})", flush=True)
    print(f"[34 checkpoint {RANKS} ranks] files of "
          + ", ".join(f"{pick(r, 34, 'mb'):.1f} MB (save "
                      f"{pick(r, 34, 'save_s'):.3f} s, load "
                      f"{pick(r, 34, 'load_s'):.3f} s)" for r in range(RANKS))
          + f", resumed in new processes to phase 6's sha256, and the device "
          f"coarse mode's files to phase 36's; cli verify fx4 "
          f"--distributed --mesh 4 {pick(0, 34, 'verify_db'):.2f} dB; bench "
          f"collectives ms {pick(0, 34, 'collectives')}; phases 32-34 "
          f"{ranks_s:.1f} s ({card})", flush=True)

    # ---- 37.-39. ranks on two nodes of the card: the staged route ---------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        nodes = _spawn_ranks(["37-39", digest6, digest36, tmp], timeout=600,
                             nodes=NODES)
        mixed = _spawn_ranks(["38", digest6, digest36, tmp], timeout=600,
                             world=2 * NODES, nodes=NODES)
    nodes_s = time.perf_counter() - t

    def pick_in(ranks_, rank, phase, key):
        return next(r[key] for r in ranks_[rank]
                    if r["phase"] == phase and key in r)

    staged_runs = [pick_in(nodes, r, 37, "run") for r in range(NODES)]
    idle37, busy37, traced37 = _idle_share(staged_runs)
    print(f"[37 fx64 2 ranks on 2 nodes] routes "
          f"{[pick_in(nodes, r, 37, 'routes') for r in range(NODES)]}; every "
          f"rank's dump sha256 phase 6's, and a per-rank checkpoint resumed "
          f"to it; launches a rank {[x['launches'] for x in staged_runs]}; "
          f"steady run() per chunk " + ", ".join(
              f"rank {r} {x['step_ms']:.3f} ms ({x['barriers']:.1f} "
              f"barriers, {x['barrier_ms']:.3f} ms host; staged "
              f"{x['staged_mb']:.1f} MB, {x['staged_ms']:.3f} ms host)"
              for r, x in enumerate(staged_runs))
          + f"; traced run: device busy (union over the ranks) "
          f"{busy37:.3f} ms of {traced37:.3f} ms, idle share "
          + (f"{idle37:.4f}" if idle37 is not None else "not measured (the "
             "traces' clocks do not line up)")
          + "; beside phase 32's IPC run " + ", ".join(
              f"{x['step_ms']:.3f}" for x in runs["fx"]) + f" ms ({card})",
          flush=True)
    mixed_runs = [pick_in(mixed, r, 38, "run") for r in range(2 * NODES)]
    print(f"[38 fx64 2 nodes x 2 ranks] routes "
          f"{[pick_in(mixed, r, 38, 'routes') for r in range(2 * NODES)]}; "
          f"every rank's dump sha256 phase 6's; launches a rank "
          f"{[x['launches'] for x in mixed_runs]}; steady run() per chunk "
          + ", ".join(f"{x['step_ms']:.3f}" for x in mixed_runs)
          + " ms; beam64 beams " + ", ".join(
              f"{'beam-parallel' if x['ep'] else 'replicated'} "
              f"{x['snr_beams']:.2f} dB" for r in range(2 * NODES)
              for x in mixed[r] if x["phase"] == 38 and "ep" in x)
          + f" from one card's, beams and incoherent beam bitwise the "
          f"one-process 4-shard mesh's ({card})", flush=True)
    k7b_st, k7a_st = pick_in(nodes, 0, 39, "k7b"), pick_in(nodes, 0, 39, "k7a")
    for r in range(NODES):
        for name, phase_ipc in (("k7b", 32), ("k7a", 33)):
            if (pick_in(nodes, r, 39, name)["digest"]
                    != pick(r, phase_ipc, name)["digest"]):
                raise RuntimeError(f"39: rank {r}'s {name} over the staged "
                                   "route != the IPC route's")
    bench_launches = [pick_in(nodes, r, 39, "bench_launches")
                      for r in range(NODES)]
    print(f"[39 staged kernels 2 nodes] K7b and K7a bitwise their plain "
          f"versions and the IPC route's (phases 32-33, sha256 of each "
          f"rank's outputs); K7b {k7b_st['ms']:.4f} ms (plain "
          f"{k7b_st['plain_ms']:.3f}, copy_ on the route "
          f"{k7b_st['library_ms']:.4f}; IPC {k7b['ms']:.4f}), the "
          f"receiver's placement of {k7b_st['place_mb']:.1f} MB from the "
          f"pinned slots {k7b_st['place_ms']:.4f} ms landed (in place "
          f"{k7b_st['place_in_place_ms']:.4f}, copy_ "
          f"{k7b_st['place_copy_ms']:.4f}); K7a {k7a_st['ms']:.4f} ms (plain "
          f"{k7a_st['plain_ms']:.3f}, copy_ {k7a_st['library_ms']:.4f}; IPC "
          f"{k7a['ms']:.4f}), placement {k7a_st['place_ms']:.4f} ms landed "
          f"(in place {k7a_st['place_in_place_ms']:.4f}, copy_ "
          f"{k7a_st['place_copy_ms']:.4f}); bench collectives ms "
          f"{pick_in(nodes, 0, 39, 'collectives')}, copy_ ms "
          f"{pick_in(nodes, 0, 39, 'copy_ms')}, launches {bench_launches}; "
          f"phases 37-39 {nodes_s:.1f} s ({card})", flush=True)
    if not all(b["all_to_all_staged"] and b["ring_staged"]
               for b in bench_launches):
        raise RuntimeError("39: the bench's kernels launched nothing on the "
                           "staged route")

    # ---- 40. ranks over several cards ------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[40 several cards] needs 2 or more cards, {n_cards} present: "
              f"layouts of one card a rank and of two cards a rank not run",
              flush=True)
    else:
        _phase_40_main(digest6, digest36, n_cards, mesh_step_ms, card)

    for banned in ("jax", "dc_sand_tpu"):
        if banned in sys.modules:
            raise RuntimeError(f"the port must not import {banned}")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms):
        return {"name": name, "route": "cuda",
                "source": f"dc_sand_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    kernels = [
        entry("fengine", "fengine.cu", "dc_sand_tpu/ops/fengine_fused.py:335",
              launches["fengine"], k1_err, k1_ms, k1_plain_ms,
              k1_bound, None),
        entry("fengine_wire", "fengine.cu",
              "dc_sand_tpu/ops/fengine_fused.py:335",
              beam_launches["fengine"], k1_err, k1_wire_ms, k1_plain_ms,
              k1_bound, None),
        entry("cmac", "cmac.cu", "dc_sand_tpu/ops/xcorr.py:371",
              launches["cmac"], cmac_err, cmac_ms, cmac_plain_ms, cmac_bound,
              None),
        entry("beamform", "beamform.cu", "dc_sand_tpu/ops/beamform.py:147",
              beam_launches["beamform"], beam_err, beam_ms, beam_plain_ms,
              beam_bound, beam_lib_ms),
        entry("pfb", "pfb.cu", "dc_sand_tpu/ops/pfb.py:92",
              unfused_launches["pfb"], pfb_err, pfb_ms, pfb_plain_ms,
              pfb_bound, pfb_lib_ms),
        entry("fengine_float", "fengine.cu",
              "dc_sand_tpu/ops/fengine_fused.py:335",
              fengine_launches[("pfb1k", True)]["fengine_float"], float_err,
              float_ms, float_plain_ms, float_bound, None),
        entry("ring", "remote_dma.cu", "dc_sand_tpu/parallel/remote_dma.py:51",
              sum(c["ring"] for c in mesh_launches.values()), 0,
              ring_ms, ring_plain_ms, ring_bound, ring_lib_ms),
        entry("all_to_all", "remote_dma.cu",
              "dc_sand_tpu/parallel/remote_dma.py:85",
              sum(c["all_to_all"] for c in mesh_launches.values()), 0,
              a2a_ms, a2a_plain_ms, a2a_bound, a2a_lib_ms),
        entry("all_to_all_ipc", "remote_dma.cu",
              "dc_sand_tpu/parallel/remote_dma.py:85",
              sum(x["launches"]["all_to_all"] for v in runs.values()
                  for x in v), 0, k7b["ms"], k7b["plain_ms"],
              (k7b["bound_ms"], k7b["bound_by"]), k7b["library_ms"]),
        entry("ring_ipc", "remote_dma.cu",
              "dc_sand_tpu/parallel/remote_dma.py:51",
              sum(x["launches"]["ring"] for x in runs["sp"]), 0, k7a["ms"],
              k7a["plain_ms"], (k7a["bound_ms"], k7a["bound_by"]),
              k7a["library_ms"]),
        # the staged route: fx64's corner-turn on the main path (37, 38:
        # the receivers' launches), the ring in the bench run (39)
        entry("all_to_all_staged", "remote_dma.cu",
              "dc_sand_tpu/parallel/remote_dma.py:85",
              sum(x["launches"]["all_to_all_staged"]
                  for x in staged_runs + mixed_runs), 0, k7b_st["ms"],
              k7b_st["plain_ms"], (k7b_st["bound_ms"], k7b_st["bound_by"]),
              k7b_st["library_ms"]),
        entry("ring_staged", "remote_dma.cu",
              "dc_sand_tpu/parallel/remote_dma.py:51",
              sum(b["ring_staged"] for b in bench_launches), 0,
              k7a_st["ms"], k7a_st["plain_ms"],
              (k7a_st["bound_ms"], k7a_st["bound_by"]),
              k7a_st["library_ms"]),
        entry("read_probe", "probes.cu", "scripts/sweep_s10_micro.py:26",
              probe_counts["read_probe"], 0, *probe_times["read_probe"]),
        entry("write_probe", "probes.cu", "scripts/sweep_s10_micro.py:49",
              probe_counts["write_probe"], 0, *probe_times["write_probe"]),
        # the port's own kernel: the JAX package gathers with a vmapped
        # dynamic_slice, outside any Pallas kernel
        entry("coarse_gather", "coarse.cu",
              "dc_sand_tpu/models/fengine.py:21", gather_launches, 0,
              *gather_times[("fx64", True)]),
        # the port's own kernel: the JAX package evaluates the delay
        # polynomials in numpy on the host, outside any kernel
        entry("delay_terms", "delays.cu",
              "dc_sand_tpu/runtime/delays.py:82",
              launches["delay_terms"] + beam_launches["delay_terms"], 0,
              *delay_times),
        # K1 at M = 65536: the cluster kernel alone (the wire layout) and
        # the operand layout's call, the kernel and its transpose
        entry("fengine_wide", "fengine.cu",
              "dc_sand_tpu/ops/fengine_fused.py:335",
              wide["launches"]["fengine_wide"], wide["err"], wide["wire_ms"],
              wide["plain_ms"], wide["bound"], None),
        entry("fengine_wide_operand", "fengine.cu",
              "dc_sand_tpu/ops/fengine_fused.py:335",
              wide["launches"]["fengine_wide_operand"], 0,
              wide["operand_ms"], wide["plain_ms"], wide["bound"], None),
    ]
    print(f"[total] phases 1-42 in {time.perf_counter() - t_start:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_main(sys.argv[2:]))
    if sys.argv[1:] == ["--phase", "40"]:
        sys.exit(_phase_40_alone())
    if sys.argv[1:] == ["--phase", "41"]:
        sys.exit(_phase_41_alone())
    sys.exit(main())
