"""The streaming step: F-engine alone, or -> X-engine integration, or ->
B-engine, on one device or on a device mesh.

PyTorch counterpart of :func:`dc_sand_tpu.models.pipeline.make_step` in
fengine, fx and beam mode.  By default the step takes its streaming I/O in
FRAME form (the JAX package's frames-I/O fast path): history ``(A*P,
taps_pad, M)`` and chunk ``(A*P, B, M)`` int8, coarse delay applied on the
host feed.

    step(history, acc, chunk, frac, phase, gains, weights, reset) -> dict

(the JAX step's argument order without ``coarse``) updates ``history``
and ``acc`` IN PLACE, which takes the place of the JAX step's donated
carry, and returns the chunk's outputs.

With ``coarse_on_host=False`` (and ``cfg.apply_delay``) the coarse delay
runs in the step, as in the JAX package's device coarse mode: the step
takes the JAX argument order

    step(history, acc, chunk, coarse, frac, phase, gains, weights, reset)

with the raw chunk (``(A, P, C)``, or the same bytes as frames),
``coarse`` ``A*P`` int32 delays on the device, and ``history`` the raw
lead-in ``(A, P, max_delay + (taps-1)*M)`` (:func:`history_len`).  One
gather (:func:`~dc_sand_tpu_torch.ops.coarse.coarse_gather`, one launch a
device) writes the delayed stream of ``[history | chunk]`` into frame-form
buffers that the F-engine reads as its split I/O, then ``history`` becomes
the last ``history_len`` samples of ``[history | chunk]`` (a second launch,
in stream order after the gather's reads).  The FIR overlap is gathered
again with the current chunk's delay, so the two modes agree bitwise while
the coarse delay holds and differ where it steps at a chunk boundary, as
the JAX package's two modes do.

Per chunk the F-engine (the fused
kernel K1, or with ``fused=False`` the standalone FIR kernel K6 and
PyTorch ops, the JAX package's ``impl="pallas"`` path) writes in fengine
and beam mode wire spectra ``(A*P, B, K, 2)``, int8, or float32 when the
config does not requantise (the float kernel K1-float), and in fx mode the
X-engine's operand layout ``(K, 2, A*P, Bp)`` int8, its rows padded with
zero spectra to the CMAC's ``Bp`` (:func:`~dc_sand_tpu_torch.ops.xcorr.
cmac_pitch`, B rounded up to 16), so that any B runs.  Then

* fengine mode: returns ``{"spectra": (A, P, B, K, 2)}`` (a free view),
  ``acc`` is a rank-1 dummy, as in the JAX package;
* fx mode: the packed CMAC (K2/K3) into ``acc`` straight from the
  F-engine's operand, viewed ``(K, 2*A*P, Bp)`` (on one device the
  corner-turn's all-to-all is an identity, and the fused path has no
  glue between the two kernels; the unfused one permutes its wire
  spectra); returns ``{}``;
* beam mode: the beam kernel (K4/K4p/K5) reads the wire spectra, viewed
  for free as ``(A, P, B, K, 2)``, and returns ``{"beams": (nb, P, B, K,
  2)}`` (float32, or int8 when ``cfg.beam_quant_scale > 0``), with
  ``cfg.incoherent_beam`` ``"incoherent": (P, B, K)`` float32 and with
  ``cfg.beam_stokes`` ``"stokes": (nb, 4, B, K)`` from the float beams.
  Without requantisation the float spectra go through the float beam
  product (:func:`~dc_sand_tpu_torch.ops.beamform.beamform_torch`, four
  real float32 contractions), which the JAX package too runs outside any
  Pallas kernel.
  ``acc`` is a rank-1 dummy, as in the JAX package.

With ``mesh`` (:mod:`dc_sand_tpu_torch.parallel`) the step runs SPMD over
its shards, each argument but ``reset`` a list in shard order (the
carries, the chunk, delays, gains and weights cut to the shard by
:func:`shard_inputs`: antennas ``f*A/n_fx ...`` of fx shard f and, in SP
mode, spectra ``t*B/n_t ...`` of time shard t), and each output a list of
per-shard tensors (:func:`gather_outputs` and :func:`gather_acc` put them
back in the global layout).  A mesh of one shard runs the one-device step
behind that signature.  On more shards:

* the F-engine runs on each shard's antennas and spectra;
* fx: the corner-turn over fx (the all-to-all kernel K7b in its pitched
  mode, :func:`~dc_sand_tpu_torch.parallel.corner_turn_all_to_all`, one
  launch a card, landing each shard's operand-layout blocks in the
  receivers' operands) and the CMAC into the shard's ``(K/n_fx, ap, ap)``
  channel block;
* fengine: the spectra stay antenna-sharded;
* beam: partial beams and incoherent beam per shard, summed over fx
  (``psum``), or with ``cfg.beam_parallel`` reduce-scattered over the beam
  axis (``psum_scatter``, each fx shard its ``nb/n_fx`` beams).  The beam
  kernel's int8 epilogue is off: beams are quantised after the sum.

On a mesh over several processes (:func:`~dc_sand_tpu_torch.parallel.
build_global_mesh`) every list holds this rank's shards only
(:attr:`~dc_sand_tpu_torch.parallel.Mesh.local_shards`), as a JAX process
sees only its addressable shards, and the chunk it cuts holds this rank's
antennas only.  On the card the step allocates, once, the buffers that
other ranks write into or read (:class:`~dc_sand_tpu_torch.parallel.ipc.
SharedBuffers`): the receivers' CMAC operands for K7b, the halos for K7a,
the partial and incoherent beams for the sums.  Ranks of one node reach
them through CUDA IPC; ranks of other nodes through the staged route
(pinned host slots and gloo; the receiver's K7b or K7a places a remote
sender's block, the sums read mirrors).  On the CPU a mesh whose peers
are all on other nodes takes the staged route's bookkeeping too
(:func:`~dc_sand_tpu_torch.parallel.uses_shared_buffers`).

SP mode (``cfg.time_shards > 1``, the counterpart of ``_make_sp_step``) cuts
each chunk into time shards: every shard sends its last ``taps_pad`` frames
one step right around the time ring (K7a,
:func:`~dc_sand_tpu_torch.parallel.ring_tails`), time shard 0 reads the carried
history and every other shard what the ring brought it, and the new carry
of shard 0 is what it received from the last shard.  In fx mode each time
shard integrates its own partial accumulator; the runner sums them at the
dump.
"""

from __future__ import annotations

import torch

from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.models.fengine import f_engine
from dc_sand_tpu_torch.ops._dispatch import default_device
from dc_sand_tpu_torch.ops.beamform import beamform, quantize_beams
from dc_sand_tpu_torch.ops.coarse import carry_lead, coarse_gather
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.stokes import stokes
from dc_sand_tpu_torch.ops.xcorr import (acc_shape, cmac_pitch,
                                         xcorr_accumulate_a2)
from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS, SharedBuffers,
                                        all_shards, corner_turn_all_to_all,
                                        psum, psum_scatter, ring_tails,
                                        uses_shared_buffers)

__all__ = ["make_step", "mode_for", "check_mode", "zero_vis_acc",
           "history_len", "uses_frames_io", "history_shape", "chunk_shape",
           "shard_inputs", "gather_acc", "gather_outputs"]


def mode_for(cfg: ChainConfig) -> str:
    if cfg.n_beams > 0:
        return "beam"
    if cfg.run_xengine:
        return "fx"
    return "fengine"


def _split(mesh) -> tuple:
    """``(n_time, n_fx)`` of ``mesh``, ``(1, 1)`` without one."""
    if mesh is None:
        return 1, 1
    return mesh.shape[TIME_AXIS], mesh.shape[FX_AXIS]


def history_len(cfg: ChainConfig, max_delay: int) -> int:
    """Samples of the device coarse mode's carried raw stream: the coarse
    lead-in and the FIR overlap.  SP mode (``cfg.time_shards > 1``) keeps
    coarse delay on the host/ingest path, as the JAX package's does."""
    if cfg.time_shards > 1 and max_delay:
        raise ValueError("SP mode needs coarse delay on the host/ingest "
                         "path (max_delay must be 0)")
    return max_delay + (cfg.n_taps - 1) * cfg.fft_size


def uses_frames_io(cfg: ChainConfig, coarse_on_host: bool = True) -> bool:
    """True when :func:`make_step` takes its history and chunk in frame
    form; False exactly when a lead-in rides the device (the device coarse
    mode, ``coarse_on_host=False`` with ``cfg.apply_delay``, outside SP)."""
    return cfg.time_shards > 1 or coarse_on_host or not cfg.apply_delay


def history_shape(cfg: ChainConfig, mesh=None, max_delay=None) -> tuple:
    """Carried history per shard: in frame form ``(A*P/n_fx, taps_pad,
    M)``, or with ``max_delay`` (the device coarse mode's, 0 included)
    the lead-in ``(A/n_fx, P, history_len)``."""
    _, n_f = _split(mesh)
    if max_delay is not None:
        return (cfg.n_ants // n_f, cfg.n_pols, history_len(cfg, max_delay))
    return (cfg.n_ants // n_f * cfg.n_pols, taps_pad_for(cfg.n_taps),
            cfg.fft_size)


def chunk_shape(cfg: ChainConfig) -> tuple:
    """A chunk in frame form: ``(A*P, B, M)`` — the same bytes as the
    ``(A, P, chunk_samples)`` sample stream, row-major."""
    return (cfg.n_ants * cfg.n_pols, cfg.spectra_per_chunk, cfg.fft_size)


def zero_vis_acc(cfg: ChainConfig, device, mesh=None) -> torch.Tensor:
    """Zeroed integration carry of one shard: the packed ``(K/n_fx, ap,
    ap)`` int32 channel block in fx mode, a rank-1 dummy in the other
    modes (as the JAX package's)."""
    _, n_f = _split(mesh)
    shape = (acc_shape(cfg.n_ants, cfg.n_pols, cfg.n_chans // n_f)
             if mode_for(cfg) == "fx" else (1,))
    return torch.zeros(shape, dtype=torch.int32, device=device)


def check_mode(cfg: ChainConfig, mesh=None, max_delay: int = 0,
               coarse_on_host: bool = True) -> None:
    """Raise for configurations the step refuses: the JAX step's
    validation errors, and modes this port does not run."""
    mode = mode_for(cfg)
    if max_delay and not (cfg.apply_delay and not coarse_on_host):
        # a lead-in only feeds the device gather: with coarse on the host
        # the step would drop it and ignore the delays
        raise ValueError(
            "max_delay > 0 requires the device coarse path "
            "(coarse_on_host=False with cfg.apply_delay); host/ingest "
            "coarse modes take max_delay=0")
    if cfg.time_shards > 1 and max_delay:
        raise ValueError(
            "time-sharded (SP) mode requires coarse delay on the "
            "host/ingest path (max_delay must be 0)")
    if cfg.beam_stokes and (mode != "beam" or cfg.n_pols != 2):
        raise ValueError("beam_stokes needs dual-pol beams "
                         f"(mode={mode}, n_pols={cfg.n_pols})")
    n_t, n_f = _split(mesh)
    if cfg.beam_parallel:
        if mesh is None:
            raise ValueError(
                "beam_parallel requires a mesh (pass mesh=; without one "
                "the step would silently run replicated)")
        if mode != "beam":
            raise ValueError("beam_parallel needs beam mode "
                             f"(n_beams > 0, got mode={mode})")
        if cfg.n_beams % n_f:
            raise ValueError(
                f"beam_parallel needs n_beams ({cfg.n_beams}) divisible "
                f"by the fx-axis size ({n_f})")
    if not cfg.apply_requant and mode == "fx":
        raise NotImplementedError(f"{mode} mode without requantisation is "
                                  "not ported")
    if cfg.time_shards > 1 and n_t != cfg.time_shards:
        raise ValueError(
            f"SP mode needs a mesh with a {cfg.time_shards}-way "
            f"'{TIME_AXIS}' axis (build_mesh(time_shards=...))")
    if mesh is None:
        return
    if n_t != cfg.time_shards:
        raise ValueError(f"a mesh with a {n_t}-way '{TIME_AXIS}' axis needs "
                         f"cfg.time_shards == {n_t}, got {cfg.time_shards}")
    if cfg.n_ants % n_f:
        raise ValueError(f"n_ants ({cfg.n_ants}) must divide over the fx "
                         f"axis ({n_f})")
    if mode == "fx" and cfg.n_chans % n_f:
        raise ValueError(f"n_chans ({cfg.n_chans}) must divide over the fx "
                         f"axis ({n_f}) for the corner-turn")
    b, tp = cfg.spectra_per_chunk, taps_pad_for(cfg.n_taps)
    if n_t > 1 and (b % n_t or b // n_t < tp):
        raise ValueError(
            f"chunk of {b} spectra cannot shard {n_t} ways with an "
            f"overlap-save halo of {tp} frames")


def _window(window, cfg: ChainConfig, device) -> torch.Tensor:
    return torch.as_tensor(window, dtype=torch.float32, device=device).reshape(
        cfg.n_taps, cfg.fft_size).contiguous()


def _fengine(cfg: ChainConfig, w, chunk, history, frac, phase, gains,
             fused: bool) -> torch.Tensor:
    """Wire spectra ``(S, B, K, 2)``, or in fx mode the operand layout
    ``(K, 2, S, Bp)``, zeros past B."""
    s_l, b_l = chunk.shape[0], chunk.shape[1]
    fx = mode_for(cfg) == "fx"
    return f_engine(chunk, w, cfg.n_taps, cfg.n_chans, history=history,
                    frac_delay=frac.reshape(s_l, b_l)
                    if cfg.apply_delay else None,
                    phase=phase.reshape(s_l, b_l)
                    if cfg.apply_delay else None,
                    gains=gains if cfg.apply_requant else None,
                    layout="operand" if fx else "wire",
                    pitch=cmac_pitch(b_l) if fx else None, fused=fused)


def _carry(history, chunk) -> None:
    """The next chunk's history: the stream's last taps_pad frames."""
    tp, b_l = history.shape[1], chunk.shape[1]
    if b_l >= tp:
        history.copy_(chunk[:, b_l - tp:])
    else:
        history.copy_(torch.cat([history, chunk], dim=1)[:, -tp:])


def shard_inputs(mesh, *xs, time: bool = True) -> tuple:
    """Cut frame-form tensors ``(A*P, B, ...)`` (or per-row ``(A*P,)``) to
    this process's shards of ``mesh``: fx shard f takes rows
    ``f*A*P/n_fx ...`` and, with ``time``, time shard t spectra
    ``t*B/n_t ...``, each moved to its
    shard's device (a rank of several cards copies each card's rows from
    the card the tensors lie on).  On a mesh over several processes the tensors hold
    this rank's rows only, those of its fx columns.  Returns one list per
    tensor in the order of :attr:`Mesh.local_shards` (a list of None for
    None); a slice that is the whole tensor on its own device is not
    copied."""
    n_t, _ = _split(mesh)
    _, fs = mesh.local_block()
    out = tuple([] for _ in xs)
    for d, dev in zip(mesh.local_shards, mesh.local_devices):
        t, f = mesh.coords(d)
        f -= fs[0]
        for o, x in zip(out, xs):
            if x is None:
                o.append(None)
                continue
            s_l = x.shape[0] // len(fs)
            rows = x[f * s_l:(f + 1) * s_l]
            if time and x.dim() > 1:
                b_l = x.shape[1] // n_t
                rows = rows[:, t * b_l:(t + 1) * b_l]
            o.append(rows.contiguous().to(dev))
    return out


def gather_acc(accs, mesh, device, buffers=None) -> torch.Tensor:
    """The packed ``(K, ap, ap)`` accumulator on ``device`` from the
    shards' carries: the channel blocks in order, each the sum of its time
    shards' partials (exact int32 adds).  On a mesh over several
    processes every rank gets the whole plane, as the JAX runner's dump
    all-gather gives it: with ``buffers``
    (:class:`~dc_sand_tpu_torch.parallel.ipc.SharedBuffers`) ``accs`` are
    this rank's buffers, its node's peers' are read through their IPC
    mappings and other nodes' from mirrors filled over the staged route,
    after which the ranks agree that the reads are done before any
    accumulator is written again; without, on the CPU, they come over
    gloo."""
    n_t, n_f = _split(mesh)
    every = all_shards(accs, mesh, buffers)
    blocks = []
    for f in range(n_f):
        acc = every[f].to(device)
        for t in range(1, n_t):
            acc = acc + every[t * n_f + f].to(device)
        blocks.append(acc)
    total = _cat(blocks, 0)
    if mesh.multiprocess and buffers is not None:
        buffers.ready()
    return total


def gather_outputs(outputs: dict, cfg: ChainConfig, mesh, device) -> dict:
    """Per-shard outputs -> global layout on ``device``: antenna shards
    (spectra) and beam-parallel beam shards joined in order, time shards
    joined along the spectra axis; replicated outputs taken from each time
    row's first shard.  On a mesh over several processes, this rank's
    block of them: its antennas' spectra, its share of beam-parallel
    beams, its time rows (as a JAX process hands over the addressable
    shards of an array it cannot gather)."""
    n_f = _split(mesh)[1]
    ts, fs = mesh.local_block()
    loc = {d: k for k, d in enumerate(mesh.local_shards)}
    sharded = {"spectra": True, "beams": bool(cfg.beam_parallel),
               "stokes": bool(cfg.beam_parallel), "incoherent": False}
    out = {}
    for key, xs in outputs.items():
        rows = []
        for t in ts:
            row = [xs[loc[t * n_f + f]]
                   for f in (fs if sharded[key] else fs[:1])]
            rows.append(_cat([x.to(device) for x in row], 0))
        out[key] = _cat(rows, 1 if key == "incoherent" else 2)
    return out


def _cat(parts, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def make_step(cfg: ChainConfig, window, *, device=None, mesh=None,
              fused: bool = True, max_delay: int = 0,
              coarse_on_host: bool = True):
    """Build the streaming step for ``cfg`` on ``device`` (None: the
    current CUDA device; it raises without a card), or over ``mesh`` (see
    the module docstring): it launches the CUDA kernels on CUDA devices
    and runs their plain versions on the CPU.  ``fused`` picks the
    F-engine path (:func:`dc_sand_tpu_torch.models.fengine.f_engine`).
    ``coarse_on_host=False`` with ``cfg.apply_delay`` runs the coarse
    delay in the step from a lead-in of ``max_delay`` samples; as in the
    JAX package, ``max_delay > 0`` without that mode raises, and so does
    SP mode with ``max_delay > 0``."""
    check_mode(cfg, mesh, max_delay, coarse_on_host)
    md = None if uses_frames_io(cfg, coarse_on_host) else max_delay
    if mesh is None:
        return _make_one_step(cfg, window, default_device(device), fused, md)
    if mesh.size == 1:
        return _listed(_make_one_step(cfg, window, mesh.flat_devices[0],
                                      fused, md))
    return _make_sharded_step(cfg, window, mesh, fused, md)


def _listed(step):
    """The one-device ``step`` with the mesh step's signature: every
    argument but ``reset``, and every output, a one-element list."""
    def listed(*args) -> dict:
        out = step(*(a[0] for a in args[:-1]), args[-1])
        return {k: [v] for k, v in out.items()}
    return listed


class _LeadFrames:
    """The device coarse mode's gather: the delayed stream of ``[history
    | chunk]`` into frame-form buffers (a history ``(S, taps_pad, M)``
    whose first ``taps_pad - taps + 1`` frames stay zero, and the chunk's
    frames ``(S, B, M)``), allocated once a device and shape and reused,
    so that a CUDA graph's replays find them; then the next lead-in."""

    def __init__(self, cfg: ChainConfig, max_delay: int):
        self.cfg, self.max_delay = cfg, max_delay
        self._bufs = {}

    def __call__(self, history, chunk, coarse) -> tuple:
        m = self.cfg.fft_size
        s = history.shape[0] * history.shape[1]
        key = (s, chunk.numel() // (s * m))
        have = self._bufs.get(history.device)
        if have is None or have[0] != key:
            self._bufs[history.device] = have = (key, torch.zeros(
                (s, taps_pad_for(self.cfg.n_taps), m), dtype=torch.int8,
                device=history.device), torch.empty(
                (s, key[1], m), dtype=torch.int8, device=history.device))
        _, hist_f, chunk_f = have
        rows = chunk.reshape(s, -1)
        coarse_gather(history, rows, coarse, self.max_delay, out=chunk_f,
                      hist=hist_f)
        carry_lead(history, rows)
        return hist_f, chunk_f


def _make_one_step(cfg: ChainConfig, window, device: torch.device,
                   fused: bool, max_delay=None):
    """The one-device step; ``max_delay`` not None: the device coarse
    mode's (module docstring)."""
    mode = mode_for(cfg)
    w = _window(window, cfg, device)
    # the beam kernel quantises in its epilogue unless the float beams
    # feed Stokes first
    kq = cfg.beam_quant_scale if not cfg.beam_stokes else 0.0

    def outputs(q, acc, b_l, weights, reset) -> dict:
        if mode == "fengine":
            return {"spectra": q.reshape(cfg.n_ants, cfg.n_pols, b_l,
                                         cfg.n_chans, 2)}
        if mode == "fx":
            xcorr_accumulate_a2(acc, q.reshape(cfg.n_chans, -1,
                                               q.shape[-1]),
                                keep=0 if reset else 1)
            return {}
        beams, inc = beamform(
            q.reshape(cfg.n_ants, cfg.n_pols, b_l, cfg.n_chans, 2), weights,
            quant_scale=kq, incoherent=cfg.incoherent_beam)
        out = {}
        if cfg.beam_stokes:
            out["stokes"] = stokes(beams)
            if cfg.beam_quant_scale:
                beams = quantize_beams(beams, cfg.beam_quant_scale)
        out["beams"] = beams
        if inc is not None:
            out["incoherent"] = inc
        return out

    if max_delay is not None:
        lead = _LeadFrames(cfg, max_delay)

        def step(history, acc, chunk, coarse, frac, phase, gains, weights,
                 reset) -> dict:
            hist_f, chunk_f = lead(history, chunk, coarse)
            q = _fengine(cfg, w, chunk_f, hist_f, frac, phase, gains, fused)
            return outputs(q, acc, chunk_f.shape[1], weights, reset)

        return step

    def step(history, acc, chunk, frac, phase, gains, weights,
             reset) -> dict:
        q = _fengine(cfg, w, chunk, history, frac, phase, gains, fused)
        _carry(history, chunk)
        return outputs(q, acc, chunk.shape[1], weights, reset)

    return step


def _each(fn, xs) -> list:
    """``fn`` of every distinct tensor of ``xs`` (after ``psum``, the
    shards on one device share one tensor)."""
    done = {}
    for x in xs:
        if id(x) not in done:
            done[id(x)] = fn(x)
    return [done[id(x)] for x in xs]


def _shared_buffers(cfg: ChainConfig, mesh) -> dict:
    """The buffers other ranks write into or read, by role, on a mesh
    whose collectives take them (:func:`~dc_sand_tpu_torch.parallel.
    uses_shared_buffers`; none otherwise); every rank allocates and
    registers them in one order."""
    if not uses_shared_buffers(mesh):
        return {}
    mode = mode_for(cfg)
    n_t, n_f = _split(mesh)
    s_l, p, k = cfg.n_ants // n_f * cfg.n_pols, cfg.n_pols, cfg.n_chans
    b_l, m = cfg.spectra_per_chunk // n_t, cfg.fft_size
    bufs = {}
    if n_t > 1:
        bufs["halo"] = SharedBuffers(mesh, (s_l, taps_pad_for(cfg.n_taps), m),
                                     torch.int8)
    if mode == "fx":
        bufs["operand"] = SharedBuffers(mesh, (k, 2, s_l, cmac_pitch(b_l)),
                                        torch.int8)
    if mode == "beam":
        bufs["beams"] = SharedBuffers(mesh, (cfg.n_beams, p, b_l, k, 2),
                                      torch.float32)
        if cfg.incoherent_beam:
            bufs["incoherent"] = SharedBuffers(mesh, (p, b_l, k),
                                               torch.float32)
    return bufs


def _make_sharded_step(cfg: ChainConfig, window, mesh, fused: bool,
                       max_delay=None):
    mode = mode_for(cfg)
    n_t, n_f = _split(mesh)
    a_l, p, k = cfg.n_ants // n_f, cfg.n_pols, cfg.n_chans
    devices = mesh.local_devices
    heads = [mesh.coords(d)[0] == 0 for d in mesh.local_shards]
    windows = {dev: _window(window, cfg, dev) for dev in set(devices)}
    bufs = _shared_buffers(cfg, mesh)

    lead = _LeadFrames(cfg, max_delay) if max_delay is not None else None

    def fengine(histories, chunks, fracs, phases, gains) -> tuple:
        """Each shard's F-engine output and spectra count; the carries
        advanced."""
        b_l = chunks[0].shape[1]
        hist = histories
        if n_t > 1:
            halos = ring_tails(chunks, histories[0].shape[1], mesh,
                               TIME_AXIS, dim=1, out=bufs.get("halo"))
            hist = [h if head else halo
                    for h, halo, head in zip(histories, halos, heads)]
        qs = [_fengine(cfg, windows[dev], c, h, fd, ph, g, fused)
              for dev, c, h, fd, ph, g in zip(devices, chunks, hist, fracs,
                                              phases, gains)]
        for d, (h, c) in enumerate(zip(histories, chunks)):
            if n_t == 1:
                _carry(h, c)
            elif heads[d]:
                h.copy_(halos[d])
        return qs, b_l

    def fengine_lead(histories, chunks, coarses, fracs, phases,
                     gains) -> tuple:
        """The device coarse mode: each shard gathers its own antennas on
        its own device, then runs its F-engine."""
        qs = []
        for dev, h, c, co, fd, ph, g in zip(devices, histories, chunks,
                                            coarses, fracs, phases, gains):
            hist_f, chunk_f = lead(h, c, co)
            qs.append(_fengine(cfg, windows[dev], chunk_f, hist_f, fd, ph,
                               g, fused))
        return qs, chunk_f.shape[1]

    def step(histories, accs, chunks, *rest) -> dict:
        *args, weights, reset = rest
        qs, b_l = (fengine_lead if lead is not None else fengine)(
            histories, chunks, *args)
        if mode == "fengine":
            return {"spectra": [q.reshape(a_l, p, b_l, k, 2) for q in qs]}
        if mode == "fx":
            a2 = corner_turn_all_to_all(qs, mesh, out=bufs.get("operand"))
            for acc, x in zip(accs, a2):
                xcorr_accumulate_a2(acc, x, keep=0 if reset else 1)
            return {}
        parts = [beamform(q.reshape(a_l, p, b_l, k, 2), w,
                          incoherent=cfg.incoherent_beam)
                 for q, w in zip(qs, weights)]
        coh = [c for c, _ in parts]
        coh = (psum_scatter if cfg.beam_parallel else psum)(
            coh, mesh, FX_AXIS, buffers=bufs.get("beams"))
        out = {}
        if cfg.beam_stokes:
            out["stokes"] = _each(stokes, coh)
        if cfg.beam_quant_scale:
            coh = _each(lambda y: quantize_beams(y, cfg.beam_quant_scale),
                        coh)
        out["beams"] = coh
        if cfg.incoherent_beam:
            out["incoherent"] = psum([i for _, i in parts], mesh, FX_AXIS,
                                     buffers=bufs.get("incoherent"))
        return out

    return step
