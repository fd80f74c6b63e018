"""The streaming step: F-engine alone, or -> X-engine integration, or ->
B-engine, on one device or on a device mesh.

PyTorch counterpart of :func:`dc_sand_tpu.models.pipeline.make_step` in
fengine, fx and beam mode.  The step takes its streaming I/O in FRAME form
(the JAX package's frames-I/O fast path): history ``(A*P, taps_pad, M)``
and chunk ``(A*P, B, M)`` int8, coarse delay applied on the host feed.

    step(history, acc, chunk, frac, phase, gains, weights, reset) -> dict

(the JAX step's argument order without ``coarse``) updates ``history``
and ``acc`` IN PLACE, which takes the place of the JAX step's donated
carry, and returns the chunk's outputs.  Per chunk the F-engine writes
wire spectra ``(A*P, B, K, 2)``, int8, or float32 when the config does
not requantise (fengine mode only): the fused kernel K1, or with
``fused=False`` the standalone FIR kernel K6 and PyTorch ops (the JAX
package's ``impl="pallas"`` path).  Then

* fengine mode: returns ``{"spectra": (A, P, B, K, 2)}`` (a free view),
  ``acc`` is a rank-1 dummy, as in the JAX package;
* fx mode: the corner-turn as PyTorch glue (one ``permute().contiguous()``,
  :func:`dc_sand_tpu_torch.ops.xcorr.wire_to_a2`; on one device the
  corner-turn's all-to-all is an identity) and the packed CMAC (K2/K3)
  into ``acc``; returns ``{}``;
* beam mode: the beam kernel (K4/K4p/K5) reads the wire spectra, viewed
  for free as ``(A, P, B, K, 2)``, and returns ``{"beams": (nb, P, B, K,
  2)}`` (float32, or int8 when ``cfg.beam_quant_scale > 0``), with
  ``cfg.incoherent_beam`` ``"incoherent": (P, B, K)`` float32 and with
  ``cfg.beam_stokes`` ``"stokes": (nb, 4, B, K)`` from the float beams.
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
* fx: the corner-turn over fx (the all-to-all kernel K7b,
  :func:`~dc_sand_tpu_torch.parallel.corner_turn_all_to_all`) and the
  CMAC into the shard's ``(K/n_fx, ap, ap)`` channel block;
* fengine: the spectra stay antenna-sharded;
* beam: partial beams and incoherent beam per shard, summed over fx
  (``psum``), or with ``cfg.beam_parallel`` reduce-scattered over the beam
  axis (``psum_scatter``, each fx shard its ``nb/n_fx`` beams).  The beam
  kernel's int8 epilogue is off: beams are quantised after the sum.

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
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.stokes import stokes
from dc_sand_tpu_torch.ops.xcorr import (acc_shape, wire_to_a2,
                                         xcorr_accumulate_a2)
from dc_sand_tpu_torch.parallel import (FX_AXIS, TIME_AXIS,
                                        corner_turn_all_to_all, psum,
                                        psum_scatter, ring_tails)

__all__ = ["make_step", "mode_for", "check_mode", "zero_vis_acc",
           "history_shape", "chunk_shape", "shard_inputs", "gather_acc",
           "gather_outputs"]


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


def history_shape(cfg: ChainConfig, mesh=None) -> tuple:
    """Carried FIR history in frame form, per shard: ``(A*P/n_fx,
    taps_pad, M)``."""
    _, n_f = _split(mesh)
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


def check_mode(cfg: ChainConfig, mesh=None) -> None:
    """Raise for configurations the step refuses: the JAX step's
    validation errors, and modes this port does not run."""
    mode = mode_for(cfg)
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
    if not cfg.apply_requant and mode != "fengine":
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
    s_l, b_l = chunk.shape[0], chunk.shape[1]
    return f_engine(chunk, w, cfg.n_taps, cfg.n_chans, history=history,
                    frac_delay=frac.reshape(s_l, b_l)
                    if cfg.apply_delay else None,
                    phase=phase.reshape(s_l, b_l)
                    if cfg.apply_delay else None,
                    gains=gains if cfg.apply_requant else None,
                    fused=fused)                           # (S, B, K, 2)


def _carry(history, chunk) -> None:
    """The next chunk's history: the stream's last taps_pad frames."""
    tp, b_l = history.shape[1], chunk.shape[1]
    if b_l >= tp:
        history.copy_(chunk[:, b_l - tp:])
    else:
        history.copy_(torch.cat([history, chunk], dim=1)[:, -tp:])


def shard_inputs(mesh, *xs, time: bool = True) -> tuple:
    """Cut frame-form tensors ``(A*P, B, ...)`` to the shards of ``mesh``:
    fx shard f takes rows ``f*A*P/n_fx ...`` and, with ``time``, time
    shard t spectra ``t*B/n_t ...``, each moved to its shard's device.
    Returns one list per tensor in shard order (a list of None for None);
    a slice that is the whole tensor on its own device is not copied."""
    n_t, n_f = _split(mesh)
    out = tuple([] for _ in xs)
    for d, dev in enumerate(mesh.flat_devices):
        t, f = mesh.coords(d)
        for o, x in zip(out, xs):
            if x is None:
                o.append(None)
                continue
            s_l = x.shape[0] // n_f
            b_l = x.shape[1] // n_t if time else x.shape[1]
            t_b = t if time else 0
            o.append(x[f * s_l:(f + 1) * s_l, t_b * b_l:(t_b + 1) * b_l]
                     .contiguous().to(dev))
    return out


def gather_acc(accs, mesh, device) -> torch.Tensor:
    """The packed ``(K, ap, ap)`` accumulator on ``device`` from the
    shards' carries: the channel blocks in order, each the sum of its time
    shards' partials (exact int32 adds)."""
    n_t, n_f = _split(mesh)
    blocks = []
    for f in range(n_f):
        acc = accs[f].to(device)
        for t in range(1, n_t):
            acc = acc + accs[t * n_f + f].to(device)
        blocks.append(acc)
    return _cat(blocks, 0)


def gather_outputs(outputs: dict, cfg: ChainConfig, mesh, device) -> dict:
    """Per-shard outputs -> global layout on ``device``: antenna shards
    (spectra) and beam-parallel beam shards joined in order, time shards
    joined along the spectra axis; replicated outputs taken from each time
    row's first shard."""
    n_t, n_f = _split(mesh)
    sharded = {"spectra": True, "beams": bool(cfg.beam_parallel),
               "stokes": bool(cfg.beam_parallel), "incoherent": False}
    out = {}
    for key, xs in outputs.items():
        rows = []
        for t in range(n_t):
            row = xs[t * n_f:(t + 1) * n_f if sharded[key] else t * n_f + 1]
            rows.append(_cat([x.to(device) for x in row], 0))
        out[key] = _cat(rows, 1 if key == "incoherent" else 2)
    return out


def _cat(parts, dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def make_step(cfg: ChainConfig, window, *, device=None, mesh=None,
              fused: bool = True):
    """Build the streaming step for ``cfg`` on ``device`` (None: the
    current CUDA device; it raises without a card), or over ``mesh`` (see
    the module docstring): it launches the CUDA kernels on CUDA devices
    and runs their plain versions on the CPU.  ``fused`` picks the
    F-engine path (:func:`dc_sand_tpu_torch.models.fengine.f_engine`)."""
    check_mode(cfg, mesh)
    if mesh is None:
        return _make_one_step(cfg, window, default_device(device), fused)
    if mesh.size == 1:
        return _listed(_make_one_step(cfg, window, mesh.flat_devices[0],
                                      fused))
    return _make_sharded_step(cfg, window, mesh, fused)


def _listed(step):
    """The one-device ``step`` with the mesh step's signature: every
    argument but ``reset``, and every output, a one-element list."""
    def listed(histories, accs, chunks, fracs, phases, gains, weights,
               reset) -> dict:
        out = step(histories[0], accs[0], chunks[0], fracs[0], phases[0],
                   gains[0], weights[0], reset)
        return {k: [v] for k, v in out.items()}
    return listed


def _make_one_step(cfg: ChainConfig, window, device: torch.device,
                   fused: bool):
    mode = mode_for(cfg)
    w = _window(window, cfg, device)
    # the beam kernel quantises in its epilogue unless the float beams
    # feed Stokes first
    kq = cfg.beam_quant_scale if not cfg.beam_stokes else 0.0

    def step(history, acc, chunk, frac, phase, gains, weights,
             reset) -> dict:
        q = _fengine(cfg, w, chunk, history, frac, phase, gains, fused)
        _carry(history, chunk)
        b_l = chunk.shape[1]
        if mode == "fengine":
            return {"spectra": q.reshape(cfg.n_ants, cfg.n_pols, b_l,
                                         cfg.n_chans, 2)}
        if mode == "fx":
            xcorr_accumulate_a2(acc, wire_to_a2(q), keep=0 if reset else 1)
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

    return step


def _each(fn, xs) -> list:
    """``fn`` of every distinct tensor of ``xs`` (after ``psum``, the
    shards on one device share one tensor)."""
    done = {}
    for x in xs:
        if id(x) not in done:
            done[id(x)] = fn(x)
    return [done[id(x)] for x in xs]


def _make_sharded_step(cfg: ChainConfig, window, mesh, fused: bool):
    mode = mode_for(cfg)
    n_t, n_f = _split(mesh)
    a_l, p, k = cfg.n_ants // n_f, cfg.n_pols, cfg.n_chans
    devices = mesh.flat_devices
    heads = [mesh.coords(d)[0] == 0 for d in range(mesh.size)]
    windows = {dev: _window(window, cfg, dev) for dev in set(devices)}

    def step(histories, accs, chunks, fracs, phases, gains, weights,
             reset) -> dict:
        b_l = chunks[0].shape[1]
        hist = histories
        if n_t > 1:
            halos = ring_tails(chunks, histories[0].shape[1], mesh,
                               TIME_AXIS, dim=1)
            hist = [h if head else halo
                    for h, halo, head in zip(histories, halos, heads)]
        qs = [_fengine(cfg, windows[dev], c, h, fd, ph, g, fused).reshape(
                  a_l, p, b_l, k, 2)
              for dev, c, h, fd, ph, g in zip(devices, chunks, hist, fracs,
                                              phases, gains)]
        for d, (h, c) in enumerate(zip(histories, chunks)):
            if n_t == 1:
                _carry(h, c)
            elif heads[d]:
                h.copy_(halos[d])
        if mode == "fengine":
            return {"spectra": qs}
        if mode == "fx":
            a2 = corner_turn_all_to_all(qs, mesh)
            for acc, x in zip(accs, a2):
                xcorr_accumulate_a2(acc, x, keep=0 if reset else 1)
            return {}
        parts = [beamform(q, w, incoherent=cfg.incoherent_beam)
                 for q, w in zip(qs, weights)]
        coh = [c for c, _ in parts]
        coh = (psum_scatter(coh, mesh, FX_AXIS) if cfg.beam_parallel
               else psum(coh, mesh, FX_AXIS))
        out = {}
        if cfg.beam_stokes:
            out["stokes"] = _each(stokes, coh)
        if cfg.beam_quant_scale:
            coh = _each(lambda y: quantize_beams(y, cfg.beam_quant_scale),
                        coh)
        out["beams"] = coh
        if cfg.incoherent_beam:
            out["incoherent"] = psum([i for _, i in parts], mesh, FX_AXIS)
        return out

    return step
