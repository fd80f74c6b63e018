"""End-to-end verification of the five configs against the golden chain.

PyTorch counterpart of :func:`dc_sand_tpu.verify.verify_config`, on one
device or a device mesh: the config runs through this package's
streaming runner and its outputs (fengine: the spectra; fx: the dumps;
beam: the beams and the incoherent beam) are graded against the float64
golden chain at the contract bound of >50 dB SNR.  The golden oracle
helpers are copies of the JAX package's (``verify.py`` there imports
jax); a CPU test holds them equal.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dc_sand_tpu_torch import golden
from dc_sand_tpu_torch.config import get_config, scaled_for_test
from dc_sand_tpu_torch.models.pipeline import mode_for
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.parallel import FX_AXIS, local_antenna_range
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.utils.cplx import np_ri2c
from dc_sand_tpu_torch.utils.snr import snr_db
from dc_sand_tpu_torch.windows import pfb_window

SNR_BOUND = 50.0

__all__ = ["verify_config", "SNR_BOUND"]


def _golden_coarse_stream(cfg, stream, dm, n_chunks, ant_idx=None):
    """Per-chunk read-pointer coarse delay, replicating the runner's host
    feed path bitwise: chunk i is sliced from [zeros(md) | stream] at
    offset ``i*c + md - coarse_i`` with the coarse delay frozen at the
    chunk start.  ``ant_idx`` maps ``stream``'s (possibly subset) antenna
    axis to the delay model's antennas."""
    md = dm.max_delay
    c_samp = cfg.chunk_samples
    xg = np.concatenate(
        [np.zeros(stream.shape[:-1] + (md,), stream.dtype), stream], -1)
    out = np.empty_like(stream)
    for i in range(n_chunks):
        coarse, _, _ = dm.evaluate_chunk(
            i * c_samp, cfg.spectra_per_chunk, cfg.fft_size)
        for idx in np.ndindex(stream.shape[:-1]):
            midx = ((int(ant_idx[idx[0]]),) + idx[1:]
                    if ant_idx is not None else idx)
            off = i * c_samp + md - int(coarse[midx])
            out[idx][i * c_samp:(i + 1) * c_samp] = xg[idx][off:off + c_samp]
    return out


def _golden_spectra(cfg, stream, dm, gains, n_chunks, window,
                    ant_idx=None):
    """Float64 golden F-engine spectra for ``stream``; with ``ant_idx``
    only for those antennas (indices into ``stream`` and the delay
    model), in that order, one antenna at a time, so that the host holds
    one antenna's float64 intermediates at a time (all antennas at once
    at fx64's production cadence peak above 128 GB)."""
    fracs, phases = [], []
    for i in range(n_chunks):
        _, f, p = dm.evaluate_chunk(i * cfg.chunk_samples,
                                    cfg.spectra_per_chunk, cfg.fft_size)
        fracs.append(f)
        phases.append(p)
    frac = np.concatenate(fracs, -1) if cfg.apply_delay else None
    phase = np.concatenate(phases, -1) if cfg.apply_delay else None
    lead = (cfg.n_taps - 1) * cfg.fft_size

    def chain(sub, orig_ants):
        if cfg.apply_delay:
            sub = _golden_coarse_stream(cfg, sub, dm, n_chunks,
                                        ant_idx=orig_ants)
        xg = np.concatenate(
            [np.zeros(sub.shape[:-1] + (lead,)), sub], axis=-1)
        kw = dict(gains=gains if cfg.apply_requant else None)
        if cfg.apply_delay:
            kw.update(frac_delay=frac[orig_ants], phase=phase[orig_ants])
        return golden.f_engine(xg, window, cfg.n_taps, cfg.n_chans, **kw)

    if ant_idx is None:
        return chain(stream, np.arange(stream.shape[0]))
    return np.concatenate(
        [chain(stream[orig:orig + 1], np.array([orig]))
         for orig in ant_idx], axis=0)


def verify_config(name: str, *, device=None, mesh=None, n_chunks: int = 4,
                  scale: Optional[int] = None, seed: int = 0,
                  spectra_per_chunk: Optional[int] = 16,
                  n_spectra_per_acc: Optional[int] = 32,
                  time_shards: int = 1, beam_parallel: bool = False,
                  fused: bool = True, baseline_subset: Optional[int] = None,
                  golden_ants: Optional[int] = None,
                  coarse_on_host: Optional[bool] = None):
    """Run config ``name`` end-to-end on ``device`` (None: the current
    CUDA device; it raises without a card); returns ``(snrs,
    counters)`` — per-output SNRs in dB vs golden (fengine: ``{"spectra":
    ...}``; fx: ``{"visibilities": min over dumps}``; beam: ``{"beams":
    ..., "incoherent": ...}``, each over all chunks) and the runner's
    counters.

    ``scale``: optionally reduce n_chans; None = full size.
    ``spectra_per_chunk`` / ``n_spectra_per_acc``: clamp the streaming
    cadence (defaults); None runs the config's own cadence.  Every
    spectrum, baseline and beam is graded, unless ``baseline_subset`` or
    ``golden_ants`` (below) picks the baselines.  The stream (``pfb1k``: a CW
    tone, its contract input), delay model, gains and beam weights come
    from ``seed`` exactly as the JAX verify draws them.  ``fused``: the
    F-engine path (False is the JAX verify's ``impl="pallas"``).
    ``mesh``: run the sharded step over this mesh instead of on
    ``device`` (give one of the two); ``time_shards > 1`` runs SP mode
    (the mesh's time axis), the chunk raised to ``time_shards *
    taps_pad`` spectra at least so that every time shard holds its
    overlap-save halo, and ``beam_parallel`` the beam-sharded B-engine,
    as the JAX verify does.  On a mesh over several processes, on one
    node or several (each pair of ranks on its route,
    :meth:`~dc_sand_tpu_torch.parallel.mesh.Mesh.routes`), every rank
    calls it alike: each draws the same seeded sky, feeds its own
    antennas (:func:`~dc_sand_tpu_torch.parallel.local_antenna_range`),
    and grades the whole dump, its own antennas' spectra, or the beams
    it holds.  ``coarse_on_host``: the runner's coarse mode; None takes
    the JAX verify's choice, the device mode (``False``) on a mesh over
    several processes and the host shift otherwise.  The delay model
    holds each coarse delay for the whole stream, so both modes meet the
    same golden chain.

    fx mode only, each mutually exclusive with the other (the device
    still computes every baseline; the grading draws from ``seed`` as the
    JAX verify does, so one seed grades the same baselines in both):
    ``baseline_subset`` grades that many randomly chosen baselines;
    ``golden_ants`` grades all pairs among that many randomly chosen
    antennas and evaluates the golden spectra for those antennas only,
    one at a time (12 antennas at fx64's production cadence: 78
    baselines, a golden footprint of about 13 GB).
    """
    cfg = get_config(name)
    mode = mode_for(cfg)
    if scale is not None:
        cfg = scaled_for_test(cfg, n_chans=scale)
    if spectra_per_chunk is not None:
        cfg = cfg.replace(spectra_per_chunk=min(cfg.spectra_per_chunk,
                                                spectra_per_chunk))
    if n_spectra_per_acc is not None:
        cfg = cfg.replace(n_spectra_per_acc=min(cfg.n_spectra_per_acc,
                                                n_spectra_per_acc))
    if time_shards > 1:
        spc = max(cfg.spectra_per_chunk,
                  time_shards * taps_pad_for(cfg.n_taps))
        spa = -(-cfg.n_spectra_per_acc // spc) * spc
        cfg = cfg.replace(time_shards=time_shards, spectra_per_chunk=spc,
                          n_spectra_per_acc=spa)
    if beam_parallel:
        cfg = cfg.replace(beam_parallel=True)
    if mode == "fx" and cfg.n_spectra_per_acc % cfg.spectra_per_chunk:
        # the runner dumps at chunk-aligned boundaries (>=), while the
        # golden oracle slices exact n_spectra_per_acc windows
        raise ValueError(
            f"n_spectra_per_acc ({cfg.n_spectra_per_acc}) must be a "
            f"multiple of spectra_per_chunk ({cfg.spectra_per_chunk}) "
            "for fx verification")
    if golden_ants is not None:
        if baseline_subset is not None:
            raise ValueError("golden_ants and baseline_subset are "
                             "mutually exclusive")
        if mode != "fx":
            raise ValueError("golden_ants applies to fx-mode configs")
    rng = np.random.default_rng(seed)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)

    if cfg.apply_delay:
        dm = DelayModel.zeros(a, p, max_delay=32)
        dm.d0 = rng.integers(0, 32, (a, p)).astype(float)
        dm.p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    else:
        dm = DelayModel.zeros(a, p)
    if name == "pfb1k":
        k0 = k // 3
        tone = golden.cw_tone(n_chunks * cfg.chunk_samples,
                              k0 * cfg.sample_rate_hz / cfg.fft_size,
                              cfg.sample_rate_hz, amplitude=90.0)
        stream = golden.quantize_adc(
            np.broadcast_to(tone, (a, p) + tone.shape))
    else:
        stream = golden.gaussian_noise_int8(
            (a, p, n_chunks * cfg.chunk_samples), 20.0, seed)
    gains = np.full(k, 0.05) + 0j
    gains_ri = np.stack([gains.real, gains.imag], -1).astype(np.float32)
    weights = None
    if mode == "beam":
        weights = rng.normal(size=(cfg.n_beams, a, k, 2)).astype(np.float32)

    # on a multi-process mesh every rank draws the same sky and feeds its
    # own antennas; each grades the whole dump, its own antennas' spectra
    # and its own share of beam-parallel beams
    multiproc = mesh is not None and mesh.multiprocess
    a_lo, a_hi = local_antenna_range(a) if multiproc else (0, a)
    if coarse_on_host is None:
        coarse_on_host = not multiproc
    runner = FXRunner(cfg, window, delay_model=dm, gains=gains_ri,
                      weights=weights, device=device, mesh=mesh, fused=fused,
                      coarse_on_host=coarse_on_host)
    outputs = []
    dumps, counters = runner.run(
        lambda i: stream[a_lo:a_hi, :, i * cfg.chunk_samples:
                         (i + 1) * cfg.chunk_samples], n_chunks,
        on_output=lambda i, o: outputs.append(
            {name_: v.cpu().numpy() for name_, v in o.items()}))

    ants_sel = (np.sort(rng.choice(a, min(golden_ants, a), replace=False))
                if golden_ants is not None else None)
    spec_g = _golden_spectra(cfg, stream, dm, gains, n_chunks, window,
                             ant_idx=ants_sel)
    snrs: Dict[str, float] = {}
    if mode == "fengine":
        got = np.concatenate([o["spectra"] for o in outputs], axis=2)
        snrs["spectra"] = snr_db(spec_g[a_lo:a_hi], np_ri2c(got))
        return snrs, counters
    if mode == "fx":
        snrs["visibilities"] = _grade_dumps(cfg, dumps, spec_g, rng,
                                            ants_sel, baseline_subset)
        return snrs, counters
    beams = np.concatenate([o["beams"] for o in outputs], axis=2)
    beams_g = golden.beamform(spec_g, weights[..., 0] + 1j * weights[..., 1])
    if cfg.beam_parallel and mesh is not None and mesh.multiprocess:
        nb_l = cfg.n_beams // mesh.shape[FX_AXIS]
        _, fs = mesh.local_block()
        beams_g = beams_g[fs[0] * nb_l:(fs[-1] + 1) * nb_l]
    snrs["beams"] = snr_db(beams_g, beams[..., 0] + 1j * beams[..., 1])
    if cfg.incoherent_beam:
        snrs["incoherent"] = snr_db(
            golden.incoherent_sum(spec_g),
            np.concatenate([o["incoherent"] for o in outputs], axis=1))
    return snrs, counters


def _grade_dumps(cfg, dumps, spec_g, rng, ants_sel, baseline_subset):
    """The least SNR of the dumps against the golden X-engine: every
    baseline, all pairs among ``ants_sel`` (``spec_g`` then holds those
    antennas only), or ``baseline_subset`` baselines drawn from ``rng``."""
    bpa = cfg.n_spectra_per_acc
    pairs = golden.baseline_pairs(cfg.n_ants)
    loc = None
    if ants_sel is not None:
        pos = {int(x): li for li, x in enumerate(ants_sel)}
        sel = [(bi, pos[int(i)], pos[int(j)])
               for bi, (i, j) in enumerate(pairs)
               if int(i) in pos and int(j) in pos]
        bl_idx = np.array([bi for bi, _, _ in sel])
        loc = [(li, lj) for _, li, lj in sel]
    elif baseline_subset is not None and baseline_subset < len(pairs):
        bl_idx = np.sort(rng.choice(len(pairs), baseline_subset,
                                    replace=False))
        loc = pairs[bl_idx]
    else:
        bl_idx = None
    vals = []
    for i, d in enumerate(dumps):
        win = spec_g[:, :, i * bpa:(i + 1) * bpa]
        got = d.vis[..., 0] + 1j * d.vis[..., 1]
        if bl_idx is None:
            vals.append(snr_db(golden.xcorr(win), got))
            continue
        vg = np.stack([np.einsum("pbk,qbk->pqk", win[i_], np.conj(win[j_]))
                       for i_, j_ in loc])
        vals.append(snr_db(vg, got[bl_idx]))
    return min(vals) if vals else float("nan")
