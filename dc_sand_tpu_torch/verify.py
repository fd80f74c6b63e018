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
from dc_sand_tpu_torch.runtime.delays import DelayModel
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.utils.cplx import np_ri2c
from dc_sand_tpu_torch.utils.snr import snr_db
from dc_sand_tpu_torch.windows import pfb_window

SNR_BOUND = 50.0

__all__ = ["verify_config", "SNR_BOUND"]


def _golden_coarse_stream(cfg, stream, dm, n_chunks):
    """Per-chunk read-pointer coarse delay, replicating the runner's host
    feed path bitwise: chunk i is sliced from [zeros(md) | stream] at
    offset ``i*c + md - coarse_i`` with the coarse delay frozen at the
    chunk start."""
    md = dm.max_delay
    c_samp = cfg.chunk_samples
    xg = np.concatenate(
        [np.zeros(stream.shape[:-1] + (md,), stream.dtype), stream], -1)
    out = np.empty_like(stream)
    for i in range(n_chunks):
        coarse, _, _ = dm.evaluate_chunk(
            i * c_samp, cfg.spectra_per_chunk, cfg.fft_size)
        for idx in np.ndindex(stream.shape[:-1]):
            off = i * c_samp + md - int(coarse[idx])
            out[idx][i * c_samp:(i + 1) * c_samp] = xg[idx][off:off + c_samp]
    return out


def _golden_spectra(cfg, stream, dm, gains, n_chunks, window):
    """Float64 golden F-engine spectra for ``stream``."""
    fracs, phases = [], []
    for i in range(n_chunks):
        _, f, p = dm.evaluate_chunk(i * cfg.chunk_samples,
                                    cfg.spectra_per_chunk, cfg.fft_size)
        fracs.append(f)
        phases.append(p)
    lead = (cfg.n_taps - 1) * cfg.fft_size
    kw = dict(gains=gains if cfg.apply_requant else None)
    if cfg.apply_delay:
        stream = _golden_coarse_stream(cfg, stream, dm, n_chunks)
        kw.update(frac_delay=np.concatenate(fracs, -1),
                  phase=np.concatenate(phases, -1))
    xg = np.concatenate(
        [np.zeros(stream.shape[:-1] + (lead,)), stream], axis=-1)
    return golden.f_engine(xg, window, cfg.n_taps, cfg.n_chans, **kw)


def verify_config(name: str, *, device=None, mesh=None, n_chunks: int = 4,
                  scale: Optional[int] = None, seed: int = 0,
                  spectra_per_chunk: Optional[int] = 16,
                  n_spectra_per_acc: Optional[int] = 32,
                  time_shards: int = 1, beam_parallel: bool = False,
                  fused: bool = True):
    """Run config ``name`` end-to-end on ``device`` (None: the current
    CUDA device; it raises without a card); returns ``(snrs,
    counters)`` — per-output SNRs in dB vs golden (fengine: ``{"spectra":
    ...}``; fx: ``{"visibilities": min over dumps}``; beam: ``{"beams":
    ..., "incoherent": ...}``, each over all chunks) and the runner's
    counters.

    ``scale``: optionally reduce n_chans; None = full size.
    ``spectra_per_chunk`` / ``n_spectra_per_acc``: clamp the streaming
    cadence (defaults); None runs the config's own cadence.  Every
    spectrum, baseline and beam is graded.  The stream (``pfb1k``: a CW
    tone, its contract input), delay model, gains and beam weights come
    from ``seed`` exactly as the JAX verify draws them.  ``fused``: the
    F-engine path (False is the JAX verify's ``impl="pallas"``).
    ``mesh``: run the sharded step over this mesh instead of on
    ``device`` (give one of the two); ``time_shards > 1`` runs SP mode
    (the mesh's time axis), the chunk raised to ``time_shards *
    taps_pad`` spectra at least so that every time shard holds its
    overlap-save halo, and ``beam_parallel`` the beam-sharded B-engine,
    as the JAX verify does.
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

    runner = FXRunner(cfg, window, delay_model=dm, gains=gains_ri,
                      weights=weights, device=device, mesh=mesh, fused=fused)
    outputs = []
    dumps, counters = runner.run(
        lambda i: stream[..., i * cfg.chunk_samples:
                         (i + 1) * cfg.chunk_samples], n_chunks,
        on_output=lambda i, o: outputs.append(
            {name_: v.cpu().numpy() for name_, v in o.items()}))

    spec_g = _golden_spectra(cfg, stream, dm, gains, n_chunks, window)
    snrs: Dict[str, float] = {}
    if mode == "fengine":
        got = np.concatenate([o["spectra"] for o in outputs], axis=2)
        snrs["spectra"] = snr_db(spec_g, np_ri2c(got))
        return snrs, counters
    if mode == "fx":
        bpa = cfg.n_spectra_per_acc
        vals = [snr_db(golden.xcorr(spec_g[:, :, i * bpa:(i + 1) * bpa]),
                       d.vis[..., 0] + 1j * d.vis[..., 1])
                for i, d in enumerate(dumps)]
        snrs["visibilities"] = min(vals) if vals else float("nan")
        return snrs, counters
    beams = np.concatenate([o["beams"] for o in outputs], axis=2)
    beams_g = golden.beamform(spec_g, weights[..., 0] + 1j * weights[..., 1])
    snrs["beams"] = snr_db(beams_g, beams[..., 0] + 1j * beams[..., 1])
    if cfg.incoherent_beam:
        snrs["incoherent"] = snr_db(
            golden.incoherent_sum(spec_g),
            np.concatenate([o["incoherent"] for o in outputs], axis=1))
    return snrs, counters
