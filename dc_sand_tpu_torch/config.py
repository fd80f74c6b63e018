"""Typed configuration for the F/X signal chain.

A copy of :mod:`dc_sand_tpu.config`: the five presets of BASELINE.json:7-11,
``get_config`` and ``scaled_for_test``.  The fields, their defaults and
:meth:`ChainConfig.config_hash` are identical to the JAX package's, so a
checkpoint written by a JAX run resumes here (``runtime/jax_state.py``
compares the hashes) and a CPU test holds the two equal.  Every port
function reads only these fields, so it accepts either package's configs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

__all__ = [
    "ChainConfig",
    "get_config",
    "CONFIG_NAMES",
    "scaled_for_test",
]


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static parameters of one F/X pipeline instance.

    Shapes and rates
    ----------------
    n_ants, n_pols:
        Antennas and polarisations per antenna (64 x 2 at full size).
    n_chans:
        Output frequency channels.  Real->complex channelizer: FFT length is
        ``2 * n_chans`` and each output spectrum consumes ``2 * n_chans`` new
        real samples (critically sampled).
    n_taps:
        Polyphase FIR taps (16 in every preset).
    window:
        Prototype window kind, see
        :func:`dc_sand_tpu_torch.windows.pfb_window`.
    sample_rate_hz:
        ADC real-sample rate (1712 Msps for 856 MHz of bandwidth).

    Stages
    ------
    apply_delay / apply_requant:
        ``pfb1k`` runs the bare PFB (float spectra out); the other presets
        add coarse delay + fringe rotation and 8-bit requantisation.
    n_spectra_per_acc:
        X-engine integration length in spectra per accumulator dump.
    n_beams:
        Coherent beams formed by the B-engine (0 = no beamformer).

    Streaming / sharding
    --------------------
    spectra_per_chunk:
        Spectra processed per streaming step.
    shard_ants / shard_chans:
        Mesh-axis mapping of the sharded modes: the F-engine shards
        antennas, the X/B-engine channels after the corner-turn.
    """

    name: str
    n_ants: int = 1
    n_pols: int = 1
    n_chans: int = 1024
    n_taps: int = 16
    window: str = "hann-sinc"
    sample_rate_hz: float = 1712e6

    # Stage toggles.
    apply_delay: bool = False
    apply_requant: bool = False
    run_xengine: bool = False
    n_beams: int = 0
    incoherent_beam: bool = False
    # Stokes I/Q/U/V detection of the float beams.  ``None`` (= off)
    # rather than False: config_hash drops None fields, so the knob's
    # existence changes no hash.
    beam_stokes: bool = None
    # 8-bit beam output: scale applied before round/saturate; 0.0 keeps
    # float32 beams
    beam_quant_scale: float = 0.0

    # Integration / streaming.
    n_spectra_per_acc: int = 64
    spectra_per_chunk: int = 64

    # Quantisation.
    quant_scale: float = 1.0  # default per-channel EQ gain magnitude
    # The JAX package's fused-kernel stage-2 precision knob (None = its
    # default).  Kept so the hash matches; the port's F-engine kernel has
    # no stage 2 and ignores it.
    stage2: str = None

    # Sharding intent only: a mesh given to make_step or FXRunner does
    # the sharding.
    shard_ants: bool = False
    shard_chans: bool = False
    # Sequence-parallel streaming: >1 shards the sample stream over a
    # time axis with a per-chunk overlap-save halo exchange.
    time_shards: int = 1
    # Beam-parallel B-engine: the partial-beam reduction over antenna
    # shards as a reduce-scatter over the beam axis.  ``None`` (= off)
    # rather than False, as for beam_stokes.
    beam_parallel: bool = None

    # ------------------------------------------------------------------
    @property
    def fft_size(self) -> int:
        """Real-FFT length M = 2 * n_chans."""
        return 2 * self.n_chans

    @property
    def window_len(self) -> int:
        return self.n_taps * self.fft_size

    @property
    def history_len(self) -> int:
        """Carried FIR history (overlap-save): (taps-1) * M samples."""
        return (self.n_taps - 1) * self.fft_size

    @property
    def n_baselines(self) -> int:
        """Antenna pairs i<=j including autos: N(N+1)/2 (2080 at 64 ants)."""
        return self.n_ants * (self.n_ants + 1) // 2

    @property
    def chunk_samples(self) -> int:
        """New real samples consumed per streaming chunk, per ant/pol."""
        return self.spectra_per_chunk * self.fft_size

    def config_hash(self) -> str:
        """Stable short hash of the fields (checkpoint provenance).

        ``None``-valued fields are dropped before hashing so adding an
        optional knob (default ``None`` = previous behaviour) does not
        invalidate every existing checkpoint hash."""
        payload = json.dumps(
            {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def replace(self, **kw) -> "ChainConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# The five evaluation configs, BASELINE.json:7-11.
# ----------------------------------------------------------------------

_CONFIGS = {
    # 1. single-pol 1k-channel PFB (16-tap Hann FIR + 2048-pt FFT) on a
    #    synthetic CW-tone stream  [BASELINE.json:7]
    "pfb1k": ChainConfig(
        name="pfb1k",
        n_ants=1,
        n_pols=1,
        n_chans=1024,
        window="hann",
    ),
    # 2. dual-pol 4k-channel PFB with coarse delay + fringe rotation and
    #    8-bit requantization  [BASELINE.json:8]
    "pfb4k": ChainConfig(
        name="pfb4k",
        n_ants=1,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
    ),
    # 3. 4-antenna FX correlator: PFB F-engine -> corner-turn -> X-engine
    #    visibilities with accumulation  [BASELINE.json:9]
    "fx4": ChainConfig(
        name="fx4",
        n_ants=4,
        n_pols=2,
        n_chans=1024,
        apply_delay=True,
        apply_requant=True,
        run_xengine=True,
    ),
    # 4. 64-antenna dual-pol FX correlator, channels sharded across
    #    devices, all-to-all corner-turn  [BASELINE.json:10]; production
    #    cadence 2048-spectra chunks (9.8 ms of stream), a dump every 4
    "fx64": ChainConfig(
        name="fx64",
        n_ants=64,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
        run_xengine=True,
        shard_ants=True,
        shard_chans=True,
        spectra_per_chunk=2048,
        n_spectra_per_acc=8192,
    ),
    # 5. coherent beamformer (multi-beam weighted sum) + incoherent sum
    #    fused with the 64-antenna F-engine  [BASELINE.json:11]
    "beam64": ChainConfig(
        name="beam64",
        n_ants=64,
        n_pols=2,
        n_chans=4096,
        apply_delay=True,
        apply_requant=True,
        n_beams=16,
        incoherent_beam=True,
        shard_ants=True,
        shard_chans=True,
        spectra_per_chunk=256,
    ),
}

CONFIG_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> ChainConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(CONFIG_NAMES)}"
        ) from None


def scaled_for_test(cfg: ChainConfig, *, n_chans: Optional[int] = None,
                    spectra_per_chunk: int = 8) -> ChainConfig:
    """Shrink a preset to CI-friendly shapes, preserving its stage toggles."""
    kw = {"spectra_per_chunk": spectra_per_chunk,
          "n_spectra_per_acc": spectra_per_chunk}
    if n_chans is not None:
        kw["n_chans"] = n_chans
    return cfg.replace(**kw)
