"""The port's ``dryrun_multichip`` on 2 and 4 CPU shards: every sharded
mode runs one step, and each mode's outputs equal the same step on one
device (on the CPU: fx dumps, spectra and incoherent beams bitwise; float
beams within float32 summation order), and the fx dump equals the JAX
runner's (jnp arm) on the same inputs."""

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.dryrun import (dryrun_modes, dryrun_multichip,
                                      dryrun_reference, main)
from dc_sand_tpu_torch.utils import snr_db

# float32 beams summed over shards in another order: about 140 dB apart
BEAM_SNR = 120.0
MODES = {n: list(dryrun_modes(n)) for n in (2, 4)}


@pytest.fixture(scope="module")
def runs():
    return {n: (dryrun_multichip(n, ["cpu"] * n),
                dryrun_reference(n, device="cpu")) for n in MODES}


@pytest.mark.parametrize("n,mode", [(n, m) for n, ms in MODES.items()
                                    for m in ms])
def test_mode_equals_one_device(runs, n, mode):
    got, ref = runs[n][0][mode], runs[n][1][mode]
    assert got.ms > 0 and set(got.outputs) == set(ref.outputs)
    for key, v in got.outputs.items():
        want = ref.outputs[key]
        assert v.shape == want.shape and v.dtype == want.dtype
        assert np.abs(v).max() > 0
        if key == "beams":
            assert snr_db(want[..., 0] + 1j * want[..., 1],
                          v[..., 0] + 1j * v[..., 1]) >= BEAM_SNR
        else:   # integer sums: vis, the incoherent beam of int8 spectra
            np.testing.assert_array_equal(v, want)


def test_modes_cover_the_sharded_surface():
    assert MODES[2] == ["fx", "beam", "beam_parallel", "sp_fx",
                        "time_fengine", "fused_fx"]
    assert MODES[4] == ["fx", "beam", "beam_parallel", "sp_fx",
                        "sp_beam_parallel", "time_fengine", "fused_fx"]
    cfg, n_t = dryrun_modes(4)["fx"]
    assert (cfg.n_chans, cfg.spectra_per_chunk, cfg.n_ants, n_t) == \
        (64, 8, 8, 1)


def test_fx_dump_matches_the_jax_step(runs):
    """The fx mode's dump against the JAX runner (jnp arm) on the same
    chunk and delay model."""
    import dataclasses
    from dc_sand_tpu.config import ChainConfig as JaxChainConfig
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    from dc_sand_tpu_torch.dryrun import _inputs
    cfg, _ = dryrun_modes(2)["fx"]
    inp = _inputs("fx", cfg, 2)
    dm = JaxDelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
    dm.d0, dm.p0 = inp["delays"].d0.copy(), inp["delays"].p0.copy()
    want, _ = JaxRunner(JaxChainConfig(**dataclasses.asdict(cfg)),
                        inp["window"], delay_model=dm,
                        impl="jnp").run(lambda i: inp["chunk"], 1)
    np.testing.assert_array_equal(runs[2][0]["fx"].outputs["vis"],
                                  want[0].vis)


def test_main_on_cpu_shards(capsys):
    assert main(["2", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): fx + beam + beam_parallel + sp_fx + " \
        "time_fengine + fused_fx ran" in out


def test_defaults_are_the_card(monkeypatch):
    """Without a device argument both entry points run on the card, and
    without one they raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_reference(2)
