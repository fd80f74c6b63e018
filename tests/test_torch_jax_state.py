"""``load_jax_checkpoint`` takes every single-process file that the JAX
``load_state`` takes: files of older rounds that lack the optional keys,
and a path given without the ``.npz`` suffix.  Each case resumes the port
and the JAX runner (jnp arm) from the SAME file and compares the next
dump bitwise."""

import copy

import numpy as np
import pytest

from dc_sand_tpu import golden
from dc_sand_tpu.config import get_config, scaled_for_test
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner
from dc_sand_tpu.runtime import load_state, save_state
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner,
                                       load_jax_checkpoint)

MAX_DELAY = 8
DELAY_BLOCK = ("delay_d0", "delay_d1", "delay_p0", "delay_p1", "delay_d2",
               "delay_p2", "delay_t_ref", "delay_max", "gains", "counters")
# variant -> the keys stripped from the saved file
VARIANTS = {
    "complete": (),
    "no_acc_first_chunk": ("acc_first_chunk",),
    "no_host_tail": ("host_tail",),
    "no_delay_block": DELAY_BLOCK,
    "no_quadratic_terms": ("delay_d2", "delay_p2", "delay_t_ref"),
    "no_suffix": (),
}


def _models(cfg, seed):
    """The same delay model (integer coarse delays, a fringe rate) for the
    JAX and the port runner."""
    rng = np.random.default_rng(seed)
    a, p = cfg.n_ants, cfg.n_pols
    d0 = rng.integers(0, MAX_DELAY, (a, p)).astype(float)
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))
    out = []
    for cls in (JaxDelayModel, DelayModel):
        dm = cls.zeros(a, p, max_delay=MAX_DELAY)
        dm.d0, dm.p1 = d0.copy(), p1.copy()
        out.append(dm)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resume_from_older_jax_checkpoints(tmp_path, variant):
    cfg = scaled_for_test(get_config("fx4"), n_chans=32,
                          spectra_per_chunk=8).replace(
        n_ants=2, n_spectra_per_acc=32)
    n_chunks, c = 4, cfg.chunk_samples
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, n_chunks * c), 20.0, 31)

    def src(i):
        return stream[..., i * c:(i + 1) * c]

    gains = np.stack([np.full(cfg.n_chans, 0.05), np.zeros(cfg.n_chans)],
                     -1).astype(np.float32)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    jdm, pdm = _models(cfg, seed=32)
    first = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm), gains=gains,
                      impl="jnp")
    first.run(src, 2)
    path = save_state(first, str(tmp_path / "state"))
    assert path.endswith(".npz")
    strip = VARIANTS[variant]
    if strip:
        z = dict(np.load(path))
        assert all(k in z for k in strip)
        np.savez(path, **{k: v for k, v in z.items() if k not in strip})
    given = path[:-len(".npz")] if variant == "no_suffix" else path

    # a file without the delay block leaves each runner its own model and
    # gains, so both resume with the ones the first run had
    jax_resumed = JaxRunner(cfg, w, delay_model=copy.deepcopy(jdm),
                            gains=gains, impl="jnp")
    load_state(jax_resumed, given)
    want, want_counters = jax_resumed.run(src, 2)

    resumed = FXRunner(cfg, w, delay_model=pdm, gains=gains, device="cpu")
    load_jax_checkpoint(resumed, given)
    assert resumed.chunk_idx == 2 and resumed.t0 == 2 * c
    got, counters = resumed.run(src, 2)

    assert len(want) == len(got) == 1
    assert (got[0].n_spectra, got[0].first_chunk) == \
        (want[0].n_spectra, want[0].first_chunk)
    np.testing.assert_array_equal(got[0].vis, np.asarray(want[0].vis))
    assert (counters.chunks_in, counters.dumps) == \
        (want_counters.chunks_in, want_counters.dumps)
