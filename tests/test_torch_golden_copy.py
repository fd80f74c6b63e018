"""The port's copies of the JAX package's framework-free modules (config,
windows, golden) against the originals: every field and hash of each
config, each window kind, and each copied golden function bitwise on
seeded inputs."""

import dataclasses

import numpy as np
import pytest

from dc_sand_tpu import config as jx_config
from dc_sand_tpu import golden as jx_golden
from dc_sand_tpu import windows as jx_windows
from dc_sand_tpu_torch import config, golden, windows


@pytest.mark.parametrize("name", jx_config.CONFIG_NAMES)
def test_config_copy_equals_the_jax_package(name):
    assert config.CONFIG_NAMES == jx_config.CONFIG_NAMES
    want, got = jx_config.get_config(name), config.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.config_hash() == want.config_hash()
    for prop in ("fft_size", "window_len", "history_len", "n_baselines",
                 "chunk_samples"):
        assert getattr(got, prop) == getattr(want, prop)
    for kw in ({}, {"n_chans": 64, "spectra_per_chunk": 16}):
        a = config.scaled_for_test(got, **kw)
        b = jx_config.scaled_for_test(want, **kw)
        assert a.config_hash() == b.config_hash()
    assert (got.replace(n_ants=3).config_hash()
            == want.replace(n_ants=3).config_hash())


def test_config_fields_and_unknown_name():
    assert ([f.name for f in dataclasses.fields(config.ChainConfig)]
            == [f.name for f in dataclasses.fields(jx_config.ChainConfig)])
    with pytest.raises(KeyError, match="unknown config"):
        config.get_config("fx128")


@pytest.mark.parametrize("kind", ["hann-sinc", "hann", "rect"])
@pytest.mark.parametrize("taps,m", [(16, 2048), (4, 100)])
def test_window_copy_is_bitwise(kind, taps, m):
    np.testing.assert_array_equal(windows.pfb_window(taps, m, kind),
                                  jx_windows.pfb_window(taps, m, kind))


def test_unknown_window_kind_raises():
    with pytest.raises(ValueError, match="window kind"):
        windows.pfb_window(4, 64, "kaiser")


def _spectra(rng, shape):
    return rng.normal(0, 30, shape) + 1j * rng.normal(0, 30, shape)


def _case(name, rng):
    """``(args, kwargs)`` of a seeded call of golden function ``name``."""
    taps, nch, m = 4, 16, 32
    x = rng.integers(-127, 128, (2, 3, (6 + taps - 1) * m)).astype(np.int8)
    w = jx_windows.pfb_window(taps, m)
    if name == "apply_coarse_delay":
        return (x, rng.integers(0, 9, (2, 3)), 8), {}
    if name == "pfb_fir":
        return (x, w, taps, m), {}
    if name == "channelize":
        return (rng.normal(0, 100, (2, 5, m)), nch), {}
    if name == "fine_delay_fringe":
        return (_spectra(rng, (2, 5, nch)), rng.uniform(-.5, .5, (2, 5)),
                rng.uniform(-3, 3, (2, 5))), {}
    if name == "requantize":
        return (_spectra(rng, (2, 5, nch)) * 3,
                0.2 * np.exp(1j * rng.uniform(-3, 3, nch))), {}
    if name == "xcorr":
        return (_spectra(rng, (3, 2, 5, nch)),), {}
    if name == "beamform":
        return (_spectra(rng, (3, 2, 5, nch)), _spectra(rng, (4, 3, nch))), {}
    if name == "incoherent_sum":
        return (_spectra(rng, (3, 2, 5, nch)),), {}
    if name == "f_engine":
        lead_in = rng.integers(-127, 128, (2, 3, 8)).astype(np.int8)
        return (np.concatenate([lead_in, x], -1), w, taps, nch), dict(
            coarse_delays=rng.integers(0, 9, (2, 3)), max_delay=8,
            frac_delay=rng.uniform(-.5, .5, (2, 3, 6)),
            phase=rng.uniform(-3, 3, (2, 3, 6)),
            gains=0.05 * np.exp(1j * rng.uniform(-3, 3, nch)))
    if name == "baseline_pairs":
        return (7,), {}
    if name == "cw_tone":
        return (1000, 3.5e8, 1712e6), dict(amplitude=90.0, phase=0.3)
    if name == "quantize_adc":
        return (rng.normal(0, 80, (3, 50)),), {}
    if name == "gaussian_noise_int8":
        return ((2, 3, 64), 20.0, 5), {}
    if name == "gaussian_noise":
        return ((2, 3, 64), 20.0, 5), {}
    if name == "gaussian_noise_1d":
        return (100,), dict(seed=7)
    if name == "corner_turn":
        return (_spectra(rng, (3, 2, 5, nch)),), {}
    if name == "stokes":
        return (_spectra(rng, (4, 2, 5, nch)),), {}
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "apply_coarse_delay", "pfb_fir", "channelize", "fine_delay_fringe",
    "requantize", "xcorr", "beamform", "incoherent_sum", "f_engine",
    "baseline_pairs", "cw_tone", "quantize_adc", "gaussian_noise_int8",
    "gaussian_noise", "gaussian_noise_1d", "corner_turn", "stokes"])
def test_golden_copy_is_bitwise(name):
    args, kw = _case(name, np.random.default_rng(len(name)))
    fn = name.removesuffix("_1d")
    got = getattr(golden, fn)(*args, **kw)
    want = getattr(jx_golden, fn)(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
