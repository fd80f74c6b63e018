"""The port's own checkpoint (``runtime/checkpoint.py``): save, load and
continue bitwise against an uninterrupted run in fx, beam and SP mode
with a drifting delay model; the file against the JAX package's
``save_state``/``load_state`` in both directions; the refusals.

Streams, delays, gains and weights come from numpy seeds and are fed to
both packages; the JAX runners run on the CPU with ``impl="auto"``."""

import numpy as np
import pytest
import torch

from dc_sand_tpu import golden
from dc_sand_tpu.parallel import build_mesh as jax_build_mesh
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner
from dc_sand_tpu.runtime import load_state as jax_load_state
from dc_sand_tpu.runtime import save_state as jax_save_state
from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                       save_state)
from dc_sand_tpu_torch.windows import pfb_window

MAX_DELAY = 8
N_CHUNKS, SAVE_AT = 6, 3          # 4-chunk fx windows: the save is mid-window
# the keys of the JAX package's single-process file
KEYS = {"t0", "chunk_idx", "acc_spectra", "acc_integrated",
        "acc_first_chunk", "config_hash", "host_tail", "delay_d0",
        "delay_d1", "delay_p0", "delay_p1", "delay_d2", "delay_p2",
        "delay_t_ref", "delay_max", "gains", "counters", "history",
        "vis_acc", "weights"}


def _cfg(mode, time_shards=1):
    kw = dict(name="ckpt", n_ants=4, n_pols=2, n_chans=32, n_taps=4,
              spectra_per_chunk=16, n_spectra_per_acc=64, apply_delay=True,
              apply_requant=True, time_shards=time_shards)
    if mode == "beam":
        kw.update(n_beams=3, incoherent_beam=True)
    else:
        kw.update(run_xengine=True)
    return ChainConfig(**kw)


def _inputs(cfg, seed, max_delay=MAX_DELAY):
    """``(src, gains, weights, delay-model factory)`` from ``seed``: a
    drifting model (d1 != 0) whose coarse delay changes from chunk to
    chunk, the same for either package's ``DelayModel`` class."""
    rng = np.random.default_rng(seed)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    stream = golden.gaussian_noise_int8(
        (a, p, N_CHUNKS * cfg.chunk_samples), 20.0, seed)
    c = cfg.chunk_samples
    gains = np.stack([rng.uniform(0.04, 0.06, k),
                      rng.uniform(-0.01, 0.01, k)], -1).astype(np.float32)
    weights = (rng.normal(size=(cfg.n_beams, a, k, 2)).astype(np.float32)
               if cfg.n_beams else None)
    d0 = rng.uniform(0.0, max_delay / 2, (a, p))
    d1 = rng.uniform(0.5, 1.0, (a, p)) / c     # 0.5-1 sample a chunk
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))

    def dm(cls=DelayModel):
        m = cls.zeros(a, p, max_delay=max_delay)
        if max_delay:
            m.d0, m.d1 = d0.copy(), d1.copy()
        m.p1 = p1.copy()
        return m

    return (lambda i: stream[..., i * c:(i + 1) * c]), gains, weights, dm


def _runner(cfg, dm, gains, weights, mesh):
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    if mesh is None:
        return FXRunner(cfg, w, delay_model=dm, gains=gains, weights=weights,
                        device="cpu")
    return FXRunner(cfg, w, delay_model=dm, gains=gains, weights=weights,
                    mesh=mesh)


def _results(runner, src, n):
    """``(dumps, outputs)`` of ``n`` more chunks, outputs as numpy."""
    outs = []
    dumps, _ = runner.run(src, n, on_output=lambda i, o: outs.append(
        {k: v.numpy() for k, v in o.items()}))
    return dumps, outs


def _assert_same(got, want):
    (gd, go), (wd, wo) = got, want
    assert len(gd) == len(wd) and len(go) == len(wo)
    for a, b in zip(gd, wd):
        assert (a.n_spectra, a.n_spectra_nominal, a.first_chunk) == \
            (b.n_spectra, b.n_spectra_nominal, b.first_chunk)
        np.testing.assert_array_equal(a.vis, b.vis)
    for a, b in zip(go, wo):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode,mesh_shape", [
    ("fx", None), ("beam", None), ("fx", (4, 2)), ("beam", (4, 2))])
def test_save_load_continue_bitwise(tmp_path, mode, mesh_shape):
    """Save mid-window, load into a fresh runner built with a zero delay
    model, continue: dumps, outputs, counters and the delay model equal
    an uninterrupted run's, bitwise.  ``(4, 2)``: SP on a (time 2, fx 2)
    CPU mesh, whose file holds one history block and one partial
    accumulator per time shard."""
    n_t = mesh_shape[1] if mesh_shape else 1
    cfg = _cfg(mode, n_t)
    src, gains, weights, dm = _inputs(cfg, seed=40)
    coarse = [dm().evaluate_chunk(i * cfg.chunk_samples,
                                  cfg.spectra_per_chunk, cfg.fft_size)[0]
              for i in (SAVE_AT - 1, SAVE_AT)]
    assert (coarse[0] != coarse[1]).any()     # it drifts across the save

    def mesh():
        return None if mesh_shape is None else build_mesh(
            ["cpu"] * mesh_shape[0], time_shards=mesh_shape[1])

    ref = _runner(cfg, dm(), gains, weights, mesh())
    _results(ref, src, SAVE_AT)
    want = _results(ref, src, N_CHUNKS - SAVE_AT)

    first = _runner(cfg, dm(), gains, weights, mesh())
    _results(first, src, SAVE_AT)
    path = save_state(first, str(tmp_path / "state"))
    assert path == str(tmp_path / "state.npz")
    z = np.load(path)
    assert set(z.files) == KEYS
    a, p, m = cfg.n_ants, cfg.n_pols, cfg.fft_size
    assert z["history"].shape == (a, p, n_t * (cfg.n_taps - 1) * m)
    if mode == "fx":
        acc = (cfg.n_chans, a * p, a * p)
        assert z["vis_acc"].shape == ((n_t,) + acc if n_t > 1 else acc)

    resumed = _runner(cfg, DelayModel.zeros(a, p, MAX_DELAY),
                      np.ones((cfg.n_chans, 2), np.float32), None, mesh())
    load_state(resumed, path)
    got = _results(resumed, src, N_CHUNKS - SAVE_AT)
    _assert_same(got, want)
    assert resumed.counters == ref.counters
    for key in ("d0", "d1", "p0", "p1", "d2", "p2"):
        np.testing.assert_array_equal(getattr(resumed.delay_model, key),
                                      getattr(ref.delay_model, key))


@pytest.mark.parametrize("mode,time_shards", [("fx", 1), ("beam", 1),
                                              ("fx", 2)])
def test_port_file_resumes_the_jax_runner(tmp_path, mode, time_shards):
    """The port saves after 3 chunks; a JAX CPU runner (``impl="auto"``)
    loads the file with the JAX ``load_state`` and runs 3 more: its dumps
    and outputs equal those of the JAX runner that ran all 6, bitwise,
    and its dumps equal the port's own continuation.  Every key but the
    accumulator equals the JAX file saved after the same chunks.  SP: a
    (time 2, fx 2) mesh in both packages, the coarse delay off, as the
    JAX SP runner needs."""
    cfg = _cfg(mode, time_shards)
    md = MAX_DELAY if time_shards == 1 else 0
    src, gains, weights, dm = _inputs(cfg, seed=41, max_delay=md)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)

    def jax_runner():
        jmesh = (jax_build_mesh(n_devices=4, time_shards=time_shards)
                 if time_shards > 1 else None)
        return JaxRunner(cfg, w, delay_model=dm(JaxDelayModel), gains=gains,
                         weights=weights, mesh=jmesh, impl="auto")

    def jax_results(r, n):
        outs = []
        dumps, _ = r.run(src, n, on_output=lambda i, o: outs.append(
            {k: np.asarray(v) for k, v in o.items()}))
        return dumps, outs

    ref = jax_runner()
    jax_results(ref, SAVE_AT)
    jax_file = jax_save_state(ref, str(tmp_path / "jax"))
    want = jax_results(ref, N_CHUNKS - SAVE_AT)

    mesh = build_mesh(["cpu"] * 4, time_shards=2) if time_shards > 1 else None
    port = _runner(cfg, dm(), gains, weights, mesh)
    _results(port, src, SAVE_AT)
    path = save_state(port, str(tmp_path / "port"))
    zp, zj = np.load(path), np.load(jax_file)
    assert set(zp.files) == set(zj.files) == KEYS
    for key in KEYS - {"vis_acc"}:
        np.testing.assert_array_equal(zp[key], zj[key], err_msg=key)
    assert zp["vis_acc"].shape == zj["vis_acc"].shape

    resumed = jax_runner()
    jax_load_state(resumed, path)
    got = jax_results(resumed, N_CHUNKS - SAVE_AT)
    _assert_same(got, want)
    if mode == "fx":
        mine, _ = _results(port, src, N_CHUNKS - SAVE_AT)
        assert len(mine) == len(got[0]) == 1
        np.testing.assert_array_equal(mine[0].vis, got[0][0].vis)


@pytest.mark.parametrize("mode", ["fx", "beam"])
def test_jax_file_resumes_the_port(tmp_path, mode):
    """A JAX ``save_state`` file after 3 chunks, loaded by the port's
    ``load_state`` (the name given without ``.npz``): the port's next 3
    chunks equal those of a port runner that ran all 6 (fx dumps and
    outputs bitwise) and the saved-and-reloaded port state equals the
    JAX file, key by key."""
    cfg = _cfg(mode)
    src, gains, weights, dm = _inputs(cfg, seed=42)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    first = JaxRunner(cfg, w, delay_model=dm(JaxDelayModel), gains=gains,
                      weights=weights, impl="auto")
    first.run(src, SAVE_AT)
    jax_file = jax_save_state(first, str(tmp_path / "jax"))
    ref = _runner(cfg, dm(), gains, weights, None)
    _results(ref, src, SAVE_AT)
    want = _results(ref, src, N_CHUNKS - SAVE_AT)

    resumed = _runner(cfg, DelayModel.zeros(cfg.n_ants, cfg.n_pols,
                                            MAX_DELAY),
                      None, None, None)
    load_state(resumed, str(tmp_path / "jax"))
    again = np.load(save_state(resumed, str(tmp_path / "again")))
    zj = np.load(jax_file)
    for key in KEYS - {"vis_acc"}:
        np.testing.assert_array_equal(again[key], zj[key], err_msg=key)
    np.testing.assert_array_equal(again["vis_acc"], zj["vis_acc"])
    got = _results(resumed, src, N_CHUNKS - SAVE_AT)
    if mode == "fx":
        _assert_same(got, want)
    else:
        assert len(got[1]) == len(want[1]) == N_CHUNKS - SAVE_AT


def test_npz_suffix_and_refusals(tmp_path):
    """``save_state`` appends ``.npz`` once and returns the name written;
    ``load_state`` takes the name with or without it; a file of another
    config, of another ``max_delay``, or of another history shape is
    refused, and so is a multi-process file."""
    cfg = _cfg("fx")
    src, gains, _, dm = _inputs(cfg, seed=43)
    r = _runner(cfg, dm(), gains, None, None)
    r.run(src, 1)
    bare = save_state(r, str(tmp_path / "s"))
    assert bare == str(tmp_path / "s.npz")
    assert save_state(r, bare) == bare
    pad0 = taps_pad_for(cfg.n_taps) - cfg.n_taps + 1   # frames never read
    for name in (str(tmp_path / "s"), bare):
        fresh = _runner(cfg, dm(), gains, None, None)
        load_state(fresh, name)
        assert (fresh.chunk_idx, fresh.t0) == (1, cfg.chunk_samples)
        assert torch.equal(fresh.history[0][:, pad0:], r.history[0][:, pad0:])

    with pytest.raises(ValueError, match="config hash"):
        load_state(_runner(cfg.replace(n_spectra_per_acc=32), dm(), gains,
                           None, None), bare)
    with pytest.raises(ValueError, match="max_delay"):
        load_state(_runner(cfg, DelayModel.zeros(4, 2, MAX_DELAY + 1),
                           gains, None, None), bare)
    z = dict(np.load(bare))
    for key, value, match in (
            ("history", z["history"][..., :-cfg.fft_size], "history shape"),
            ("vis_acc", z["vis_acc"][:-1], "accumulator shape"),
            ("process_shape", np.array([0, 2]), "multi-process")):
        bad = str(tmp_path / f"bad_{key}.npz")
        np.savez(bad, **{**z, key: value})
        with pytest.raises(ValueError, match=match):
            load_state(_runner(cfg, dm(), gains, None, None), bad)


def test_load_copies_the_carry_in_place(tmp_path):
    """``load_state`` writes into the runner's carry tensors (a CUDA graph
    of ``run_batched`` holds their addresses) and re-points nothing but
    the parameters."""
    cfg = _cfg("fx")
    src, gains, _, dm = _inputs(cfg, seed=44)
    r = _runner(cfg, dm(), gains, None, None)
    r.run(src, 2)
    path = save_state(r, str(tmp_path / "s"))
    fresh = _runner(cfg, dm(), gains, None, None)
    ptrs = [t.data_ptr() for t in fresh.history + fresh.vis_acc]
    load_state(fresh, path)
    assert [t.data_ptr() for t in fresh.history + fresh.vis_acc] == ptrs
    assert torch.equal(fresh.vis_acc[0], r.vis_acc[0])
    assert fresh.counters == r.counters
