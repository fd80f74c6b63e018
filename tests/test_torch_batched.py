"""``FXRunner.run_batched``, the offline replay of one dump window a
dispatch: bitwise equal to ``run()`` (drops, a drifting delay model, on
one device and on an SP mesh), equal to the JAX ``run_batched`` on the
same numpy chunks, ``on_dump`` once a dump, and the JAX refusals.

Tests marked ``cuda`` run the window as one CUDA graph on the card:
equal to the loop bitwise, across a ``load_state`` between two calls,
and a capture that fails raises.  The JAX package is imported inside the
one test that needs it, so that the card tests run where jax is absent
(``python -m pytest --noconftest tests/test_torch_batched.py -m cuda``)."""

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch import golden
from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, load_state,
                                       save_state)
from dc_sand_tpu_torch.windows import pfb_window

MAX_DELAY = 8
G = 4                    # chunks a dump window


def _cfg(**kw):
    base = dict(name="batched", n_ants=4, n_pols=2, n_chans=32, n_taps=4,
                spectra_per_chunk=16, n_spectra_per_acc=16 * G,
                apply_delay=True, apply_requant=True, run_xengine=True)
    base.update(kw)
    return ChainConfig(**base)


def _inputs(cfg, n_chunks, seed):
    """``(src, gains, delay-model factory)``: numpy chunks and a drifting
    delay model (coarse changing chunk to chunk) from ``seed``."""
    rng = np.random.default_rng(seed)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    stream = golden.gaussian_noise_int8((a, p, n_chunks * c), 20.0, seed)
    gains = np.stack([np.full(cfg.n_chans, 0.05),
                      rng.uniform(-0.01, 0.01, cfg.n_chans)],
                     -1).astype(np.float32)
    d0 = rng.uniform(0.0, MAX_DELAY / 2, (a, p))
    d1 = rng.uniform(0.5, 1.0, (a, p)) / c
    p1 = rng.uniform(-1e-6, 1e-6, (a, p))

    def dm(cls=DelayModel):
        m = cls.zeros(a, p, max_delay=MAX_DELAY)
        m.d0, m.d1, m.p1 = d0.copy(), d1.copy(), p1.copy()
        return m

    return (lambda i: stream[..., i * c:(i + 1) * c]), gains, dm


def _runner(cfg, dm, gains, **kw):
    kw = kw or {"device": "cpu"}
    return FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                    delay_model=dm, gains=gains, **kw)


def _assert_dumps_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.n_spectra, a.n_spectra_nominal, a.first_chunk) == \
            (b.n_spectra, b.n_spectra_nominal, b.first_chunk)
        np.testing.assert_array_equal(a.vis, b.vis)


@pytest.mark.parametrize("time_shards,drops", [(1, (1, 6)), (2, (5,))])
def test_batched_equals_run_bitwise(time_shards, drops):
    """Two windows with dropped chunks, on one device and on a (time 2,
    fx 2) CPU mesh: the dumps, their metadata, ``on_dump``'s calls and
    the counters equal ``run()``'s."""
    cfg = _cfg(time_shards=time_shards)
    src, gains, dm = _inputs(cfg, 3 * G, seed=50)
    kw = ({"mesh": build_mesh(["cpu"] * 4, time_shards=2)}
          if time_shards > 1 else {})
    seen = {"run": [], "batched": []}
    ref = _runner(cfg, dm(), gains, **kw)
    want, wc = ref.run(src, 2 * G, on_dump=seen["run"].append,
                       drop_chunks=drops)
    r = _runner(cfg, dm(), gains, **kw)
    got, gc = r.run_batched(src, 2 * G, on_dump=seen["batched"].append,
                            drop_chunks=drops)
    _assert_dumps_equal(got, want)
    assert [d.n_spectra for d in got] == [
        16 * (G - sum(1 for i in drops if w * G <= i < (w + 1) * G))
        for w in range(2)]
    assert [id(d) for d in seen["batched"]] == [id(d) for d in got]
    assert len(seen["run"]) == 2
    assert gc == wc and r.t0 == ref.t0 and r.chunk_idx == ref.chunk_idx
    assert r.graph_replays == 0       # no graph on the CPU
    # run() after run_batched continues the stream
    more, _ = r.run(src, G)
    again, _ = ref.run(src, G)
    _assert_dumps_equal(more, again)


def test_batched_equals_the_jax_run_batched():
    """The port's and the JAX runner's ``run_batched`` on the same numpy
    chunks and delay model, with a drop: equal dumps and counters."""
    from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
    from dc_sand_tpu.runtime import FXRunner as JaxRunner
    cfg = _cfg()
    src, gains, dm = _inputs(cfg, 2 * G, seed=51)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    seen = []
    jr = JaxRunner(cfg, w, delay_model=dm(JaxDelayModel), gains=gains,
                   impl="auto")
    want, wc = jr.run_batched(src, 2 * G, on_dump=seen.append,
                              drop_chunks=(2,))
    got, gc = _runner(cfg, dm(), gains).run_batched(src, 2 * G,
                                                    drop_chunks=(2,))
    assert len(seen) == 2
    _assert_dumps_equal(got, [type(d)(vis=np.asarray(d.vis),
                                      n_spectra=d.n_spectra,
                                      n_spectra_nominal=d.n_spectra_nominal,
                                      first_chunk=d.first_chunk)
                              for d in want])
    assert (gc.chunks_in, gc.chunks_dropped, gc.samples_in, gc.spectra_out,
            gc.dumps) == (wc.chunks_in, wc.chunks_dropped, wc.samples_in,
                          wc.spectra_out, wc.dumps)


@pytest.mark.parametrize("case,match", [
    ("beam mode", "fx-mode only"),
    ("ragged window", "multiple of spectra_per_chunk"),
    ("unaligned chunks", "dump-aligned"),
    ("mid-window start", "dump boundary")])
def test_batched_refusals(case, match):
    """The JAX refusals: a mode other than fx, a window that is not a
    whole number of chunks, a chunk count that is not a whole number of
    windows, and a start away from a dump boundary."""
    cfg, n = _cfg(), G
    if case == "beam mode":
        cfg = _cfg(run_xengine=False, n_beams=2)
    elif case == "ragged window":
        cfg = _cfg(n_spectra_per_acc=40)
    elif case == "unaligned chunks":
        n = G + 1
    src, gains, dm = _inputs(cfg, 2 * G, seed=52)
    r = _runner(cfg, dm(), gains)
    if case == "mid-window start":
        r.run(src, 1)
    with pytest.raises(ValueError, match=match):
        r.run_batched(src, n)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA graph of a window)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_graph_equals_the_loop_on_the_card(cuda, fused):
    """Each window one replay of its captured steps (K1 or K6, and the
    CMAC, G of each a window): dumps bitwise equal to ``run()`` on the
    card, with drops."""
    cfg = _cfg(n_chans=256)
    src, gains, dm = _inputs(cfg, 3 * G, seed=53)
    want, _ = _runner(cfg, dm(), gains, device=cuda, fused=fused).run(
        src, 3 * G, drop_chunks=(1, 9))
    r = _runner(cfg, dm(), gains, device=cuda, fused=fused)
    got, _ = r.run_batched(src, 3 * G, drop_chunks=(1, 9))
    _assert_dumps_equal(got, want)
    assert r.graph_replays == 3
    k1 = "fengine" if fused else "pfb"
    assert r.graph_launches == {"fengine": 0, "pfb": 0, "cmac": G,
                                "coarse": 0, k1: G}


@pytest.mark.cuda
def test_load_state_between_two_batched_calls(cuda, tmp_path):
    """The graph holds the carries' addresses; ``load_state`` copies into
    them, so a runner that replays, loads another run's state and
    replays again continues that run bitwise with the same graph; a
    runner whose carries are replaced captures again."""
    cfg = _cfg(n_chans=256)
    src, gains, dm = _inputs(cfg, 4 * G, seed=54)
    ref = _runner(cfg, dm(), gains, device=cuda)
    want, _ = ref.run(src, 4 * G)
    other = _runner(cfg, dm(), gains, device=cuda)
    other.run(src, 2 * G)
    path = save_state(other, str(tmp_path / "state"))

    r = _runner(cfg, DelayModel.zeros(cfg.n_ants, cfg.n_pols, MAX_DELAY),
                gains, device=cuda)
    r.run_batched(src, G)
    graph = r._graph.graph
    load_state(r, path)
    got, _ = r.run_batched(src, 2 * G)
    assert r._graph.graph is graph and r.graph_replays == 3
    _assert_dumps_equal(got, want[2:])
    r.history = [h.clone() for h in r.history]
    r.vis_acc = [a.clone() for a in r.vis_acc]
    r.run_batched(src, 0)
    assert r._graph.graph is graph            # nothing replayed, nothing lost
    load_state(r, path)
    got, _ = r.run_batched(src, G)
    assert r._graph.graph is not graph        # captured on the new carries
    _assert_dumps_equal(got, want[2:3])


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A step that cannot be captured (a device-to-host copy inside it)
    makes ``run_batched`` raise; it never falls back to the loop, and no
    window is counted or dumped."""
    cfg = _cfg(n_chans=256)
    src, gains, dm = _inputs(cfg, G, seed=55)
    r = _runner(cfg, dm(), gains, device=cuda)
    step = r._step

    def uncapturable(*args):
        out = step(*args)
        args[1][0].sum().item()
        return out

    r._step = uncapturable
    dumps = []
    with pytest.raises(RuntimeError):
        r.run_batched(src, G, on_dump=dumps.append)
    assert r.graph_replays == 0 and not dumps and r.counters.dumps == 0
    torch.cuda.synchronize()
