"""The delay terms evaluated on the runner's device
(``ops/delay_terms.py``, ``csrc/delays.cu``) against the host's numpy
``DelayModel.evaluate_chunk``, bitwise:

* the plain version over epochs up to the traffic's 29 s of stream
  (5e10 samples), quadratic terms, coarse delays clipped at both ends of
  the budget, exact halves (rounded to even) and the chunk after an
  ``update()``;
* the runner: an ``update()`` and a replaced model each upload the
  coefficients once; fx dumps (both coarse modes, ``run`` and
  ``run_batched``) and beam chunks bitwise those of a runner fed the
  numpy tables.

Tests marked ``cuda`` hold the kernel to numpy at the runner's 128 rows
and check, under ``torch.profiler``, that a runner's chunks make no
pageable upload and no stream synchronise (``python -m pytest
--noconftest tests/test_torch_delay_terms.py -m cuda``)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from dc_sand_tpu_torch import golden
from dc_sand_tpu_torch.config import ChainConfig, get_config
from dc_sand_tpu_torch.ops.delay_terms import (COEFFICIENTS, delay_terms,
                                               delay_terms_torch)
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.windows import pfb_window

EPOCHS = (0, 2 ** 31, 50_000_000_000)
# the delay models of chip_smoke.py's phase 42, which holds the kernel to
# numpy on them on the card
_model = chip_smoke._delay_case
CASES = chip_smoke.DELAY_CASES
MAX_DELAY = chip_smoke.GATHER_MAX_DELAY


def _coef(dm: DelayModel, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.stack([
        np.asarray(getattr(dm, k), np.float64).reshape(-1)
        for k in COEFFICIENTS])).to(device)


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy()
        w = np.ascontiguousarray(w).reshape(g.shape)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("t0", EPOCHS)
@pytest.mark.parametrize("case", CASES)
def test_plain_terms_are_numpys(case, t0):
    """The plain float64 version gives ``evaluate_chunk``'s coarse,
    fractional and phase terms to the bit."""
    a, p, b, m = 16, 2, 64, 8192
    dm = _model(case, a, p, t0)
    want = dm.evaluate_chunk(t0, b, m)
    got = delay_terms(_coef(dm), float(t0 - dm.t_ref), b, m, dm.max_delay)
    _assert_bitwise(got, want)
    coarse = want[0]
    if case == "clip_low":
        assert (coarse == 0).any()
    if case == "clip_high":
        assert (coarse == MAX_DELAY).any()
    if case == "half_even":
        assert (coarse % 2 == 0).all() and (coarse > 0).any()


def test_refusals():
    coef = torch.zeros((6, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="coef"):
        delay_terms(coef.float(), 0.0, 8, 64, 8)
    with pytest.raises(ValueError, match="out"):
        delay_terms(coef, 0.0, 8, 64, 8,
                    out=(torch.zeros(4, dtype=torch.int32),
                         torch.zeros((4, 8)), torch.zeros((4, 7))))
    with pytest.raises(ValueError, match="impl"):
        delay_terms(coef, 0.0, 8, 64, 8, impl="cuda")


# ---- the runner -----------------------------------------------------------

def _fx_cfg():
    return ChainConfig(name="delays", n_ants=4, n_pols=2, n_chans=32,
                       n_taps=4, spectra_per_chunk=8, n_spectra_per_acc=16,
                       apply_delay=True, apply_requant=True,
                       run_xengine=True)


def _beam_cfg():
    return get_config("beam64").replace(n_ants=8, n_beams=4, n_chans=32,
                                        spectra_per_chunk=8,
                                        n_spectra_per_acc=8)


def _numpy_terms(runner):
    """The runner's delay terms as the numpy model computes them."""
    def terms(out=None):
        assert out is None
        b = runner.cfg.spectra_per_chunk
        c, f, p = runner.delay_model.evaluate_chunk(runner.t0, b,
                                                    runner.cfg.fft_size)
        return (torch.from_numpy(np.ascontiguousarray(c).reshape(-1)),
                torch.from_numpy(np.ascontiguousarray(f).reshape(-1, b)),
                torch.from_numpy(np.ascontiguousarray(p).reshape(-1, b)))
    return terms


def _drive(runner, src, batched=False):
    """Two chunks, an ``update()``, two chunks, a replaced model, two
    chunks; the dumps and the per-chunk outputs (copies)."""
    cfg = runner.cfg
    a, p = cfg.n_ants, cfg.n_pols
    rng = np.random.default_rng(5)
    dumps, outs = [], []

    def on_output(i, o):
        outs.append({k: v.clone() for k, v in o.items()})

    def two():
        if batched:
            dumps.extend(runner.run_batched(src, 2)[0])
        else:
            dumps.extend(runner.run(src, 2, on_output=on_output)[0])

    two()
    runner.delay_model.update(t_ref=runner.t0,
                              d0=rng.uniform(0, MAX_DELAY, (a, p)),
                              d2=rng.uniform(-1, 1, (a, p)) * 1e-9,
                              p2=rng.uniform(-1, 1, (a, p)) * 1e-8)
    two()
    runner.delay_model = _model("quadratic", a, p, runner.t0, seed=9)
    # coarse delays past both ends of the budget, clipped
    runner.delay_model.d0 = np.linspace(-4, MAX_DELAY + 4, a * p).reshape(
        a, p)
    two()
    return dumps, outs


def _runner(cfg, numpy_terms=False, **kw):
    rng = np.random.default_rng(3)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    dm = _model("drift", a, p, 0, seed=4)
    dm.d1 = rng.uniform(0.5, 1.0, (a, p)) / cfg.chunk_samples
    gains = np.stack([np.full(k, 0.05), rng.uniform(-0.01, 0.01, k)],
                     -1).astype(np.float32)
    weights = None
    if cfg.n_beams:
        weights = rng.normal(size=(cfg.n_beams, a, k, 2)).astype(np.float32)
    r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                 delay_model=dm, gains=gains, weights=weights, device="cpu",
                 **kw)
    if numpy_terms:
        r._delay_terms = _numpy_terms(r)
    return r


def _source(cfg, n=6):
    c = cfg.chunk_samples
    stream = golden.gaussian_noise_int8((cfg.n_ants, cfg.n_pols, n * c),
                                        20.0, 11)
    return lambda i: stream[..., i * c:(i + 1) * c]


@pytest.mark.parametrize("coarse_on_host", [True, False])
def test_fx_runner_is_the_numpy_tables_bitwise(coarse_on_host):
    """Dumps of ``run`` and of ``run_batched`` bitwise those of a runner
    fed ``evaluate_chunk``'s tables, across an ``update()`` and a replaced
    model, each of which uploads the coefficients once."""
    cfg = _fx_cfg()
    src = _source(cfg)
    want, _ = _drive(_runner(cfg, True, coarse_on_host=coarse_on_host), src)
    r = _runner(cfg, coarse_on_host=coarse_on_host)
    got, _ = _drive(r, src)
    assert r.counters.delay_uploads == 3
    rb = _runner(cfg, coarse_on_host=coarse_on_host)
    batched, _ = _drive(rb, src, batched=True)
    assert rb.counters.delay_uploads == 3
    assert len(got) == len(batched) == len(want) == 3
    for x, y, z in zip(got, batched, want):
        np.testing.assert_array_equal(x.vis, z.vis)
        np.testing.assert_array_equal(y.vis, z.vis)


def test_beam_runner_is_the_numpy_tables_bitwise():
    """Beam chunks bitwise those of a runner fed the numpy tables."""
    cfg = _beam_cfg()
    src = _source(cfg)
    _, want = _drive(_runner(cfg, True), src)
    r = _runner(cfg)
    _, got = _drive(r, src)
    assert r.counters.delay_uploads == 3
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_unchanged_model_uploads_once():
    """Chunks under one model upload its coefficients once; an edit in
    place of one coefficient uploads them again."""
    cfg = _fx_cfg()
    r = _runner(cfg)
    r.run(_source(cfg), 4)
    assert r.counters.delay_uploads == 1
    r.delay_model.p0[1, 0] += 1e-3
    r.run(_source(cfg), 2)
    assert r.counters.delay_uploads == 2


def test_epoch_alone_uploads_nothing():
    """A new epoch over the same coefficients uploads nothing: the epoch
    is an argument of each launch, and the terms follow it to the bit."""
    cfg = _fx_cfg()
    r = _runner(cfg)
    r.run(_source(cfg), 2)
    r.delay_model.t_ref = r.t0 - 12345
    got = r._delay_terms()
    assert r.counters.delay_uploads == 1
    _assert_bitwise(got, r.delay_model.evaluate_chunk(
        r.t0, cfg.spectra_per_chunk, cfg.fft_size))


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the delay-terms kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2048, 256])
@pytest.mark.parametrize("case", CASES)
def test_kernel_is_numpy_on_the_card(cuda, case, b):
    """The kernel at the runner's 128 rows and the fx64 / beam64 chunk,
    near the end of the traffic's 29 s of stream: numpy's bits."""
    t0 = 50_000_000_000 - 7 * 2 ** 31
    dm = _model(case, 64, 2, t0, seed=b)
    want = dm.evaluate_chunk(t0, b, 8192)
    n = delay_terms.launches
    got = delay_terms(_coef(dm, cuda), float(t0 - dm.t_ref), b, 8192,
                      dm.max_delay)
    torch.cuda.synchronize()
    assert delay_terms.launches == n + 1
    _assert_bitwise(got, want)
    plain = tuple(torch.empty_like(x) for x in got)
    delay_terms_torch(_coef(dm, cuda), float(t0 - dm.t_ref), b, 8192,
                      dm.max_delay, plain)
    _assert_bitwise(plain, want)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _inside(t, spans):
    return any(a <= t < b for a, b in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fx", "beam"])
def test_chunks_copy_and_wait_for_nothing(cuda, mode, tmp_path):
    """Under ``torch.profiler``, from a ring on the card, with an
    ``update()`` mid-stream: no pageable host-to-device copy and no
    stream synchronise inside a ``runner.chunk`` outside a
    ``runner.dump``, one delay-terms launch a chunk, one upload an
    update."""
    from torch.profiler import ProfilerActivity, profile
    base = get_config("fx64" if mode == "fx" else "beam64")
    cfg = base.replace(spectra_per_chunk=16, n_spectra_per_acc=64)
    a, p, k = cfg.n_ants, cfg.n_pols, cfg.n_chans
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    ring = [torch.randint(-100, 100, (a, p, cfg.chunk_samples),
                          generator=gen, device=cuda, dtype=torch.int8)
            for _ in range(3)]
    dm = _model("quadratic", a, p, 0)
    weights = (np.random.default_rng(2).normal(
        size=(cfg.n_beams, a, k, 2)).astype(np.float32)
        if cfg.n_beams else None)
    r = FXRunner(cfg, pfb_window(cfg.n_taps, cfg.fft_size, cfg.window),
                 delay_model=dm, weights=weights, device=cuda,
                 coarse_on_host=mode == "fx")

    def src(i):
        return ring[i % len(ring)]

    r.run(src, 4)              # warm-up: the kernels built, a dump
    torch.cuda.synchronize()
    n, uploads = delay_terms.launches, r.counters.delay_uploads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.run(src, 4)
        dm.update(t_ref=r.t0, p1=np.full((a, p), 1e-9))
        r.run(src, 4)
        torch.cuda.synchronize()
    assert delay_terms.launches == n + 8
    assert r.counters.delay_uploads == uploads + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = _events(path)

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in ev
                if e.get("name") == name and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]

    chunks, dumps = spans("runner.chunk"), spans("runner.dump")
    assert len(chunks) == 8
    assert len(dumps) == (2 if mode == "fx" else 0)

    def in_chunk(t):
        return _inside(t, chunks) and not _inside(t, dumps)

    pageable = {e["args"]["correlation"] for e in ev
                if e.get("ph") == "X" and "Pageable -> Device" in
                e.get("name", "") and "correlation" in e.get("args", {})}
    launched = [e["ts"] for e in ev
                if e.get("cat") == "cuda_runtime"
                and e.get("args", {}).get("correlation") in pageable]
    assert not [t for t in launched if in_chunk(t)]
    syncs = [e["ts"] for e in ev if e.get("name") == "cudaStreamSynchronize"]
    assert not [t for t in syncs if in_chunk(t)]
    assert any("delay_terms_kernel" in e.get("name", "") for e in ev)
