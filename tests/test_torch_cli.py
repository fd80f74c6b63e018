"""The port's command line (``python -m dc_sand_tpu_torch.cli``) against
the JAX package's on the CPU: ``run``'s and ``info``'s lines, the
checkpoint ``run --checkpoint`` writes, ``verify`` with ``--record``,
``bench`` and ``regress``; and verify's ``golden_ants`` and
``baseline_subset``, which grade the baselines the JAX verify grades."""

import json
import os

import numpy as np
import pytest
import torch

from dc_sand_tpu import cli as jax_cli
from dc_sand_tpu import verify as jax_verify
from dc_sand_tpu.config import get_config, scaled_for_test
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner
from dc_sand_tpu_torch import cli, golden
from dc_sand_tpu_torch import verify as port_verify
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.windows import pfb_window

RUN_PREFIXES = ("config=", "chunks=", "dump ")


def _lines(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("extra", [(), ("--batched",), ("--drop", "1"),
                                   ("--batched", "--drop", "1")])
def test_run_prints_what_the_jax_cli_prints(tmp_path, capsys, extra):
    """``run fx4 --chunks 4`` at 32 channels (a dump a chunk): the config,
    hash, counter and dump lines equal the JAX CLI's, and so does every
    array of the state each saves with ``--checkpoint``."""
    argv = ["run", "fx4", "--cpu", "--scale", "32", "--chunks", "4",
            *extra]
    got = _lines(capsys, cli.main,
                 argv + ["--checkpoint", str(tmp_path / "port")])
    want = _lines(capsys, jax_cli.main,
                  argv + ["--checkpoint", str(tmp_path / "jax")])
    pick = [ln for ln in got if ln.startswith(RUN_PREFIXES)]
    assert pick == [ln for ln in want if ln.startswith(RUN_PREFIXES)]
    assert len(pick) == 2 + 4
    assert got[-1] == f"state saved to {tmp_path / 'port.npz'}"
    assert want[-1] == f"state saved to {tmp_path / 'jax.npz'}"
    zp, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(zp.files) == set(zj.files)
    for key in zp.files:
        np.testing.assert_array_equal(zp[key], zj[key], err_msg=key)


def test_info_lists_the_configs_as_the_jax_cli(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = _lines(capsys, cli.main, ["info"])
    want = _lines(capsys, jax_cli.main, ["info"])
    assert got[0].startswith("card: none")
    assert got[1:] == want[1:] and len(got) == 6


def test_commands_need_a_card_without_cpu(monkeypatch):
    """Without ``--cpu`` a command runs on the card and raises without
    one; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["run", "fx4", "--scale", "32", "--chunks", "1"],
                 ["verify", "fx4", "--scale", "32"],
                 ["run", "fx4", "--mesh", "2", "--chunks", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert cli.main(["bench", "fx"]) == 1        # the entry's own refusal
    with pytest.raises(SystemExit):
        cli.main(["run", "fx4", "--cpu", "--stage2", "fp32"])


def test_verify_and_record(tmp_path, capsys):
    """``verify fx4`` at 32 channels on a (time 2, fx 2) CPU mesh: the JAX
    CLI's lines, PASS, and an SNR record in the directory named."""
    argv = ["verify", "fx4", "--cpu", "--scale", "32", "--time-shards", "2",
            "--mesh", "4"]
    got = _lines(capsys, cli.main, argv + ["--record", str(tmp_path)])
    want = _lines(capsys, jax_cli.main, argv)
    assert got[0].startswith("fx4:visibilities: ") and got[0].endswith(
        "[PASS]")
    assert got[:3] == want[:3]
    assert got[3].endswith("on cpu)") and "peak host memory" in got[3]
    rec, = os.listdir(tmp_path)
    assert rec.startswith("verify_fx4_") and got[-1].endswith(rec)
    r = json.loads((tmp_path / rec).read_text())
    assert r["value"] > 50 and r["extra"]["platform"] == "cpu"


def test_bench_runner_and_regress(tmp_path, capsys):
    """``bench runner`` (streaming ``run`` against ``run_batched``) hands
    its arguments to the bench entry; ``regress`` reads its records."""
    lines = _lines(capsys, cli.main, [
        "bench", "runner", "--cpu", "--scale", "32", "--spectra", "8",
        "--out", str(tmp_path)])
    recs = [json.loads(ln) for ln in lines]
    assert [r["name"] for r in recs] == ["runner_batched", "runner_streaming"]
    assert [r["extra"]["chunks_per_dispatch"] for r in recs] == [4, 1]
    assert all(r["value"] > 0 and r["extra"]["platform"] == "cpu"
               for r in recs)
    out = _lines(capsys, cli.main, ["regress", str(tmp_path)])
    assert sum("first recording" in ln for ln in out) == 2


# ---- verify's grading options ----------------------------------------------

def _perturb(run):
    """``run`` whose dumps carry an error that differs from baseline to
    baseline, so that the graded SNR depends on which baselines are
    graded (on the CPU both packages otherwise match golden exactly)."""
    def perturbed(self, *args, **kw):
        dumps, counters = run(self, *args, **kw)
        for d in dumps:
            vis = np.array(d.vis)
            n_bl = vis.shape[0]
            hit = np.arange(n_bl) * 7919 % 13 == 0     # 1 in 13
            vis[hit, ..., 0] += 300
            d.vis = vis
        return dumps, counters
    return perturbed


@pytest.mark.parametrize("option", [{"golden_ants": 12},
                                    {"baseline_subset": 40}])
def test_grading_options_grade_what_jax_grades(monkeypatch, option):
    """fx64's 64 antennas at 32 channels, dumps perturbed per baseline:
    the port's and the JAX verify give the same SNR keys and values
    within 0.5 dB for one seed, and another seed grades other baselines
    (its SNR moves by more than that)."""
    monkeypatch.setattr(JaxRunner, "run", _perturb(JaxRunner.run))
    monkeypatch.setattr(FXRunner, "run", _perturb(FXRunner.run))
    snrs = {}
    for seed in (0, 1):
        want, _ = jax_verify.verify_config("fx64", scale=32, n_chunks=2,
                                           seed=seed, **option)
        got, _ = port_verify.verify_config("fx64", scale=32, n_chunks=2,
                                           seed=seed, device="cpu", **option)
        assert got.keys() == want.keys() == {"visibilities"}
        assert abs(got["visibilities"] - want["visibilities"]) <= 0.5
        snrs[seed] = got["visibilities"]
    assert np.isfinite(snrs[0]) and abs(snrs[0] - snrs[1]) > 0.5


def test_golden_subset_copy_equals_the_jax_package():
    """The per-antenna golden chain (``ant_idx``) of the port's verify is
    the JAX verify's, bitwise."""
    cfg = scaled_for_test(get_config("fx4"), n_chans=32)
    stream = golden.gaussian_noise_int8((4, 2, 2 * cfg.chunk_samples),
                                        20.0, 3)
    dms = []
    for cls in (JaxDelayModel, DelayModel):
        dm = cls.zeros(4, 2, max_delay=8)
        dm.d0 = np.arange(8.0).reshape(4, 2)
        dm.d1 = np.full((4, 2), 1e-3)
        dms.append(dm)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    gains = np.full(cfg.n_chans, 0.05) + 0j
    sel = np.array([1, 3])
    np.testing.assert_array_equal(
        port_verify._golden_spectra(cfg, stream, dms[1], gains, 2, w,
                                    ant_idx=sel),
        jax_verify._golden_spectra(cfg, stream, dms[0], gains, 2, w,
                                   ant_idx=sel))


def test_grading_options_refusals():
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_verify.verify_config("fx4", scale=32, device="cpu",
                                  golden_ants=2, baseline_subset=3)
    with pytest.raises(ValueError, match="fx-mode"):
        port_verify.verify_config("beam64", scale=32, device="cpu",
                                  golden_ants=2)
