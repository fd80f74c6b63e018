"""The port's bench layer (``dc_sand_tpu_torch/bench``) on the CPU.

The probes' plain versions are held bitwise to the TPU kernels of
``scripts/sweep_s10_micro.py`` run in the Pallas interpreter at shrunken
shapes; every bench runs at a tiny size on the CPU, its record tagged
``cpu`` and its byte and operation counts held to the JAX bench files'
formulas at the same shapes; the regression check keys its series as the
JAX one does; the entry refuses to run without a card.  Tests marked
``cuda`` hold the probe kernels to their plain versions on the card.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.bench import (collectives, harness, kernels, membench,
                                     pipelines, probes, regress, scaling)
from dc_sand_tpu_torch.bench.__main__ import headline, main as bench_main
from dc_sand_tpu_torch.bench.harness import (BenchResult, bound_ms,
                                             detect_chip, fengine_flops)
from dc_sand_tpu_torch.config import get_config
from dc_sand_tpu_torch.golden.chain import baseline_pairs
from dc_sand_tpu_torch.models.pipeline import make_step
from dc_sand_tpu_torch.parallel import build_mesh
from dc_sand_tpu_torch.runtime.runner import FXRunner
from dc_sand_tpu_torch.verify import verify_config
from dc_sand_tpu_torch.windows import pfb_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the probe script's globals, shrunk so the interpreter runs in a second
SMALL = dict(S=2, NB=3, TB=8, M=256, M2=4, K1N=16)


@pytest.fixture
def micro(monkeypatch):
    """``scripts/sweep_s10_micro.py`` loaded by path, its shape globals
    shrunk to :data:`SMALL` (its kernels read them when traced)."""
    spec = importlib.util.spec_from_file_location(
        "sweep_s10_micro", os.path.join(REPO, "scripts", "sweep_s10_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in SMALL.items():
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(mod, "NF", SMALL["NB"] * SMALL["TB"] + 15)
    return mod


def _jax_read(mod, x):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    read = pl.pallas_call(
        mod._read_kernel, grid=(mod.S, mod.NB),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda s_, b_: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int8),
        scratch_shapes=[pltpu.VMEM((2, mod.TB, mod.M), jnp.int8),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)
    return np.asarray(read(jnp.asarray(x)))


def _jax_write(mod):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    write = pl.pallas_call(
        mod._write_kernel, grid=(mod.S, mod.NB),
        out_specs=pl.BlockSpec((1, 2 * mod.M2, mod.TB, mod.K1N),
                               lambda s_, b_: (s_, 0, b_, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(
            (mod.S, 2 * mod.M2, mod.NB * mod.TB, mod.K1N), jnp.int8),
        interpret=True)
    return np.asarray(write())


def test_read_probe_plain_matches_the_tpu_kernel(micro):
    """The tile equals the Pallas read kernel's output bitwise; the block
    sums equal numpy's exact sums."""
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (micro.S, micro.NF, micro.M), dtype=np.int8)
    tile, sums = probes.read_probe_torch(torch.from_numpy(x), tb=micro.TB,
                                         nb=micro.NB)
    np.testing.assert_array_equal(tile.numpy(), _jax_read(micro, x))
    want = x[:, :micro.NB * micro.TB].astype(np.int64).reshape(
        micro.S, micro.NB, -1).sum(-1)
    assert sums.dtype == torch.int64
    np.testing.assert_array_equal(sums.numpy(), want)
    r0 = (micro.NB - 1) * micro.TB
    np.testing.assert_array_equal(tile.numpy(),
                                  x[micro.S - 1, r0:r0 + 8, :128])


def test_write_probe_plain_matches_the_tpu_kernel(micro):
    got = probes.write_probe(micro.S, micro.NB, micro.TB, micro.M2,
                             micro.K1N, device="cpu")
    want = _jax_write(micro)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_sums_are_exact_at_the_extremes():
    """Blocks of all -128 and all 127 sum exactly (int64, no wrap)."""
    x = torch.full((2, 40, 256), -128, dtype=torch.int8)
    x[1] = 127
    _, sums = probes.read_probe(x, tb=8, nb=5)
    assert sums.tolist() == [[-128 * 8 * 256] * 5, [127 * 8 * 256] * 5]


def test_probes_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 20, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="tb >= 8"):
        probes.read_probe(x, tb=4, nb=3)
    with pytest.raises(ValueError, match="nb \\* tb"):
        probes.read_probe(x, tb=8, nb=3)
    with pytest.raises(ValueError, match="int8"):
        probes.read_probe(x.float(), tb=8, nb=2)
    with pytest.raises(ValueError, match="1..128"):
        probes.write_probe(1, 129, 8, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        probes.read_probe(x, tb=8, nb=2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        probes.write_probe(1, 2, 8, 1, 16, device="cpu", impl="cuda")


def test_bench_result_and_chip_on_the_cpu(tmp_path):
    assert detect_chip("cpu") == "cpu"
    assert harness.HBM_BW_BY_CHIP["h100"] == 3350.0
    assert harness.HBM_BW_BY_CHIP["h200"] == 4800.0
    r = BenchResult(name="x", metric="m", value=2.5, unit="u", wall_s=0.1,
                    bytes_moved=1e6).finish("cpu", fp32_ops=10.0)
    d = json.loads(r.to_json())
    assert d["value"] == 2.5 and d["extra"]["platform"] == "cpu"
    assert d["extra"]["chip"] == "cpu" and d["extra"]["fp32_ops"] == 10.0
    # no device metric from a CPU run
    for key in ("pct_of_bound", "bound_ms", "achieved_gb_s", "fp32_gflops",
                "card"):
        assert key not in d["extra"]
    assert d["hbm_roofline_frac"] is None
    path = r.save(str(tmp_path / "recs"))
    assert os.path.basename(path).startswith("x_")
    with open(path) as f:
        assert json.loads(f.readline()) == d


def test_bounds_and_flop_counts():
    ms, by = bound_ms(3.35e9)                    # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = bound_ms(0, fp32_ops=67e9, int8_ops=1979e9)
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = bound_ms(0, fp32_ops=67e9, bf16_ops=989e9)
    assert by == "operations" and ms == pytest.approx(2.0)
    # beam64: 578.7 MB against 17.2 GFLOP on the tensor cores -> bytes
    ms, by = bound_ms(578.7e6, fp32_ops=4 * 64 * 2 * 256 * 4096,
                      bf16_ops=8 * 16 * 64 * 2 * 256 * 4096)
    assert by == "bytes" and ms == pytest.approx(0.1727, abs=1e-4)
    # 2*taps*M + 5 N log2 N + 16 N (+ 9 N phasor, + 6 N gain), N = M/2
    n = 4096
    per = 2 * 16 * 8192 + 5 * n * 12 + 16 * n
    assert fengine_flops(3, 8192, 16, False, False) == 3 * per
    assert fengine_flops(3, 8192, 16, True, True) == 3 * (per + 15 * n)
    assert fengine_flops(1, 8192, 16, True, True) == 634880


def test_time_cuda_on_the_cpu_uses_the_host_clock():
    calls = []
    s = harness.time_cuda(lambda: calls.append(1), warmup=2, iters=5,
                          device="cpu")
    assert len(calls) == 7 and 0 <= s < 1


@pytest.mark.parametrize("mode", ["native", "accumulate", "extract"])
def test_bench_xcorr_counts(mode):
    a, p, k, b = 4, 2, 16, 16
    r = kernels.bench_xcorr(n_ants=a, n_pols=p, n_chans=k, n_spectra=b,
                            iters=2, mode=mode, device="cpu")
    ap, n_bl = a * p, len(baseline_pairs(a))
    # the JAX file's accounting (dc_sand_tpu/bench/kernels.py)
    acc_bytes = 2 * k * ap * ap * 4
    out = acc_bytes if mode != "extract" else n_bl * p * p * k * 2 * 4
    assert r.bytes_moved == k * ap * b * 2 + out
    assert r.extra["int8_ops"] == 8 * k * ap * ap * b
    assert r.extra["platform"] == "cpu" and r.name == f"xcorr_cmac_{mode}"
    assert math.isfinite(r.value) and r.value > 0
    assert r.value == pytest.approx(n_bl * k * b / r.wall_s)


def test_bench_xcorr_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.bench_xcorr(n_ants=2, n_chans=4, n_spectra=16, iters=1,
                            mode="nope", device="cpu")


@pytest.mark.parametrize("quant_scale", [0.0, 0.25])
def test_bench_beamform_counts(quant_scale):
    nb, a, p, k, b = 4, 4, 2, 16, 8
    r = kernels.bench_beamform(n_beams=nb, n_ants=a, n_pols=p, n_chans=k,
                               n_spectra=b, iters=2, quant_scale=quant_scale,
                               device="cpu")
    assert r.bytes_moved == (a * p * b * k * 2 + nb * a * k * 2 * 4
                             + nb * p * b * k * 2 * (1 if quant_scale else 4))
    # the beam kernel's useful flops, 8 a complex MAC, run on the bf16
    # tensor cores and are bounded by their peak
    assert r.extra["bf16_ops"] == 4 * 2 * nb * a * p * b * k
    assert r.extra["fp32_ops"] == 0
    assert r.name == "beamform" + ("_int8" if quant_scale else "") + "_4b"
    assert r.extra["platform"] == "cpu" and r.value > 0
    with pytest.raises(ValueError, match="no native layout"):
        kernels.bench_beamform(layout="native", device="cpu")


def test_bench_fft_counts():
    # 32 channels: the smallest M (64 = 8 x 8) the matmul split takes
    rs = kernels.bench_fft(n_chans=32, n_streams=2, n_spectra=4, iters=2,
                           device="cpu")
    assert [r.name for r in rs] == ["fft_torch_rfft", "fft_mxu_matmul"]
    samples = 2 * 4 * 64
    for r in rs:
        assert r.bytes_moved == samples * 4 + samples // 2 * 8
        assert r.extra["fp32_ops"] == pytest.approx(5 * samples * 6)
        assert r.extra["impl"] == "torch" and r.value > 0


@pytest.mark.parametrize("impl", ["fused", "unfused"])
@pytest.mark.parametrize("full_chain", [True, False])
def test_bench_fengine_counts(impl, full_chain):
    s, b, k, taps = 2, 4, 16, 16
    r = pipelines.bench_fengine(n_streams=s, n_spectra=b, n_chans=k,
                                taps=taps, impl=impl, full_chain=full_chain,
                                iters=2, device="cpu")
    samples = s * b * 2 * k
    assert r.bytes_moved == samples + s * b * k * (2 if full_chain else 8)
    assert r.extra["fp32_ops"] == fengine_flops(s * b, 2 * k, taps,
                                                full_chain, full_chain)
    assert r.name == f"fengine_{'full' if full_chain else 'pfb'}_{impl}"
    assert r.extra["vs_array_realtime"] == pytest.approx(
        r.value / (128 * 1.712e9))
    assert r.extra["platform"] == "cpu"


def test_bench_steps_counts():
    a, p, k, b = 4, 2, 16, 16
    fx = pipelines.bench_fx_step(n_ants=a, n_chans=k, n_spectra=b, iters=2,
                                 device="cpu")
    samples = a * p * b * 2 * k
    assert fx.bytes_moved == samples + 2 * k * (a * p) ** 2 * 4
    assert fx.extra["int8_ops"] == 8 * k * (a * p) ** 2 * b
    assert fx.value == pytest.approx(samples / fx.wall_s)
    nb = 4
    bm = pipelines.bench_beam_step(n_ants=a, n_chans=k, n_spectra=b,
                                   n_beams=nb, iters=2, device="cpu")
    assert bm.bytes_moved == samples + (nb + 1) * p * b * k * 8
    for r in (fx, bm):
        assert r.extra["platform"] == "cpu" and math.isfinite(r.value)


@pytest.mark.parametrize("pattern", membench.PATTERNS)
def test_bench_membench_counts(pattern):
    r = membench.bench_membench(pattern, mb=1.0, iters=2, device="cpu")
    n = 250000 - 250000 % 1024
    want = {"copy": 8 * n, "triad": 8 * n, "int8_upcast": 20 * n,
            "transpose": 3 * 1024 * 1024 * 4}[pattern]
    assert r.bytes_moved == want and r.value > 0
    assert r.extra["platform"] == "cpu"


def test_bench_h2d_and_an_unknown_pattern():
    with pytest.raises(ValueError, match="unknown pattern"):
        membench.bench_membench("nope", device="cpu")
    r = membench.bench_h2d(mb=1.0, iters=2, device="cpu")
    assert r.bytes_moved == 1e6 and r.value > 0


def test_bench_probes_on_the_cpu():
    recs = probes.bench_probes(2, 3, 8, 256, 4, 16, iters=2, device="cpu")
    rd, wr = recs
    assert rd.bytes_moved == 2 * 3 * 8 * 256 + 8 * 128 + 2 * 3 * 8
    assert rd.extra["int8_ops"] == 2 * 3 * 8 * 256
    assert wr.bytes_moved == 2 * 8 * 24 * 16
    for r in recs:
        assert r.unit == "GB/s" and r.extra["platform"] == "cpu"
        assert r.extra["l2_flushed"] and r.extra["ms_back_to_back"] > 0
        assert r.extra["host_ms_per_call"] > 0


@pytest.mark.parametrize("op", collectives.COLLECTIVES)
def test_bench_collective_on_a_cpu_mesh(op):
    mesh = build_mesh(["cpu"] * 4)
    r = collectives.bench_collective(op, mesh, mb_per_chip=0.25, iters=2)
    local = 60 * 1024 * 4         # 0.25 MB of float32 rows of 1024, cut to 4
    want = {"all_to_all": local * 3 / 4, "all_to_all_pallas": local * 3 / 4,
            "ppermute": local, "ppermute_pallas": local,
            "psum": local * 2 * 3 / 4, "psum_scatter": local * 3 / 4,
            "all_gather": local * 3}[op]
    assert r.bytes_moved == want and r.value > 0
    assert r.extra["devices"] == 4 and r.extra["cards"] == 1
    assert r.extra["link"] == "host memory"
    with pytest.raises(ValueError, match="unknown collective"):
        collectives.bench_collective("nope", mesh)


def test_bench_scaling_on_cpu_devices():
    recs = scaling.bench_scaling(["cpu"] * 3, n_ants=4, chans_per_dev=16,
                                 spectra=16, iters=2)
    assert [r.extra["devices"] for r in recs] == [1, 2]
    assert recs[0].extra["efficiency_vs_1dev"] == 1.0
    assert [r.extra["n_chans"] for r in recs] == [16, 32]
    for r in recs:
        assert r.extra["platform"] == "cpu" and r.value > 0


def test_bench_scaling_refuses_an_implausible_sweep(monkeypatch):
    """A polluted one-device time is measured again; an efficiency that
    stays above 1.2 raises instead of being recorded."""
    walls = iter([10.0, 1.0, 1.0])     # 1 dev (polluted), 2 dev, 1 dev again
    monkeypatch.setattr(scaling, "_step_wall",
                        lambda cfg, mesh, iters: next(walls))
    recs = scaling.bench_scaling(["cpu"] * 2, n_ants=4, chans_per_dev=16)
    assert recs[0].wall_s == 1.0
    assert recs[1].extra["efficiency_vs_1dev"] == pytest.approx(1.0)
    monkeypatch.setattr(scaling, "_step_wall",
                        lambda cfg, mesh, iters: 1.0 if mesh.size == 1
                        else 0.1)
    with pytest.raises(RuntimeError, match="implausible"):
        scaling.bench_scaling(["cpu"] * 2, n_ants=4, chans_per_dev=16)


def _write(d, name, ts, value, extra=None):
    with open(os.path.join(d, f"{name}_abc_{ts}.json"), "w") as f:
        json.dump({"name": name, "metric": "m", "value": value, "unit": "u",
                   "wall_s": 1.0, "extra": extra or {}}, f)


def test_regress_detects_a_regression(tmp_path, capsys):
    d = str(tmp_path)
    _write(d, "k", 100, 10.0)
    _write(d, "k", 200, 8.0)          # -20%
    assert regress.main(d) == 1
    assert "REGRESSION" in capsys.readouterr().out
    _write(d, "k", 300, 10.0)
    assert regress.main(d) == 0
    assert "improved" in capsys.readouterr().out


def test_regress_never_compares_platforms(tmp_path, capsys):
    """An H100 row is never compared with a v5e row, nor with a CPU run or
    a card at another power limit."""
    d = str(tmp_path)
    _write(d, "k", 100, 100.0, {"chip": "v5e"})
    _write(d, "k", 200, 1.0, {"chip": "h100", "platform": "gpu",
                              "power_limit": "700.00 W"})
    _write(d, "k", 300, 0.5, {"chip": "h100", "platform": "gpu",
                              "power_limit": "500.00 W"})
    _write(d, "k", 400, 0.01, {"chip": "cpu", "platform": "cpu"})
    assert regress.main(d) == 0
    out = capsys.readouterr().out
    assert out.count("first recording") == 4
    assert "[h100 700.00 W]" in out and "[v5e]" in out and "[cpu]" in out
    keys = regress.load_results(d)[0]
    assert len(keys) == 4


def test_regress_rejects_implausible_records(tmp_path, capsys):
    d = str(tmp_path)
    _write(d, "k", 100, 10.0)
    _write(d, "k", 200, 5e6, {"efficiency_vs_1dev": 520.1})
    _write(d, "k", 300, 5e6, {"pct_of_bound": 3.0})
    assert regress.main(d) == 0
    out = capsys.readouterr().out
    assert out.count("REJECTED") == 2 and "520" in out
    assert regress.implausible({"value": 1.0, "wall_s": 1.0}) == ""


def test_regress_keys_shapes_apart(tmp_path):
    d = str(tmp_path)
    _write(d, "k", 100, 10.0, {"n_chans": 1024})
    _write(d, "k", 200, 1.0, {"n_chans": 4096})
    assert regress.main(d) == 0
    assert len(regress.load_results(d)[0]) == 2


def _verify_rec(d, series, commit, ts):
    with open(os.path.join(d, f"{series}_{commit}_{ts}.json"), "w") as f:
        json.dump({"name": series, "metric": "min stage SNR", "value": 60.0,
                   "unit": "dB", "wall_s": 1.0}, f)


def _git(*args):
    return subprocess.run(["git", *args], capture_output=True, text=True,
                          cwd=REPO).stdout.strip()


def test_verify_staleness_on_the_port_paths(tmp_path):
    """The port's kernel paths: a record at a commit before the port's
    bench layer is stale (later commits touch them); a record at the
    commit that last touched them is fresh; off unless asked."""
    assert all(p.startswith("dc_sand_tpu_torch/")
               for p in regress.KERNEL_PATHS)
    assert "dc_sand_tpu_torch/csrc" in regress.KERNEL_PATHS
    d = str(tmp_path)
    msgs = regress.verify_staleness(d)
    assert len(msgs) == len(regress.VERIFY_SERIES)
    assert all("NO verify record" in m for m in msgs)
    last = _git("log", "-1", "--format=%h", "--", *regress.KERNEL_PATHS)
    first = _git("log", "--format=%h", "--reverse", "--",
                 "dc_sand_tpu_torch/ops").split("\n")[0]
    if not last or not first:
        pytest.skip("no git history available")
    for series in regress.VERIFY_SERIES:
        _verify_rec(d, series, last, 100)
    assert regress.verify_staleness(d) == []
    _verify_rec(d, "verify_fx4", first, 200)       # newer record, old commit
    msgs = regress.verify_staleness(d)
    assert len(msgs) == 1 and msgs[0].startswith("verify_fx4:")
    _verify_rec(d, "verify_pfb1k", "ffffffff", 300)
    assert any("unknown" in m for m in regress.verify_staleness(d))
    _write(d, "k", 100, 1.0)
    assert regress.main(d) == 0                      # not checked unless
    assert regress.main(d, check_verify=True) == 1   # asked


def test_headline_on_the_cpu():
    """The entry's headline at a tiny size: one JSON-able line of finite
    numbers, tagged cpu, with no device metric."""
    line, recs = headline("cpu", n_chans=32, chans_1k=16, n_spectra=8,
                          fx_chans=16, fx_spectra=16, iters=6)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    json.dumps(line)
    ex = line["extra"]
    assert ex["platform"] == "cpu" and ex["card"] is None
    assert ex["pct_of_bound"] is None
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(
        line["value"] / (128 * 1.712e9))
    assert ex["fx_step_64ant"]["gsamp_s"] > 0
    assert ex["xcorr_baselines_per_s_64ant"]["mode"] == "native"
    assert [r.name for r in recs] == ["fengine_full_fused",
                                      "fengine_full_fused",
                                      "xcorr_cmac_native", "fx_step_64ant"]


def test_entry_target_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "recs")
    assert bench_main(["pfb", "--device", "cpu", "--scale", "16",
                       "--spectra", "8", "--impl", "unfused",
                       "--out", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["name"] == "fengine_pfb_unfused"
    assert rec["extra"]["platform"] == "cpu"
    assert len(os.listdir(out)) == 1


def test_entry_without_a_card_prints_no_json():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "dc_sand_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=env)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "no CUDA device" in res.stderr


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    """device=None is the current CUDA device: without a card the step,
    the runner and verify raise, and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("fx4")
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_step(cfg, w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FXRunner(cfg, w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_config("fx4", scale=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.detect_chip()
    assert callable(make_step(cfg, w, device="cpu"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel vs plain version)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,nf,m,nb,tb", [
    (probes.S, probes.NF, probes.M, probes.NB, probes.TB),   # the script's
    (3, 45, 200, 5, 9),      # ragged: rows not a multiple of 16 bytes
    (2, 30, 4096 + 16, 3, 8),
])
def test_read_probe_kernel_matches_plain(cuda, s, nf, m, nb, tb):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(s + m)
    x = torch.randint(-128, 128, (s, nf, m), generator=gen, device=cuda,
                      dtype=torch.int8)
    tile, sums = probes.read_probe(x, tb=tb, nb=nb, impl="cuda")
    tile_w, sums_w = probes.read_probe(x, tb=tb, nb=nb, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(tile, tile_w) and torch.equal(sums, sums_w)


@pytest.mark.cuda
@pytest.mark.parametrize("s,nb,tb,m2,k1n", [
    (probes.S, probes.NB, probes.TB, probes.M2, probes.K1N),
    (3, 5, 7, 3, 9),         # ragged: runs not a multiple of 16 bytes
    (1, 128, 8, 1, 16),
])
def test_write_probe_kernel_matches_plain(cuda, s, nb, tb, m2, k1n):
    got = probes.write_probe(s, nb, tb, m2, k1n, device=cuda, impl="cuda")
    want = probes.write_probe(s, nb, tb, m2, k1n, device=cuda, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
