"""The port stands without jax and without the JAX package, and its
kernels' wrappers never fall back.

Tests marked ``cuda`` hold each CUDA kernel to its plain version on the
card; on a machine without one they skip (``python3 chip_smoke.py``
covers the same ground at the production shapes)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.windows import pfb_window
from dc_sand_tpu_torch.ops._dispatch import resolve_impl
from dc_sand_tpu_torch.ops.beamform import beamform
from dc_sand_tpu_torch.ops.fengine_fused import fengine_fused
from dc_sand_tpu_torch.ops.pfb import pfb_fir, taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import xcorr_accumulate_a2
from dc_sand_tpu_torch.parallel import (all_to_all, build_mesh,
                                        ring_permute_right)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax..." now fails
sys.modules["dc_sand_tpu"] = None  # and any import of the JAX package
sys.path.insert(0, sys.argv[1])
import dc_sand_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dc_sand_tpu_torch.__path__,
                                               "dc_sand_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(" ".join(names))
"""

# the bench layer and its entry, the checkpoint, the command line, the
# ingest and its benches, the examples and the dry run, imported with the
# rest
BENCH_MODULES = ("bench", "bench.__main__", "bench.harness", "bench.probes",
                 "bench.kernels", "bench.pipelines", "bench.membench",
                 "bench.collectives", "bench.scaling", "bench.regress",
                 "runtime.checkpoint", "cli", "runtime.ingest",
                 "bench.ingest_bench", "examples", "examples.spead_loopback",
                 "examples.udp_observation", "examples.fx_observation",
                 "examples.observe", "examples.beams",
                 "examples.beam_pointing", "dryrun", "bench.fixtures",
                 "parallel.distributed", "parallel.ipc", "parallel.launch")


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX_IMPORT, REPO],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 55
    assert {f"dc_sand_tpu_torch.{m}" for m in BENCH_MODULES} <= names


def test_init_distributed_with_one_process_is_a_no_op():
    """Without a launcher's environment ``init_distributed`` joins no
    process group and answers with the JAX function's keys and, beside
    them, the node map: this process's node alone."""
    import torch.distributed as dist
    from dc_sand_tpu_torch.parallel import init_distributed
    from dc_sand_tpu_torch.parallel.distributed import node_name
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        info = init_distributed()
    finally:
        os.environ.update(env)
    assert set(info) == {"process_index", "process_count", "local_devices",
                         "global_devices", "nodes"}
    assert info["nodes"] == [node_name()]
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert info["global_devices"] == info["local_devices"] >= 1
    assert not dist.is_initialized()


def test_cuda_impl_on_cpu_tensors_raises():
    x = torch.zeros((2, 8, 64), dtype=torch.int8)
    h = torch.zeros((2, 8, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        resolve_impl("cuda", x)
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("pallas", x)
    assert resolve_impl("auto", x) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        fengine_fused(x, pfb_window(4, 64), 4, 32, history=h,
                      gains=torch.ones((32, 2)), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        xcorr_accumulate_a2(torch.zeros((3, 4, 4), dtype=torch.int32),
                            torch.zeros((3, 8, 16), dtype=torch.int8),
                            impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        beamform(torch.zeros((3, 2, 4, 8, 2), dtype=torch.int8),
                 torch.zeros((2, 3, 8, 2)), incoherent=True, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        pfb_fir(x, pfb_window(4, 64), 4, 64, history=h, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fengine_fused(x, pfb_window(4, 64), 4, 32, history=h, impl="cuda")
    mesh = build_mesh(["cpu"] * 2)
    for op in (all_to_all, ring_permute_right):
        with pytest.raises(ValueError, match="CUDA"):
            op([x, h], mesh, "fx", impl="cuda")


def test_mesh_never_falls_back_to_the_cpu():
    """A CUDA device that is not there raises; it is never replaced by the
    CPU, and a mesh never mixes CPU and CUDA shards."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA"):
        build_mesh([f"cuda:{n}"] * 4)
    with pytest.raises(ValueError, match="CUDA"):
        build_mesh(["cpu", "cuda:0"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel vs plain version)")
    return torch.device("cuda")


def _noise(gen, shape, dev):
    return torch.clamp(torch.round(torch.randn(shape, generator=gen,
                                               device=dev) * 20),
                       -127, 127).to(torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("taps,nch,b,s", [
    (4, 16, 5, 6), (4, 64, 16, 6), (16, 1024, 24, 6), (16, 4096, 19, 6),
    (4, 1024, 19, 6), (16, 1024, 256, 1), (16, 4096, 256, 6),
    (4, 4096, 2040, 6), (16, 4096, 19, 1), (16, 4096, 2040, 3)])
def test_fengine_kernel_matches_plain(cuda, taps, nch, b, s):
    """Kernel vs plain version: only single-LSB boundary flips, at most
    1e-3 of the values (the two FFTs sum in different orders), in both
    layouts; the operand layout is bitwise ``wire_to_operand`` of the wire
    output (M = 32 puts 64 sub-tiles in a CTA, B = 5 and 19 leave a
    ragged last tile; from M = 2048 the persistent CTAs walk several
    tiles each at B = 2040 and 256 and leave remainders, and one stream
    walks alone; the history's frames run into the chunk's)."""
    from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
    gen = torch.Generator(device=cuda)
    gen.manual_seed(taps)
    m = 2 * nch
    hist = _noise(gen, (s, taps_pad_for(taps), m), cuda)
    chunk = _noise(gen, (s, b, m), cuda)
    fd = torch.rand((s, b), generator=gen, device=cuda) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=cuda) - 0.5) * 6
    gains = torch.tensor([[0.05, 0.01]], device=cuda).expand(nch, 2)
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32,
                        device=cuda)
    kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)
    got = fengine_fused(chunk, w, taps, nch, impl="cuda", **kw)
    want = fengine_fused(chunk, w, taps, nch, impl="torch", **kw)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3
    op = fengine_fused(chunk, w, taps, nch, impl="cuda", layout="operand",
                       **kw)
    assert op.shape == (nch, 2, s, b) and torch.equal(op,
                                                      wire_to_operand(got))


@pytest.mark.cuda
@pytest.mark.parametrize("taps,nch,b", [(4, 64, 16), (16, 1024, 24),
                                        (4, 1024, 19), (16, 4096, 19),
                                        (16, 4096, 256)])
def test_fengine_float_kernel_matches_plain(cuda, taps, nch, b):
    """K1's float-output variant (no gains) vs the plain version, with and
    without the phasor, split I/O and one stream: >= 100 dB apart (both
    float32, the FFTs summed in different orders)."""
    from dc_sand_tpu_torch.utils import snr_db
    gen = torch.Generator(device=cuda)
    gen.manual_seed(taps + nch)
    s, m = 5, 2 * nch
    hist = _noise(gen, (s, taps_pad_for(taps), m), cuda)
    chunk = _noise(gen, (s, b, m), cuda)
    stream = _noise(gen, (s, (b + taps - 1) * m), cuda)
    fd = torch.rand((s, b), generator=gen, device=cuda) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=cuda) - 0.5) * 6
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32,
                        device=cuda)
    for x, kw in ((chunk, dict(history=hist, frac_delay=fd, phase=ph)),
                  (chunk, dict(history=hist)), (stream, {})):
        got = fengine_fused(x, w, taps, nch, impl="cuda", **kw)
        want = fengine_fused(x, w, taps, nch, impl="torch", **kw)
        assert got.dtype == torch.float32 and got.shape == (s, b, nch, 2)
        g, r = got.double().cpu().numpy(), want.double().cpu().numpy()
        assert snr_db(r[..., 0] + 1j * r[..., 1],
                      g[..., 0] + 1j * g[..., 1]) >= 100


@pytest.mark.cuda
@pytest.mark.parametrize("taps,m,b", [(16, 8192, 33), (16, 100, 21),
                                      (5, 64, 7), (1, 3, 1)])
def test_pfb_kernel_bitwise_equals_plain(cuda, taps, m, b):
    """K6 vs the plain version, split I/O and one stream, at odd B and M
    (M not a multiple of 4 takes the kernel's byte path): bitwise."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(taps * m + b)
    s = 3
    hist = _noise(gen, (2, s, taps_pad_for(taps), m), cuda)
    chunk = _noise(gen, (2, s, b, m), cuda)
    stream = _noise(gen, (s, (b + taps - 1) * m), cuda)
    w = torch.as_tensor(pfb_window(taps, m, "hann"), dtype=torch.float32,
                        device=cuda)
    for x, h in ((chunk, hist), (stream, None)):
        got = pfb_fir(x, w, taps, m, history=h, impl="cuda")
        want = pfb_fir(x, w, taps, m, history=h, impl="torch")
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("k,ap,b", [(3, 8, 16), (5, 72, 80), (4, 128, 256),
                                    (2, 1, 16), (3, 136, 16), (2, 160, 1040),
                                    (5, 128, 1040), (2, 130, 48)])
def test_cmac_kernel_bitwise_equals_plain(cuda, k, ap, b, keep):
    """Every unit kind of the kernel (``ops/xcorr.py:cmac_units``): one
    diagonal block (ap <= 128), rows and spectra past a block's or a
    stage's end, and ap > 128 (diagonal, upper and lower blocks); ap not a
    multiple of 4 (1, 130) stores element by element."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k * ap + b)
    a2 = torch.randint(-127, 128, (k, 2 * ap, b), generator=gen,
                       device=cuda, dtype=torch.int8)
    acc = torch.randint(-2**20, 2**20, (k, ap, ap), generator=gen,
                        device=cuda, dtype=torch.int32)
    got, want = acc.clone(), acc.clone()
    xcorr_accumulate_a2(got, a2, keep=keep, impl="cuda")
    xcorr_accumulate_a2(want, a2, keep=keep, impl="torch")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cmac_kernel_refuses_what_it_cannot_take(cuda):
    """B % 16 != 0 runs (the wrapper pads the operand with zero spectra),
    bitwise equal to the plain version and in one launch; an operand that
    is not 16-byte aligned raises before a launch; a misaligned
    accumulator is taken (element-wise stores)."""
    acc = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    for b in (24, 8):
        ragged = torch.randint(-127, 128, (2, 16, b), dtype=torch.int8,
                               device=cuda)
        launches = xcorr_accumulate_a2.launches
        got = xcorr_accumulate_a2(acc.clone(), ragged, keep=0, impl="cuda")
        assert xcorr_accumulate_a2.launches == launches + 1
        want = xcorr_accumulate_a2(acc.clone(), ragged, keep=0,
                                   impl="torch")
        assert torch.equal(got, want)
    flat = torch.ones(2 * 16 * 32 + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        xcorr_accumulate_a2(acc, flat[1:].view(2, 16, 32), impl="cuda")
    a2 = flat[:-1].view(2, 16, 32)
    big = torch.zeros((3, 8, 8), dtype=torch.int32, device=cuda)
    odd = big.view(-1)[1:1 + 2 * 64].view(2, 8, 8)   # 4-byte aligned only
    got = xcorr_accumulate_a2(odd, a2, keep=0, impl="cuda")
    want = xcorr_accumulate_a2(torch.zeros_like(acc), a2, keep=0,
                               impl="torch")
    assert torch.equal(got, want)

@pytest.mark.cuda
@pytest.mark.parametrize("qs", [0.0, 0.25])
@pytest.mark.parametrize("a,p,b,k,nb", [(3, 2, 37, 50, 1), (5, 1, 16, 64, 17),
                                        (64, 2, 256, 96, 16),
                                        (64, 2, 256, 4096, 16),
                                        (16, 2, 256, 1024, 16),
                                        (64, 2, 64, 256, 64),
                                        (9, 2, 70, 24, 4)])
def test_beam_kernel_matches_plain(cuda, a, p, b, k, nb, qs):
    """Tensor-core kernel vs plain version at the beam64 shape, at a mesh
    shard's 16 antennas, at 64 beams (four beam groups) and at ragged
    shapes (K not a multiple of the 16-channel tile or of 8, B not a
    multiple of the 64-spectra tile, antennas not a multiple of the
    8-antenna stage, one beam, a second beam group): float beams >= 100
    dB apart (exact products, float32 sums in different orders), int8
    beams within 1 LSB, the incoherent beam bitwise."""
    from dc_sand_tpu_torch.utils import snr_db
    gen = torch.Generator(device=cuda)
    gen.manual_seed(a * b + k)
    q = _noise(gen, (a, p, b, k, 2), cuda)
    w = torch.randn((nb, a, k, 2), generator=gen, device=cuda)
    got, inc = beamform(q, w, quant_scale=qs, incoherent=True, impl="cuda")
    want, inc_w = beamform(q, w, quant_scale=qs, incoherent=True,
                           impl="torch")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(inc, inc_w)
    if qs:
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3
    else:
        g, r = got.double().cpu().numpy(), want.double().cpu().numpy()
        assert snr_db(r[..., 0] + 1j * r[..., 1],
                      g[..., 0] + 1j * g[..., 1]) >= 100


@pytest.mark.cuda
def test_beam_runner_on_card_matches_cpu(cuda):
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import get_config, scaled_for_test
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    from dc_sand_tpu_torch.utils import snr_db
    cfg = scaled_for_test(get_config("beam64"), n_chans=256,
                          spectra_per_chunk=16)
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, 3 * cfg.chunk_samples), 20.0, 4)
    weights = np.random.default_rng(4).normal(
        size=(cfg.n_beams, cfg.n_ants, cfg.n_chans, 2)).astype(np.float32)
    c = cfg.chunk_samples
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    outs = []
    for dev in ("cpu", cuda):
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 3.0
        dm.p1 += 1e-6
        got = []
        FXRunner(cfg, w, delay_model=dm, weights=weights, device=dev).run(
            lambda i: stream[..., i * c:(i + 1) * c], 3,
            on_output=lambda i, o: got.append(
                {k_: v.cpu().numpy() for k_, v in o.items()}))
        outs.append(got)
    for a, b in zip(*outs):
        assert np.isfinite(b["beams"]).all()
        assert snr_db(a["beams"][..., 0] + 1j * a["beams"][..., 1],
                      b["beams"][..., 0] + 1j * b["beams"][..., 1]) > 60
        assert snr_db(a["incoherent"], b["incoherent"]) > 60


@pytest.mark.cuda
def test_runner_on_card_matches_cpu(cuda):
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import get_config, scaled_for_test
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    from dc_sand_tpu_torch.utils import snr_db
    cfg = scaled_for_test(get_config("fx4"), n_chans=256,
                          spectra_per_chunk=16).replace(n_spectra_per_acc=32)
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, 4 * cfg.chunk_samples), 20.0, 3)
    c = cfg.chunk_samples
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    dumps = []
    for dev in ("cpu", cuda):
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 3.0
        dm.p1 += 1e-6
        d, _ = FXRunner(cfg, w, delay_model=dm, device=dev).run(
            lambda i: stream[..., i * c:(i + 1) * c], 4)
        dumps.append(d)
    for a, b in zip(*dumps):
        assert (a.n_spectra, a.first_chunk) == (b.n_spectra, b.first_chunk)
        va = a.vis[..., 0] + 1j * a.vis[..., 1]
        vb = b.vis[..., 0] + 1j * b.vis[..., 1]
        assert snr_db(va, vb) > 60
    assert np.isfinite(dumps[1][0].vis).all()


def _card_mesh(n, time_shards=1):
    """n shards, shard i on cuda:(i mod the card count): every shard on one
    card, or spread over several."""
    return build_mesh([f"cuda:{i % torch.cuda.device_count()}"
                       for i in range(n)], time_shards=time_shards)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((8, 3, 5), torch.int8), ((4, 7), torch.float32), ((12, 33), torch.int8),
    ((4096, 2, 64), torch.int8)])
@pytest.mark.parametrize("n,time_shards", [(4, 1), (4, 2), (2, 1), (1, 1)])
def test_peer_copy_kernels_bitwise_equal_plain(cuda, shape, dtype, n,
                                               time_shards):
    """K7a and K7b (block mode) vs their plain versions over both axes of
    a mesh, at 16-byte and odd block sizes: bitwise; each launches once
    per card that holds a sender (on one card the 4-shard all-to-all or
    ring, or both rings of the (2, 2) mesh, is one launch)."""
    mesh = _card_mesh(n, time_shards)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + shape[0])
    xs = [(torch.randn(shape, generator=gen, device=cuda) * 50).to(dtype)
          .to(dev) for dev in mesh.flat_devices]
    for axis in ("fx", "time"):
        k = len(mesh.groups(axis)[0])
        for op, plain, ok in ((all_to_all, "all_to_all_torch",
                               shape[0] % k == 0),
                              (ring_permute_right, "ring_permute_right_torch",
                               True)):
            if not ok:
                continue
            from dc_sand_tpu_torch.parallel import remote_dma
            before = op.launches
            got = op(xs, mesh, axis, impl="cuda")
            want = getattr(remote_dma, plain)(xs, mesh, axis)
            torch.cuda.synchronize()
            cards = len({str(d) for d in mesh.flat_devices})
            assert op.launches - before == cards
            if op is ring_permute_right:
                assert len(mesh.ring_sends(axis)) == cards
            for g, w, x in zip(got, want, xs):
                assert g.device == x.device and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s_l,b", [(8, 3, 5), (64, 16, 32), (4096, 1, 3)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_all_to_all_corner_turn_mode_bitwise_equals_plain(cuda, n, k, s_l,
                                                          b):
    """K7b in its pitched corner-turn mode vs the plain version, n fx
    shards of operand-layout int8 ``(K, 2, s_l, b)`` (odd rows take the
    byte path, 16-byte rows the vector path), and the corner-turn built on
    it: bitwise, one launch a card."""
    from dc_sand_tpu_torch.parallel import (all_to_all_torch,
                                            corner_turn_all_to_all)
    mesh = _card_mesh(n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * k + b)
    xs = [torch.randint(-127, 128, (k, 2, s_l, b), generator=gen,
                        device=cuda, dtype=torch.int8).to(dev)
          for dev in mesh.flat_devices]
    rows = 2 * k // n
    before = all_to_all.launches
    got = all_to_all(xs, mesh, "fx", rows=rows, impl="cuda")
    want = all_to_all_torch(xs, mesh, "fx", rows=rows)
    torch.cuda.synchronize()
    assert all_to_all.launches - before == len(
        {str(d) for d in mesh.flat_devices})
    for g, w, x in zip(got, want, xs):
        assert g.device == x.device and torch.equal(g, w)
    a2 = corner_turn_all_to_all(xs, mesh)
    for g, w in zip(a2, want):
        assert torch.equal(g, w.reshape(k // n, 2 * n * s_l, b))


@pytest.mark.cuda
def test_sharded_runner_on_card_equals_one_device(cuda):
    """The fx runner on a 4-way fx mesh and on a (2, 2) SP mesh of the
    card(s) gives the one-device dumps bitwise, through K7b (and K7a in
    SP), each one launch a chunk and card."""
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.config import get_config, scaled_for_test
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    cfg = scaled_for_test(get_config("fx64"), n_chans=256,
                          spectra_per_chunk=32).replace(n_spectra_per_acc=64)
    stream = golden.gaussian_noise_int8(
        (cfg.n_ants, cfg.n_pols, 4 * cfg.chunk_samples), 20.0, 8)
    c = cfg.chunk_samples
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)

    def run(cfg_, **kw):
        dm = DelayModel.zeros(cfg.n_ants, cfg.n_pols, max_delay=8)
        dm.d0 += 5.0
        dm.p1 += 1e-6
        return FXRunner(cfg_, w, delay_model=dm, **kw).run(
            lambda i: stream[..., i * c:(i + 1) * c], 4)[0]

    ref = run(cfg, device=cuda)
    a2a, ring = all_to_all.launches, ring_permute_right.launches
    for cfg_, mesh in ((cfg, _card_mesh(4)),
                       (cfg.replace(time_shards=2), _card_mesh(4, 2))):
        got = run(cfg_, mesh=mesh)
        assert len(got) == len(ref) == 2
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.vis, b.vis)
    # one all-to-all and one ring launch a chunk and card that holds a
    # sender
    cards = min(4, torch.cuda.device_count())
    assert all_to_all.launches - a2a == 2 * 4 * cards
    assert ring_permute_right.launches - ring == 4 * cards
