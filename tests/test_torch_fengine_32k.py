"""The F-engine at M = 65536, the MeerKAT 32k-channel mode, where a
spectrum spans a cluster of 8 CTAs (``fengine_wide_kernel`` in
``csrc/fengine.cu``).

On the CPU: the kernel's arithmetic in its own decomposition
(``ops/fengine_fused.py:fengine_wide_torch``) against the benchmark's
float64 reference (``benchmark/reference.py``), ``FXRunner`` at 32768
channels against the same reference, and the wrapper's limits.  On the
card (marked ``cuda``): the kernel against the plain version at the 32k
cell's chunk in both layouts, and K1 at fx64's and beam64's shapes
bitwise the outputs the kernels gave before the 32k route was added.
No module here imports JAX: ``python -m pytest --noconftest
tests/test_torch_fengine_32k.py -m cuda`` runs the card's cases."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, reference, spec
from dc_sand_tpu_torch.ops.fengine_fused import (WIDE_FFT_SIZE,
                                                 check_fft_size,
                                                 fengine_fused,
                                                 fengine_fused_torch,
                                                 fengine_wide_torch)
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
from dc_sand_tpu_torch.windows import pfb_window

K = WIDE_FFT_SIZE // 2


def _certify_flips(got, want, pre):
    """int8 spectra ``got`` and ``want`` (..., 2) differ only by single-LSB
    flips where ``pre`` (the complex values ``got`` was rounded from) lies
    within 1e-3 of a .5 boundary; returns the flips' count."""
    diff = got.to(torch.int16) - want.to(torch.int16)
    assert int(diff.abs().max()) <= 1
    v = torch.stack([pre.real, pre.imag], -1).double()
    near = (v - torch.floor(v) - 0.5).abs() < 1e-3
    assert bool(near[diff != 0].all())
    return int((diff != 0).sum())


def _frames(rng, s, b, taps):
    m = WIDE_FFT_SIZE
    noise = lambda shape: torch.from_numpy(  # noqa: E731
        np.clip(np.rint(rng.normal(0, 20, shape)), -127, 127).astype(np.int8))
    return noise((s, taps_pad_for(taps), m)), noise((s, b, m))


@pytest.mark.parametrize("s,b,taps", [(2, 6, 16), (4, 2, 16), (3, 5, 4)])
def test_wide_arithmetic_matches_the_float64_reference(s, b, taps):
    """The kernel's decomposition (the FIR, the radix-16 pass across the
    cluster with its twiddles, the 2048-point plan, the split, the
    two-table phasor, the gain) in float32 is the float64 chain to within
    single-LSB flips at .5 boundaries."""
    rng = np.random.default_rng(100 * s + b)
    m = WIDE_FFT_SIZE
    hist, chunk = _frames(rng, s, b, taps)
    fd = torch.from_numpy(rng.uniform(-0.5, 0.5, (s, b)).astype(np.float32))
    ph = torch.from_numpy(rng.uniform(-np.pi, np.pi, (s, b)).astype(
        np.float32))
    mag = 16 / (20 * np.sqrt(np.sum(pfb_window(taps, m) ** 2) / 2))
    ang = rng.uniform(-np.pi, np.pi, K)
    gains = torch.from_numpy(np.stack([mag * np.cos(ang), mag * np.sin(ang)],
                                      -1).astype(np.float32))
    w = pfb_window(taps, m)
    got, pre = fengine_wide_torch(chunk, w, taps, K, history=hist,
                                  frac_delay=fd, phase=ph, gains=gains)
    pad0 = taps_pad_for(taps) - taps + 1
    seg = torch.cat([hist, chunk], 1)[:, pad0:].reshape(s, -1)
    re, im = reference.fengine(seg, w, taps, m, fd, ph, gains)
    flips = _certify_flips(got, torch.stack([re, im], -1), pre)
    assert flips <= 1e-4 * got.numel()
    assert float(got.float().std()) > 10     # requantised inside 8 bits


def _cfg32k(**kw):
    c = spec.config("fx64-32k")
    return harness.chain_config("fx64-32k", c).replace(**kw), c


def test_runner_at_32k_channels_matches_the_reference():
    """``FXRunner`` in fx mode at 32768 channels (2 antennas, 16-spectra
    chunks, a dump every 3): the spectra its F-engine computes (the port's
    plain version on the CPU) are the float64 reference's within
    single-LSB flips, and its dump is the reference's visibilities of
    those spectra, bitwise."""
    cfg, cs = _cfg32k(n_ants=2, spectra_per_chunk=16, n_spectra_per_acc=48)
    traffic = spec.traffic("stream")
    ins = inputs.make_inputs(11, traffic, cfg, cs["max_delay"], "cpu")
    runner = harness.build_runner(cfg, ins, traffic, device="cpu")
    dumps, _ = runner.run(lambda i: ins.ring[i % 4], 3)
    assert len(dumps) == 1 and dumps[0].first_chunk == 0
    m, b, s = cfg.fft_size, cfg.spectra_per_chunk, 4
    total, flips = None, 0
    for i in range(3):
        coarse, frac, phase = ins.delays.evaluate(i * cfg.chunk_samples, b, m)
        seg = reference.delayed_segment(ins.ring, i, torch.from_numpy(coarse),
                                        cs["max_delay"], cfg.n_taps, m)
        frames = seg.reshape(s, cfg.n_taps - 1 + b, m)
        hist = torch.cat([torch.zeros((s, 1, m), dtype=torch.int8),
                          frames[:, :cfg.n_taps - 1]], 1)
        fd, ph = (torch.from_numpy(x.reshape(s, b)) for x in (frac, phase))
        g = torch.from_numpy(ins.gains)
        port = fengine_fused_torch(frames[:, cfg.n_taps - 1:].contiguous(),
                                   ins.window, cfg.n_taps, K, history=hist,
                                   frac_delay=fd, phase=ph, gains=g)
        re, im = reference.fengine(seg, ins.window, cfg.n_taps, m, fd, ph, g)
        diff = (port.to(torch.int16)
                - torch.stack([re, im], -1).to(torch.int16)).abs()
        assert int(diff.max()) <= 1
        flips += int((diff > 0).sum())
        v = reference.visibilities(port[..., 0], port[..., 1], cfg.n_ants,
                                   cfg.n_pols)
        total = v if total is None else total + v
    assert flips <= 1e-4 * 3 * s * b * K
    got = torch.from_numpy(np.asarray(dumps[0].vis)).to(torch.int64)
    assert torch.equal(got, total)


def test_wrapper_takes_65536_and_refuses_past_it():
    """The kernels' sizes: M = 65536 (the cluster kernel) and the powers of
    two up to 8192 (the one-CTA kernel) pass the wrapper's check; 131072,
    the sizes between 8192 and 65536 and a size not a power of two are
    refused before any launch, and so is an unknown layout."""
    for m in (65536, 8192, 2048, 32):
        assert check_fft_size(m) is None
    for m in (131072, 16384, 32768, 65535, 16):
        with pytest.raises(ValueError, match="65536"):
            check_fft_size(m)
    x = torch.zeros((1, 1, WIDE_FFT_SIZE), dtype=torch.int8)
    with pytest.raises(ValueError, match="layout"):
        fengine_fused(x, np.ones(16 * WIDE_FFT_SIZE), 16, K,
                      layout="planar")


def _script(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,rows", [(64, 24), (512, 100), (256, 256)])
def test_blocked_control_dft_is_the_references(m, rows):
    """The control readings at 32k build ``reference._dft`` in row blocks
    (``scripts/readings_blocked_dft.py``): the same matrix, bitwise."""
    blocked = _script("readings_blocked_dft").dft_blocked
    assert torch.equal(blocked(m, m // 2, "cpu", rows),
                       reference._dft(m, m // 2, "cpu"))


def test_chip_smoke_phase_41_bound_is_the_cells():
    """``chip_smoke.py`` phase 41 times K1 at the 32k chunk against the
    bound of its tensors' bytes and its operations: the cell's
    ``k1_bound_s(128, 256, 65536, 16)``, 2.724 ms, bound by operations."""
    from benchmark import roofline
    from dc_sand_tpu_torch.bench.harness import bound_ms, fengine_flops
    s, b, m, taps = 128, 256, WIDE_FFT_SIZE, 16
    nbytes = (s * b * m + s * taps_pad_for(taps) * m + taps * m * 4
              + 2 * s * b * 4 + K * 2 * 4 + s * b * K * 2)
    ms, by = bound_ms(nbytes, fengine_flops(s * b, m, taps, rotate=True,
                                            quant=True))
    assert by == "operations"
    assert ms == pytest.approx(roofline.k1_bound_s(s, b, m, taps) * 1e3,
                               rel=1e-12)
    assert ms == pytest.approx(2.724, abs=5e-4)


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
@pytest.mark.parametrize("s,b,taps", [(128, 256, 16), (3, 13, 16),
                                      (1, 1, 4), (5, 40, 4)])
def test_wide_kernel_matches_plain(cuda, s, b, taps):
    """The M = 65536 kernel against the plain version: single-LSB flips in
    at most 1e-3 of the values, in the wire layout at the 32k cell's chunk
    (128 x 256), on ragged last tiles and on one spectrum; the operand
    layout at a pitch past B is ``wire_to_operand`` of the wire output
    bitwise, its pad zeros; the float output >= 100 dB from the plain."""
    from dc_sand_tpu_torch.utils import snr_db
    gen = torch.Generator(device=cuda)
    gen.manual_seed(s * 1000 + b)
    m = WIDE_FFT_SIZE
    hist = _noise(gen, (s, taps_pad_for(taps), m), cuda)
    chunk = _noise(gen, (s, b, m), cuda)
    fd = torch.rand((s, b), generator=gen, device=cuda) - 0.5
    ph = (torch.rand((s, b), generator=gen, device=cuda) - 0.5) * 6
    gains = torch.tensor([[0.02, 0.005]], device=cuda).expand(K, 2)
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32,
                        device=cuda)
    kw = dict(frac_delay=fd, phase=ph, gains=gains)
    got = fengine_fused(chunk, w, taps, K, history=hist, impl="cuda", **kw)
    flips = 0
    for lo in range(0, s, 16):     # the plain version 16 streams at a time
        hi = min(lo + 16, s)
        want = fengine_fused(chunk[lo:hi], w, taps, K, history=hist[lo:hi],
                             impl="torch", frac_delay=fd[lo:hi],
                             phase=ph[lo:hi], gains=gains)
        diff = (got[lo:hi].to(torch.int16) - want.to(torch.int16)).abs()
        assert diff.max().item() <= 1
        flips += int((diff > 0).sum())
    assert flips <= 1e-3 * got.numel()
    pitch = -(-b // 16) * 16 + 16
    op = fengine_fused(chunk, w, taps, K, history=hist, impl="cuda",
                       layout="operand", pitch=pitch, **kw)
    assert op.shape == (K, 2, s, pitch)
    assert torch.equal(op, wire_to_operand(got, pitch))
    assert not op[..., b:].any()
    if s <= 16:
        f = fengine_fused(chunk, w, taps, K, history=hist, impl="cuda",
                          frac_delay=fd, phase=ph)
        r = fengine_fused(chunk, w, taps, K, history=hist, impl="torch",
                          frac_delay=fd, phase=ph)
        g, r = f.double().cpu().numpy(), r.double().cpu().numpy()
        assert snr_db(r[..., 0] + 1j * r[..., 1],
                      g[..., 0] + 1j * g[..., 1]) >= 100


def _det(shape, salt, dev, span):
    """Integers in [-span, span] (int16) from a hash of the element index,
    the same on any card and PyTorch version; made a row of the first axis
    at a time."""
    out = torch.empty(shape, dtype=torch.int16, device=dev)
    n = out[0].numel()
    for r in range(shape[0]):
        i = torch.arange(r * n, (r + 1) * n, dtype=torch.int64, device=dev)
        h = (i * 2654435761 + salt * 40503) & 0xFFFFFFFF
        h = ((h ^ (h >> 15)) * 2246822519) & 0xFFFFFFFF
        h = h ^ (h >> 13)
        out[r] = (h % (2 * span + 1) - span).reshape(out[r].shape)
    return out


# sha256 of K1's outputs at fx64's chunk (128 x 2048 x 4096, operand at the
# pitch of 2048) and beam64's (128 x 256 x 4096) on _det's inputs, as the
# one-CTA kernels gave them before the 32k route was added to their source
# (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128, nvcc 12.9).  A
# regression check for that toolchain only: another nvcc may order the
# kernel's sums otherwise and change bytes of a still correct kernel,
# which the kernel-vs-plain tests judge.
PARENT_SHA256 = {
    ("fx64", "wire"):
        "b31e84b26abb59c72a8df3c55df409484070bf8859bcf5590c0b7a7c1cdc6355",
    ("fx64", "operand"):
        "c5c597d08ace73859522a792873292726baafc38413fe843ad55b8e7111c543a",
    ("beam64", "wire"):
        "a88fc5fb7a2ce352614a9a881607a34e1c38308d398655689798815d64b95f73",
    ("beam64", "operand"):
        "903c1bc0bdac2e646072678e4c1a7d1891292744655602e3c4389ea07f4d548c",
}


def k1_digests(dev) -> dict:
    """sha256 of K1's int8 outputs at fx64's and beam64's chunk shapes, in
    the layouts their cells run and the other, on :func:`_det`'s inputs."""
    out = {}
    k, m, taps, s = 4096, 8192, 16, 128
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32, device=dev)
    gains = (_det((k, 2), 7, dev, 1000).float() * 5e-5 + 0.04)
    for cell, b in (("fx64", 2048), ("beam64", 256)):
        hist = _det((s, taps_pad_for(taps), m), 1, dev, 40).to(torch.int8)
        chunk = _det((s, b, m), 2, dev, 40).to(torch.int8)
        fd = _det((s, b), 3, dev, 500).float() / 1000
        ph = _det((s, b), 4, dev, 3000).float() / 1000
        for layout in ("wire", "operand"):
            o = fengine_fused(chunk, w, taps, k, history=hist, frac_delay=fd,
                              phase=ph, gains=gains, layout=layout,
                              impl="cuda")
            torch.cuda.synchronize(dev)
            out[(cell, layout)] = hashlib.sha256(
                o.cpu().numpy().tobytes()).hexdigest()
    return out


@pytest.mark.cuda
def test_k1_at_fx64_and_beam64_is_bitwise_the_parents(cuda):
    """K1's one-CTA kernels, whose source the 32k route shares, give at
    fx64's and beam64's chunks in both layouts the bytes they gave before
    it was added, on the toolchain the digests were taken with (see
    ``PARENT_SHA256``): a same-toolchain regression check."""
    assert k1_digests(cuda) == PARENT_SHA256


@pytest.mark.cuda
def test_runner_at_32k_launches_only_the_cluster_route(cuda):
    """``FXRunner`` in fx mode at 32768 channels on the card (2 antennas,
    16-spectra chunks, a dump every 3): each chunk launches the cluster
    kernel and its operand transpose once, and neither the one-CTA K1 nor
    the unfused FIR (K6); the dump is the float64 reference's within the
    configuration's limit."""
    from dc_sand_tpu_torch.ops.pfb import pfb_fir
    cfg, cs = _cfg32k(n_ants=2, spectra_per_chunk=16, n_spectra_per_acc=48)
    traffic = spec.traffic("stream")
    ins = inputs.make_inputs(12, traffic, cfg, cs["max_delay"], cuda)
    runner = harness.build_runner(cfg, ins, traffic, device=cuda)
    before = (fengine_fused.wide_launches,
              fengine_fused.wide_operand_launches, fengine_fused.launches,
              fengine_fused.float_launches, pfb_fir.launches)
    dumps, _ = runner.run(lambda i: ins.ring[i % 4], 3)
    after = (fengine_fused.wide_launches,
             fengine_fused.wide_operand_launches, fengine_fused.launches,
             fengine_fused.float_launches, pfb_fir.launches)
    assert [a - b for a, b in zip(after, before)] == [3, 3, 0, 0, 0]
    (got,) = harness.check(cfg, ins, [(0, dumps[0])])
    assert got["vis_err"] <= cs["check_limits"]["vis_err"]
