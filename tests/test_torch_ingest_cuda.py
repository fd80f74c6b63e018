"""The ingest on the card: pinned slots, the copy stream's hand-off and
slot release, the pinned dump, and the refusals that keep the device and
the pinning from being bypassed.  Imports no jax: the ``cuda`` cases run on
the card with ``python -m pytest --noconftest
tests/test_torch_ingest_cuda.py -m cuda``."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dc_sand_tpu_torch.bench import ingest_bench
from dc_sand_tpu_torch.config import ChainConfig
from dc_sand_tpu_torch.runtime import FXRunner
from dc_sand_tpu_torch.runtime.ingest import NativeIngest, multi_ingest_source
from dc_sand_tpu_torch.windows import pfb_window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (pinned slots, the copy stream)")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusals of a machine without a card")


def test_pinned_slots_without_a_card_raise(no_card):
    with pytest.raises(RuntimeError, match="CUDA device"):
        NativeIngest(1, 1, 64, pinned=True)
    assert not NativeIngest(1, 1, 64).pinned


@pytest.mark.parametrize("example", ["spead_loopback", "udp_observation"])
def test_examples_refuse_without_a_card(no_card, example):
    res = subprocess.run(
        [sys.executable, "-m", f"dc_sand_tpu_torch.examples.{example}"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0 and "PASS" not in res.stdout
    assert "no CUDA device" in res.stderr


@pytest.mark.cuda
def test_slots_are_pinned_and_the_chunk_lands(cuda):
    c = 1 << 16
    ing = NativeIngest(4, 2, c)
    assert ing.pinned
    x = np.random.default_rng(0).integers(-100, 100, (4, 2, 2 * c), np.int8)
    for a in range(4):
        for p in range(2):
            ing.submit(a, p, 0, x[a, p].tobytes())
    view, fill = ing.retire_view()
    assert fill == 1.0 and torch.from_numpy(view).is_pinned()
    assert np.array_equal(view, x[..., :c])
    ing.release()
    got = multi_ingest_source([ing], device=cuda)(1)
    assert got.is_cuda and np.array_equal(got.cpu().numpy(), x[..., c:])
    ing.close()


@pytest.mark.cuda
def test_a_slot_overwritten_after_release_leaves_the_chunk(cuda):
    """The source releases a slot only after its copy is done: writing
    over the slot the moment the source returns changes nothing on the
    card."""
    a, p, c = 16, 2, 1 << 20                 # 32 MB a chunk
    x = np.random.default_rng(1).integers(-100, 100, (a, p, c), np.int8)
    ings = [NativeIngest(a // 2, p, c) for _ in range(2)]
    for w, ing in enumerate(ings):
        for ai in range(a // 2):
            for pi in range(p):
                ing.submit(ai, pi, 0, x[w * (a // 2) + ai, pi].tobytes())
    src = multi_ingest_source(ings, device=cuda)
    got = src(0)
    for ing in ings:
        ptr, nbytes = ing._slots()[0]
        ctypes.memset(ptr, 0x55, nbytes)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy(), x)
    assert len(src.copy_ms) == 1 and src.copy_ms[0] > 0
    for ing in ings:
        ing.close()


@pytest.mark.cuda
def test_overlapped_feed_on_the_card_equals_the_cpu(cuda):
    x = np.random.default_rng(2).integers(-100, 100, (4, 2, 1 << 16),
                                          np.int8)
    delays = np.random.default_rng(3).integers(0, 33, (4, 2))
    out = {}
    for dev in ("cpu", cuda):
        feeder, ings, _ = ingest_bench.spead_feed(
            x, 4, n_workers=2, delays=delays, max_delay=32, device=dev)
        with feeder:
            out[str(dev)] = [feeder(i).cpu().clone() for i in range(4)]
        assert all(ing.pinned for ing in ings)   # a card is present
        for ing in ings:
            ing.close()
    for a, b in zip(*out.values()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_dump_goes_through_pinned_memory(cuda):
    cfg = ChainConfig(name="t", n_ants=4, n_pols=2, n_chans=64, n_taps=4,
                      spectra_per_chunk=16, n_spectra_per_acc=16,
                      run_xengine=True, apply_requant=True)
    x = torch.randint(-100, 100, (4, 2, cfg.chunk_samples),
                      dtype=torch.int8, device=cuda)
    runner = FXRunner(cfg, pfb_window(4, 128), device=cuda)
    dumps, _ = runner.run(lambda i: x, 2)
    assert len(dumps) == 2
    for d in dumps:
        assert torch.from_numpy(d.vis).is_pinned()
    assert dumps[0].vis.ctypes.data != dumps[1].vis.ctypes.data
    assert np.array_equal(dumps[0].vis, FXRunner(
        cfg, pfb_window(4, 128), device="cpu").run(
            lambda i: x.cpu(), 1)[0][0].vis)


_DOUBLE_REGISTER = r"""
import sys
sys.path.insert(0, sys.argv[1])
from dc_sand_tpu_torch.runtime.ingest import NativeIngest
slots = NativeIngest._slots
NativeIngest._slots = lambda self: slots(self)[:1] * 2
try:
    NativeIngest(2, 2, 1 << 16)
except RuntimeError as exc:
    assert "cudaHostRegister refused" in str(exc), exc
    NativeIngest._slots = slots
    assert NativeIngest(2, 2, 1 << 16).pinned
    print("raised")
"""


@pytest.mark.cuda
def test_an_unregistrable_slot_raises(cuda):
    """A slot the driver refuses to register (here: registered already)
    makes the constructor raise, after unregistering what it had; it never
    carries on pageable.  In a process of its own: the refusal leaves
    CUDA's last error set."""
    res = subprocess.run([sys.executable, "-c", _DOUBLE_REGISTER, REPO],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["raised"]
