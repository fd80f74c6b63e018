"""The control, the chain one precision step below the configuration's
(TF32 for its float32, benchmark/reference.py) in the program's place,
comes out not correct against the cells' limits, where the program comes
out correct: at a small size on the CPU, and at the cells' own size on
the card (``-m cuda``)."""

import time

import pytest
import torch

from benchmark import compare, harness, spec, stream

pytest.importorskip("dc_sand_tpu_torch")

# the smallest sizes at which a single flipped int8 value weighs well
# under the limits in a row (beam rows grow as antennas x channels)
SMALL = {"fx64": dict(n_ants=8, n_chans=512, spectra_per_chunk=32,
                      n_spectra_per_acc=128),
         "beam64": dict(n_ants=32, n_chans=1024, spectra_per_chunk=32)}


def _readings(name, seed, device, seconds, **small):
    cs = spec.config(name)
    cfg = harness.chain_config(name, cs).replace(**small)
    out = stream.run_cell(cfg, cs, spec.traffic("stream"), seed, seconds,
                          None, device, time.time())
    control = harness.worst(harness.check(
        cfg, out["inputs"], [(i, None) for i in out["answer_chunks"]],
        "tf32"))
    return out["readings"], control, cs["check_limits"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 77])
@pytest.mark.parametrize("name", ["fx64", "beam64"])
def test_control_fails_on_the_cpu(name, seed):
    program, control, limits = _readings(name, seed, "cpu", 0.2,
                                         **SMALL[name])
    assert compare.judge(program, limits)[0]
    assert not compare.judge(control, limits)[0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fx64", "beam64"])
def test_control_fails_at_the_cells_size(card, name):
    program, control, limits = _readings(name, 2 ** 31 + 3, card, 2.0)
    assert compare.judge(program, limits)[0]
    assert not compare.judge(control, limits)[0]
