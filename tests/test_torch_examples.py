"""The port's examples without ingest stay runnable and self-verifying on
the CPU: each prints PASS and exits 0, run as ``tests/test_examples.py``
runs the JAX package's originals (the ingest examples are run by
``tests/test_torch_ingest.py``)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("example", ["fx_observation", "observe", "beams",
                                     "beam_pointing"])
def test_example_passes_on_the_cpu(example):
    r = subprocess.run([sys.executable, "-m",
                        f"dc_sand_tpu_torch.examples.{example}", "--cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout


def test_examples_need_a_card_without_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m",
                        "dc_sand_tpu_torch.examples.observe"],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=env)
    assert r.returncode != 0
    assert "PASS" not in r.stdout and "no CUDA device" in r.stderr
