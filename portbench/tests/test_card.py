"""Runs on the card: one short run of each cell through
``portbench/run.py``. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import manifest


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["north_star.burst"])
def test_a_short_run_on_the_card_is_correct(name):
    _card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "3000000011", "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
