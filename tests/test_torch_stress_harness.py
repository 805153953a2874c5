"""The port's concurrency stress harness (kubernetes_tpu_torch/tools/
stress.py, the counterpart of hack/stress.py — the KUBE_RACE analog, ref:
hack/test-go.sh:50) on the CPU: one short run per scheduler path must
converge clean, as tests/test_stress_harness.py holds the reference's.
Full sweeps run through kubernetes_tpu_torch/tools/stress.sh."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.mark.parametrize("mode", ["serial", "batch"])
def test_stress_harness_converges(mode):
    cmd = [sys.executable, "-m", "kubernetes_tpu_torch.tools.stress",
           "--seconds", "5", "--writers", "3"]
    if mode == "batch":
        cmd += ["--batch", "--device", "cpu"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env=_env())
    assert r.returncode == 0, f"stress {mode} failed:\n{r.stdout}\n{r.stderr}"
    assert "CLEAN" in r.stdout


def test_stress_batch_on_cuda_without_a_card_raises():
    """``--batch --device cuda`` (the default device) without a card
    raises before the cluster starts; it never moves to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.tools.stress",
         "--seconds", "1", "--batch"], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=_env())
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "CLEAN" not in r.stdout
