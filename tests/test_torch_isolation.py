"""The port stands alone: no jax, nothing of kubernetes_tpu, vet-clean.

The test process itself imports jax (tests/conftest.py), so the import
check runs in a fresh interpreter.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "kubernetes_tpu_torch")


def _port_files():
    out = []
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods + ["chip_smoke"]


def test_walk_covers_the_scheduler_slice():
    mods = set(_modules())
    for m in ("api.labels", "api.errors", "api.meta", "runtime.clone",
              "watch", "util.retry", "util.metrics", "client.cache",
              "client.client", "client.record", "scheduler.driver",
              "scheduler.tpu_batch", "models.incremental",
              "tools.fake_cluster"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m.startswith('jaxlib')\n"
        "             or m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_port_sources_carry_no_reference_import():
    for path in _port_files() + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as fh:
            text = fh.read()
        for bad in ("import jax", "from jax", "import kubernetes_tpu\n",
                    "import kubernetes_tpu.", "from kubernetes_tpu."):
            assert bad not in text, f"{path}: {bad!r}"


def test_port_is_vet_clean():
    from kubernetes_tpu.analysis.engine import run_vet
    active, _waived = run_vet(
        paths=_port_files() + [os.path.join(ROOT, "chip_smoke.py")],
        root=ROOT)
    assert active == [], "\n".join(str(v) for v in active)


def test_default_device_without_cuda_raises():
    import torch

    from kubernetes_tpu_torch.models.batch_solver import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_build_without_nvcc_raises(monkeypatch):
    from kubernetes_tpu_torch.ops import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
