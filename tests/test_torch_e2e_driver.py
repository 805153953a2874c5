"""The e2e suite driver against a live standalone cluster of the port.

(i) The port's driver (kubernetes_tpu_torch/tools/e2e.py) with --up: the
twin of tests/test_e2e_driver.py — boot the port's standalone cluster,
run the nine suites over real HTTP (kubeconfig, kubectl processes, HTTP
watch streams), require every suite green.

(ii) The reference's own driver, hack/e2e.py, unchanged, with --master
pointed at the port's standalone solving each wave with --algorithm
tpu-batch --device cpu (the kernel's plain version): the reference's
suites hold the port's cluster. That driver resizes its RC with a bare
read and update, which races the replication manager's status write
(both packages write it after the deletes; ROADMAP Queue 3): when the
replication suite alone fails so, with 409's "has been modified", that
suite is run once more and must pass.
"""

import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    return dict(os.environ,
                PYTHONPATH=REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                   if os.environ.get("PYTHONPATH") else ""),
                JAX_PLATFORMS="cpu", **extra)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(240)
def test_e2e_driver_all_suites_pass(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.tools.e2e",
         "--up", "--port", str(_free_port())],
        capture_output=True, text=True, env=_env(), timeout=220,
        cwd=str(tmp_path))
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ALL SUITES PASSED" in out.stdout
    assert out.stdout.count("\nok   ") + out.stdout.startswith("ok   ") == 9


_RACE = "cannot be updated: the object has been modified"


def _reference_driver(master: str, cwd, timeout: float, *args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "hack", "e2e.py"),
         "--master", master, *args],
        capture_output=True, text=True, env=_env(), timeout=timeout,
        cwd=str(cwd))


def _only_the_resize_race(stdout: str) -> bool:
    fails = [ln for ln in stdout.splitlines() if ln.startswith("FAIL ")]
    return (len(fails) == 1 and fails[0].startswith("FAIL replication: ")
            and fails[0].endswith(_RACE))


@pytest.mark.timeout(240)
def test_reference_driver_passes_against_the_port_on_tpu_batch(tmp_path):
    port = _free_port()
    log = open(tmp_path / "standalone.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.standalone",
         "--port", str(port), "--nodes", "3", "--algorithm", "tpu-batch",
         "--device", "cpu"],
        env=_env(), cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT)
    try:
        master = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"{master}/healthz",
                                            timeout=1) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert proc.poll() is None, "the port's standalone exited"
            assert time.monotonic() < deadline, "standalone never healthy"
            time.sleep(0.2)
        out = _reference_driver(master, tmp_path, 140)
        if _only_the_resize_race(out.stdout):
            # the suite stopped at a resize: stop its RC as
            # kubectl does, then run the suite again
            from kubernetes_tpu_torch.client.client import Client
            from kubernetes_tpu_torch.client.http import HTTPTransport
            from kubernetes_tpu_torch.kubectl.scale import RCReaper
            RCReaper(Client(HTTPTransport(master))).stop("e2e", "e2e-rc")
            out = _reference_driver(master, tmp_path, 60, "--focus",
                                    "replication")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ALL SUITES PASSED" in out.stdout
