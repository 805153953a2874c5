"""The port stands alone: no jax, nothing of kubernetes_tpu, vet-clean.

The test process itself imports jax (tests/conftest.py), so the import
check runs in a fresh interpreter. The source check also refuses a module
name of the reference anywhere in the port or in chip_smoke.py — in a
string passed to ``python -m`` as much as in an import — so neither can
run the reference's code as a process either.
"""

import json
import os
import re
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
              "tools.fake_cluster", "runtime.serialize", "runtime.scheme",
              "api.latest", "client.http", "scheduler.predicates",
              "scheduler.priorities", "scheduler.listers",
              "scheduler.generic", "scheduler.plugins", "util.pprof",
              "probe", "cmd.scheduler", "util.tracing", "models.explain"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_apiserver_slice():
    mods = set(_modules())
    for m in ("capabilities", "version", "api.fields", "api.validation",
              "api.types", "api.quantity", "storage", "storage.memstore",
              "storage.helper", "registry", "registry.generic",
              "registry.resources", "admission", "admission.plugins",
              "auth", "auth.abac", "util.throttle", "util.chaos",
              "util.websocket", "ui", "ui.datafile", "apiserver",
              "apiserver.fairshed", "apiserver.master", "apiserver.http",
              "cmd.apiserver"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_storage_tier():
    mods = set(_modules())
    for m in ("storage.durable", "storage.remote", "storage.stripestore",
              "cmd.storeserver", "apiserver.share"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_controller_slice():
    mods = set(_modules())
    for m in ("cloudprovider", "cloudprovider.cloud",
              "cloudprovider.inventory", "cloudprovider.probe",
              "cloudprovider.locallb", "credentialprovider",
              "credentialprovider.keyring", "controllers",
              "controllers.util", "controllers.replication",
              "controllers.endpoints", "controllers.node",
              "controllers.namespace", "controllers.resourcequota",
              "controllers.manager", "cmd.controller_manager"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_kubectl_slice():
    mods = set(_modules())
    for m in ("api.v1beta1", "api.v1beta2", "client.clientauth",
              "client.clientcmd", "kubectl", "kubectl.cmd",
              "kubectl.describe", "kubectl.generators", "kubectl.printers",
              "kubectl.resource", "kubectl.scale", "util.stream",
              "cmd.kubectl", "cmd.version_change", "cmd.gendocs",
              "cmd.genman"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_kubelet_slice():
    mods = set(_modules())
    for m in ("descheduler", "descheduler.controller", "cmd.descheduler",
              "kubelet", "kubelet.config", "kubelet.envvars", "kubelet.gc",
              "kubelet.kubelet", "kubelet.pod_workers",
              "kubelet.process_runtime", "kubelet.runtime", "kubelet.server",
              "kubelet.stats", "kubelet.status", "volume", "volume.plugins",
              "cmd.kubelet", "cluster"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_service_slice():
    mods = set(_modules())
    for m in ("proxy", "proxy.config", "proxy.proxier", "proxy.roundrobin",
              "util.iptables", "cmd.proxy", "addons.dns", "addons.logging",
              "cmd.dns", "cmd.logging", "cmd.monitoring", "cmd.standalone",
              "cmd.hyperkube"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


def test_walk_covers_the_conformance_tools():
    mods = set(_modules())
    for m in ("tools.e2e", "tools.stress", "tools.vet"):
        assert f"kubernetes_tpu_torch.{m}" in mods, m


# each Python tool of the reference's hack/: its counterpart in the port,
# or the reason it has none
_BENCHMARK = "the measuring harness, for the port's benchmark PR"
_HACK_TOOLS = {
    "e2e.py": ("tools/e2e.py", "the e2e suite driver"),
    "stress.py": ("tools/stress.py", "the concurrency stress harness"),
    "vet.py": ("tools/vet.py", "the vet"),
    "embed-ui.py": ("ui/datafile.py", "the port's ui/datafile.py is "
                    "generated from the same www/"),
    "churn_mp.py": (None, _BENCHMARK),
    "perfgate.py": (None, _BENCHMARK),
    "fullgate.py": (None, _BENCHMARK),
    "storebench.py": (None, _BENCHMARK),
}


def test_every_hack_tool_has_its_counterpart_or_a_reason():
    hack = os.path.join(ROOT, "hack")
    assert sorted(f for f in os.listdir(hack) if f.endswith(".py")) == \
        sorted(_HACK_TOOLS)
    for tool, (counterpart, reason) in _HACK_TOOLS.items():
        assert reason
        if counterpart is not None:
            assert os.path.exists(os.path.join(PORT, counterpart)), tool


def test_every_reference_module_has_its_counterpart():
    """The tree comparison: each module of the reference has one under
    the port's own path, but the Pallas kernel's, whose counterpart is
    ``commit_solve`` (``ops/commit_solver.py`` and its CUDA sources)."""
    ref = os.path.join(ROOT, "kubernetes_tpu")
    missing = []
    for dirpath, dirnames, filenames in os.walk(ref):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), ref)
            if f.endswith(".py") and not os.path.exists(
                    os.path.join(PORT, rel)):
                missing.append(rel)
    assert missing == ["ops/pallas_solver.py"]
    assert os.path.exists(os.path.join(PORT, "ops", "commit_solver.py"))


# builds each binary of the kubelet slice from its flags, with jax and
# the reference package unimportable, then names the port's modules it
# loaded; the master it is given has nothing listening
_BINARIES = r"""
import importlib.abc, json, os, sys, tempfile
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"):
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
from kubernetes_tpu_torch.cmd import descheduler, kubelet
master = "http://127.0.0.1:9"
d = descheduler.build_descheduler(descheduler.build_parser().parse_args(
    ["--master", master, "--max-moves", "7"]))
assert d.config.defrag.max_moves == 7
root = tempfile.mkdtemp()
kl, pod_config, sources, server = kubelet.build_kubelet(
    kubelet.build_parser().parse_args(
        ["--api-servers", master, "--hostname-override", "n0",
         "--root-dir", root, "--port", "0",
         "--container-runtime", "process"]))
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("kubernetes_tpu_torch."))))
sys.stdout.flush()
os._exit(0)
"""


def test_kubelet_slice_binaries_build_without_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BINARIES], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    for m in ("descheduler.controller", "models.defrag", "kubelet.kubelet",
              "kubelet.process_runtime", "kubelet.server",
              "volume.plugins"):
        assert f"kubernetes_tpu_torch.{m}" in loaded, m


def test_kubectl_imports_no_torch_and_no_numpy():
    """kubectl runs as a process many times a session: its modules reach
    neither the models nor the kernels."""
    code = ("import sys\n"
            "import kubernetes_tpu_torch.cmd.kubectl\n"
            "import kubernetes_tpu_torch.cmd.version_change\n"
            "import kubernetes_tpu_torch.cmd.genman\n"
            "print(sorted(m for m in ('torch', 'numpy')\n"
            "             if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_conformance_tools_import_no_torch_and_no_numpy():
    """The e2e driver and the stress harness load no model at import:
    the driver is host code through and through, and the harness reaches
    the models only through the cluster it starts."""
    code = ("import sys\n"
            "import kubernetes_tpu_torch.tools.e2e\n"
            "import kubernetes_tpu_torch.tools.stress\n"
            "print(sorted(m for m in ('torch', 'numpy')\n"
            "             if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_host_binaries_import_no_torch_and_no_numpy(tmp_path):
    """kube-proxy, cluster-dns and cluster-logging are host code, and
    hyperkube's kubectl too: each builds what its binary runs (the
    master it is given has nothing listening) without reaching the
    models or the kernels."""
    code = (
        "import json, os, sys\n"
        "from kubernetes_tpu_torch.cmd import dns, hyperkube, logging, "
        "proxy\n"
        "from kubernetes_tpu_torch.addons.dns import DNSServer\n"
        "from kubernetes_tpu_torch.addons.logging import LogAggregator\n"
        "from kubernetes_tpu_torch.client.client import Client\n"
        "from kubernetes_tpu_torch.client.http import HTTPTransport\n"
        "master = 'http://127.0.0.1:9'\n"
        "proxier, svc, ep = proxy.build_proxy(proxy.build_parser()"
        ".parse_args(['--master', master]))\n"
        "client = Client(HTTPTransport(master))\n"
        "DNSServer(client)._sock.close()\n"
        "LogAggregator(client)._httpd.server_close()\n"
        "assert dns.build_parser().parse_args([]).port == 10053\n"
        "assert logging.build_parser().parse_args([]).port == 10252\n"
        "os.environ['KUBECONFIG'] = sys.argv[1]\n"
        "assert hyperkube.main(['kubectl', 'config', 'set-cluster', 'c', "
        "'--server=' + master]) == 0\n"
        "print(json.dumps(sorted(m for m in ('torch', 'numpy')\n"
        "                        if m in sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code,
                           str(tmp_path / "kubeconfig")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# series the storage tier and the worker fleet register: the vet's
# registry universe over the port holds each, so a gate may name it
_STORAGE_SERIES = ("store_wal_records_total", "store_wal_group_commits_total",
                   "store_recovery_seconds_bucket", "store_shard_ops_total",
                   "fairshed_ledger_backlog_depth",
                   "apiserver_cache_seed_published_total",
                   "apiserver_cache_seed_imported_total",
                   "apiserver_cache_seed_ring_drops_total")


def test_metrics_sync_sees_the_storage_series(tmp_path):
    from kubernetes_tpu_torch.analysis import run_vet
    for rel in ("util/metrics.py", "apiserver/http.py"):
        dst = tmp_path / "kubernetes_tpu_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(PORT, rel), dst)
    rules = tmp_path / "kubernetes_tpu_torch" / "addons" / "monitoring.py"
    rules.parent.mkdir(parents=True)
    names = [*_STORAGE_SERIES, "store_wal_frobs_total"]
    rules.write_text("def default_churn_rules(SLORule):\n    return [\n"
                     + "".join(f"        SLORule('r', {n!r}),\n"
                               for n in names) + "    ]\n")
    paths = [str(p) for p in tmp_path.rglob("*.py")]
    active, _ = run_vet(paths=paths, rule_ids=["metrics-sync"],
                        root=str(tmp_path))
    assert [v.message.split("'")[1] for v in active] == \
        ["store_wal_frobs_total"], active


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


# a module of the reference by name: "kubernetes_tpu.x" (never
# "kubernetes_tpu_torch.x"), or the bare package in an import
_REFERENCE_MODULE = re.compile(
    r"\bkubernetes_tpu\.[A-Za-z_]|(import|from)\s+kubernetes_tpu\b(?!_)")


def _shell_scripts():
    out = []
    for sub in ("deploy", "tools"):
        d = os.path.join(PORT, sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".sh")]
    return out


def test_port_sources_carry_no_reference_import():
    assert [os.path.basename(p) for p in _shell_scripts()] == [
        "inventory-up.sh", "local-up.sh", "multi-process-up.sh",
        "stress.sh", "test-cmd.sh"]
    for path in _port_files() + [os.path.join(ROOT, "chip_smoke.py")] \
            + _shell_scripts():
        with open(path) as fh:
            text = fh.read()
        for bad in ("import jax", "from jax"):
            assert bad not in text, f"{path}: {bad!r}"
        m = _REFERENCE_MODULE.search(text)
        assert m is None, f"{path}: {m.group(0)!r}"


@pytest.mark.parametrize("text,bad", [
    ('Popen([sys.executable, "-m", "kubernetes_tpu.cmd.apiserver"])', True),
    ("from kubernetes_tpu.api import types", True),
    ("import kubernetes_tpu", True),
    ("from kubernetes_tpu import watch", True),
    ('run_module("kubernetes_tpu_torch.cmd.apiserver")', False),
    ("from kubernetes_tpu_torch import watch", False),
    ("Port of ``kubernetes_tpu/apiserver/http.py``", False),
])
def test_reference_module_pattern(text, bad):
    assert (_REFERENCE_MODULE.search(text) is not None) is bad


def test_port_is_vet_clean():
    from kubernetes_tpu_torch.analysis import default_paths, run_vet
    paths = _port_files() + [os.path.join(ROOT, "chip_smoke.py")]
    assert sorted(default_paths(ROOT)) == sorted(paths)
    active, _waived = run_vet(paths=paths, root=ROOT)
    assert active == [], "\n".join(str(v) for v in active)


# A seeded violation of each rule the vet scopes to the package, on a
# port path: the port's vet flags it, the reference's (scoped to
# ``kubernetes_tpu/``) does not look at the file.
_SCOPED_FIXTURES = {
    "clone-mutation": {
        "kubernetes_tpu_torch/scheduler/assume.py":
            "from kubernetes_tpu_torch.runtime.clone import deep_clone\n"
            "def assume(pod, modeler):\n"
            "    cl = deep_clone(pod)\n"
            "    pod.status.phase = 'Assumed'\n"
            "    modeler.assume_pod(cl)\n"},
    "metrics-sync": {
        "kubernetes_tpu_torch/util/metrics.py":
            "def build(reg):\n"
            "    return reg.counter('solverd_frobs_total', 'frobs')\n",
        "kubernetes_tpu_torch/addons/monitoring.py":
            "def default_churn_rules(SLORule):\n"
            "    return [SLORule('frobs', 'solverd_frob_count_total')]\n"},
}


@pytest.mark.parametrize("rule", sorted(_SCOPED_FIXTURES))
def test_package_scoped_rules_fire_on_port_paths(rule, tmp_path):
    from kubernetes_tpu.analysis import run_vet as ref_run_vet
    from kubernetes_tpu_torch.analysis import run_vet
    paths = []
    for rel, text in _SCOPED_FIXTURES[rule].items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths.append(str(path))
    active, _ = run_vet(paths=paths, rule_ids=[rule], root=str(tmp_path))
    assert [v.rule for v in active] == [rule], active
    assert active[0].path.startswith("kubernetes_tpu_torch/")
    ref_active, _ = ref_run_vet(paths=paths, rule_ids=[rule],
                                root=str(tmp_path))
    assert ref_active == []


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
