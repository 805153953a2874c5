"""The port's kube-scheduler binary against the JAX package's apiserver.

``python -m kubernetes_tpu_torch.cmd.scheduler ... --device cpu`` runs as a
subprocess under a launcher that refuses any import of ``jax`` or
``kubernetes_tpu``; the reference apiserver serves in this process. In
each mode — ``--algorithm tpu-batch`` (every pod created before the
start: one wave), ``--algorithm serial`` and the ``UnsupportedPolicy``
fallback of tpu-batch to serial — the port's final ``spec.host`` of every
pod must equal the reference ``scheduler_server``'s on an identical
second apiserver, and the serial oracle's (tolerance 0: host names).
The binary's debug server (``/metrics`` with the ``scheduler_wave_*``
family and ``compile_prewarm_ready 1`` under ``--prewarm``, ``/healthz``
JSON, ``/debug/pprof``, the span shard at ``/debug/trace`` and the
flight recorder's series at ``/debug/vars``), ``--solver-addr`` binding
through a port solverd process (and the deep ``/healthz`` degraded, not
down, once the daemon dies), ``--mesh on`` (exiting non-zero on a host
with one device, holding an eight-shard CPU mesh otherwise), and the
default ``--device cuda`` failing without a card are checked too.
"""

import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc

import pytest

from chip_smoke import _free_port, _http_get, _stop_process, _wait_http
from kubernetes_tpu.cmd import scheduler as ref_cmd
from kubernetes_tpu.cmd.apiserver import apiserver_server
from kubernetes_tpu.models.oracle import solve_serial
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport
from kubernetes_tpu_torch.cmd import scheduler as port_cmd
from kubernetes_tpu_torch.util import pprof
from test_torch_batch_solver import REF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the port's binary with jax and the reference package unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu")
loaded = [m for m in sys.modules if m.split(".")[0] in BAD]
if loaded:
    sys.exit("already imported: %r" % loaded)
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kube-scheduler"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.scheduler", run_name="__main__",
                 alter_sys=True)
"""

NEG_POLICY = json.dumps({
    "predicates": [{"name": "PodFitsPorts"}, {"name": "PodFitsResources"},
                   {"name": "MatchNodeSelector"}, {"name": "HostName"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": -1},
                   {"name": "ServiceSpreadingPriority", "weight": 2}]})


def _serve(fn, argv):
    """A *_server() in a thread -> (stop event, thread)."""
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=fn, args=(argv,),
                         kwargs={"ready": ready, "stop": stop}, daemon=True)
    t.start()
    assert ready.wait(30), f"{fn.__name__} never became ready"
    return stop, t


class Apiserver:
    def __init__(self):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.stop, self.thread = _serve(apiserver_server,
                                        ["--port", str(self.port)])
        self.client = Client(HTTPTransport(self.url))

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)


@pytest.fixture
def two_apiservers():
    a, b = Apiserver(), Apiserver()
    yield a, b
    a.close()
    b.close()


# -- the cluster, the same on both apiservers --------------------------------

def _nodes(k):
    return [k.node(f"n{i}", cpu_m=2000 + 1000 * (i % 3), mem=4 << 30,
                   labels={"zone": f"z{i % 2}"}) for i in range(6)]


def _residents(k):
    return [k.pod(f"r{i}", cpu_m=300, mem=256 << 20, host=f"n{i % 3}",
                  labels={"app": "web"}) for i in range(4)]


def _pending(k):
    return [k.pod(f"p{i:02d}", cpu_m=100 * (1 + i % 4),
                  mem=(64 << 20) * (1 + i % 3),
                  labels={"app": ("web", "db")[i % 2]},
                  host_ports=(8080,) if i % 5 == 0 else ())
            for i in range(18)]


def _services(k):
    return [k.svc("web", {"app": "web"}), k.svc("db", {"app": "db"})]


def _seed(apiserver):
    from test_torch_batch_solver import PORT
    c = apiserver.client
    for n in _nodes(PORT):
        c.nodes().create(n)
    for s in _services(PORT):
        c.services().create(s)
    residents = _residents(PORT)
    for p in residents:
        host = p.spec.host
        p.spec.host = ""
        p.status.host = ""
        c.pods().create(p)
        p.spec.host = p.status.host = host
    res = c.pods().bind_many(port_api.BindingList(items=[
        port_api.Binding(metadata=port_api.ObjectMeta(
            name=p.metadata.name, namespace="default"),
            pod_name=p.metadata.name, host=p.spec.host)
        for p in residents]))
    assert not any(r.error for r in res.items)


def _create_pending(apiserver):
    from test_torch_batch_solver import PORT
    for p in _pending(PORT):
        apiserver.client.pods().create(p)


def _placement(apiserver, timeout=60.0):
    """Wait until every pending pod is bound -> {name: host}."""
    names = {p.metadata.name for p in _pending(REF)}
    deadline = time.monotonic() + timeout
    while True:
        got = {p.metadata.name: p.spec.host
               for p in apiserver.client.pods().list().items
               if p.metadata.name in names}
        if len(got) == len(names) and all(got.values()):
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"pods still pending: "
                                 f"{sorted(n for n in names if not got.get(n))}")
        time.sleep(0.1)


def _oracle(policy_text=None):
    policy = ref_load_policy(policy_text) if policy_text else None
    hosts = solve_serial(_nodes(REF), _residents(REF), _pending(REF),
                         _services(REF), policy=policy)
    return {p.metadata.name: h for p, h in zip(_pending(REF), hosts)}


def _port_binary(args, stderr_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    err = open(stderr_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", LAUNCHER] + args,
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=err)
    err.close()
    return proc


def _wait_healthy(url, proc, timeout=60.0):
    return json.loads(_wait_http(url + "/healthz", proc, "the port's binary",
                                 timeout))


@pytest.fixture
def no_warm_start(monkeypatch):
    # the reference's tpu-batch binary would point JAX's persistent
    # compile cache into the checkout
    monkeypatch.setenv("KTPU_WARM_START", "off")


@pytest.mark.parametrize("mode", ["tpu-batch", "serial", "fallback"])
def test_port_binary_places_like_the_reference_binary(
        mode, two_apiservers, tmp_path, no_warm_start):
    ours, theirs = two_apiservers
    flags = {"tpu-batch": ["--algorithm", "tpu-batch", "--wave-period",
                           "0.5", "--prewarm"],
             "serial": ["--algorithm", "serial"],
             "fallback": ["--algorithm", "tpu-batch",
                          "--policy-config-file",
                          str(tmp_path / "policy.json")]}[mode]
    (tmp_path / "policy.json").write_text(NEG_POLICY)
    before = mode == "tpu-batch"   # one wave: every pod is there at start
    for a in (ours, theirs):
        _seed(a)
        if before:
            _create_pending(a)

    mport = _free_port()
    err = tmp_path / "stderr.txt"
    proc = _port_binary(["--master", ours.url, "--device", "cpu",
                         "--metrics-port", str(mport)] + flags, err)
    ref_stop = None
    try:
        ref_stop, ref_thread = _serve(ref_cmd.scheduler_server,
                                      ["--master", theirs.url] + flags)
        health = _wait_healthy(f"http://127.0.0.1:{mport}", proc)
        assert health["healthy"] is True and health["items"][0][
            "name"] == "binder"
        if not before:
            # the reflectors have listed nodes, services and residents
            time.sleep(1.0)
            for a in (ours, theirs):
                _create_pending(a)
        got, want = _placement(ours), _placement(theirs)
        assert got == want
        assert got == _oracle(NEG_POLICY if mode == "fallback" else None)

        metrics = _http_get(
            f"http://127.0.0.1:{mport}/metrics")[1].splitlines()
        if mode == "tpu-batch":
            assert "compile_prewarm_ready 1" in metrics
            assert any(m.startswith("scheduler_wave_solve_seconds_count ")
                       for m in metrics)
            assert "scheduler_loop_errors_total 0" not in metrics
        else:
            assert "scheduler_loop_errors_total 0" in metrics
            assert not any("scheduler_wave_" in m for m in metrics)
    finally:
        _stop_process(proc)
        if ref_stop is not None:
            ref_stop.set()
            ref_thread.join(timeout=10)
    text = err.read_text()
    # the line names the --algorithm flag, as the reference's does
    algorithm = "serial" if mode == "serial" else "tpu-batch"
    assert f"kube-scheduler running ({algorithm})" in text, text
    if mode == "fallback":
        assert "negative priority weight" in text
        assert "falling back to serial" in text


def test_debug_server_endpoints(two_apiservers, tmp_path):
    ours, _ = two_apiservers
    mport = _free_port()
    proc = _port_binary(["--master", ours.url, "--algorithm", "tpu-batch",
                         "--device", "cpu", "--metrics-port", str(mport)],
                        tmp_path / "stderr.txt")
    url = f"http://127.0.0.1:{mport}"
    try:
        _wait_healthy(url, proc)
        assert _http_get(url + "/healthz/ping") == (200, "ok")
        code, body = _http_get(url + "/metrics")
        assert code == 200
        for family in ("scheduler_wave_encode_seconds",
                       "scheduler_wave_solve_seconds",
                       "scheduler_wave_commit_seconds",
                       "scheduler_wave_pods_total"):
            assert f"# TYPE {family} " in body, family
        code, body = _http_get(url + "/debug/pprof/")
        assert code == 200 and "goroutine" in body
        code, body = _http_get(url + "/debug/pprof/goroutine")
        assert code == 200 and "tpu-batch-scheduler" in body
        assert _http_get(url + "/debug/pprof/bogus")[0] == 404
        # the first /debug/vars pull arms the flight recorder; a cursor
        # past every sample reads no series
        code, body = _http_get(url + "/debug/vars")
        fr = json.loads(body)
        assert code == 200 and fr["armed"] and fr["pid"] == proc.pid
        assert fr["service"] == "scheduler"
        assert "process_resident_bytes" in fr["series"]
        assert "scheduler_wave_pods_total" in fr["series"]
        code, body = _http_get(url + f"/debug/vars?since="
                                     f"{fr['t_ns'] + 10**13}")
        assert code == 200 and json.loads(body)["series"] == {}
        # tracing is off without --trace: an empty shard, not an error
        code, body = _http_get(url + "/debug/trace")
        shard = json.loads(body)
        assert code == 200 and shard["pid"] == proc.pid
        assert shard["spans"] == [] and shard["dropped"] == 0
        # a dead apiserver turns the deep health check to 503
        ours.close()
        code, body = _http_get(url + "/healthz")
        assert code == 503 and json.loads(body)["healthy"] is False
    finally:
        _stop_process(proc)


MESH_ON = ["--algorithm", "tpu-batch", "--device", "cpu", "--mesh", "on"]


@pytest.mark.parametrize("flags, shards", [
    (MESH_ON, 1),
    (MESH_ON, 8),
    (MESH_ON + ["--pods-axis", "4"], 8),
])
def test_unported_flags_exit_naming_their_roadmap_item(flags, shards,
                                                       monkeypatch, capsys):
    """``--mesh on`` as the reference's: it exits non-zero on a host with
    one device, and with eight CPU shards the wave loop holds the mesh
    (its "pods" axis from ``--pods-axis``)."""
    from kubernetes_tpu_torch.parallel import mesh as port_mesh
    monkeypatch.setattr(port_mesh, "default_devices",
                        lambda: [port_mesh.torch.device("cpu")] * shards)
    built = []
    stop = threading.Event()
    stop.set()
    if shards == 1:
        rc = port_cmd.scheduler_server(["--master", "http://127.0.0.1:1"]
                                       + flags, stop=stop,
                                       on_built=built.append)
        assert rc == 1 and not built
        assert ">1 device" in capsys.readouterr().err
        return
    master = Apiserver()
    try:
        rc = port_cmd.scheduler_server(["--master", master.url] + flags,
                                       stop=stop, on_built=built.append)
    finally:
        master.close()
    assert rc == 0
    pods = 4 if "--pods-axis" in flags else 1
    assert built[0]._mesh.shape == {"pods": pods, "nodes": 8 // pods}


def _solverd_process(port, stderr_path):
    """The port's cmd/solverd on ``port`` (the CPU), under the launcher
    that refuses jax and the reference package."""
    launcher = LAUNCHER.replace('"kube-scheduler"', '"kube-solverd"')
    launcher = launcher.replace("kubernetes_tpu_torch.cmd.scheduler",
                                "kubernetes_tpu_torch.cmd.solverd")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    err = open(stderr_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", launcher, "--port",
                             str(port), "--device", "cpu",
                             "--gather-window", "0.001"],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=err)
    err.close()
    deadline = time.monotonic() + 60
    while "kube-solverd listening" not in open(stderr_path).read():
        assert proc.poll() is None, open(stderr_path).read()
        assert time.monotonic() < deadline, "the daemon never listened"
        time.sleep(0.1)
    return proc


def _solver_item(url):
    code, body = _http_get(url + "/healthz")
    health = json.loads(body)
    items = {i["name"]: i for i in health["items"]}
    return code, health, items.get("solver")


def test_binary_binds_through_a_solverd_process(two_apiservers, tmp_path):
    """``--solver-addr``: the port's binary solves its wave on a port
    solverd process and places every pod as the reference binary does
    (in-process) and as the serial oracle does; the deep /healthz
    reaches the daemon."""
    ours, theirs = two_apiservers
    for a in (ours, theirs):
        _seed(a)
        _create_pending(a)
    dport, mport = _free_port(), _free_port()
    daemon = _solverd_process(dport, tmp_path / "solverd.txt")
    proc = None
    ref_stop = None
    try:
        proc = _port_binary(["--master", ours.url, "--device", "cpu",
                             "--algorithm", "tpu-batch", "--wave-period",
                             "0.5", "--solver-addr", f"127.0.0.1:{dport}",
                             "--solver-fallback", "requeue",
                             "--metrics-port", str(mport)],
                            tmp_path / "stderr.txt")
        ref_stop, ref_thread = _serve(ref_cmd.scheduler_server,
                                      ["--master", theirs.url, "--algorithm",
                                       "tpu-batch", "--wave-period", "0.5"])
        url = f"http://127.0.0.1:{mport}"
        _wait_healthy(url, proc)
        got, want = _placement(ours), _placement(theirs)
        assert got == want == _oracle()
        code, health, solver = _solver_item(url)
        assert code == 200 and health["healthy"] is True
        assert solver["status"] == "success"
        metrics = _http_get(url + "/metrics")[1].splitlines()
        assert any(m.startswith("scheduler_wave_solve_seconds_count ")
                   for m in metrics)
    finally:
        if proc is not None:
            _stop_process(proc)
        _stop_process(daemon)
        if ref_stop is not None:
            ref_stop.set()
            ref_thread.join(timeout=10)


def test_healthz_degraded_when_the_solverd_dies(two_apiservers, tmp_path):
    """A dead daemon is degraded, not down: /healthz stays 200 and
    healthy, with the solver item failing."""
    ours, _ = two_apiservers
    dport, mport = _free_port(), _free_port()
    daemon = _solverd_process(dport, tmp_path / "solverd.txt")
    proc = None
    try:
        proc = _port_binary(["--master", ours.url, "--device", "cpu",
                             "--algorithm", "tpu-batch", "--solver-addr",
                             f"127.0.0.1:{dport}", "--metrics-port",
                             str(mport)], tmp_path / "stderr.txt")
        url = f"http://127.0.0.1:{mport}"
        _wait_healthy(url, proc)
        assert _solver_item(url)[2]["status"] == "success"
        _stop_process(daemon)
        code, health, solver = _solver_item(url)
        assert code == 200 and health["healthy"] is True
        assert solver["status"] == "failure"
        assert health["items"][0]["name"] == "binder"
    finally:
        if proc is not None:
            _stop_process(proc)
        _stop_process(daemon)


def test_unported_flag_exits_nonzero_as_a_process(tmp_path):
    """``--mesh on`` on a host without more than one CUDA device (this
    one has none) exits non-zero, saying why."""
    err = tmp_path / "stderr.txt"
    proc = _port_binary(["--master", "http://127.0.0.1:1"] + MESH_ON, err)
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        _stop_process(proc)
    assert "--mesh on requires >1 device" in err.read_text()


def test_default_device_without_a_card_fails(two_apiservers, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ours, _ = two_apiservers
    err = tmp_path / "stderr.txt"
    proc = _port_binary(["--master", ours.url, "--algorithm", "tpu-batch"],
                        err)
    try:
        assert proc.wait(timeout=60) != 0
    finally:
        _stop_process(proc)
    assert "no CUDA device" in err.read_text()


def test_pipeline_with_serial_is_ignored(two_apiservers, tmp_path):
    ours, _ = two_apiservers
    err = tmp_path / "stderr.txt"
    proc = _port_binary(["--master", ours.url, "--pipeline"], err)
    try:
        deadline = time.monotonic() + 60
        while "kube-scheduler running (serial)" not in err.read_text():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        _stop_process(proc)
    assert "--pipeline requires --algorithm tpu-batch; ignoring" in \
        err.read_text()


def test_parser_takes_every_reference_flag_plus_device():
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = options(port_cmd.build_parser()), \
        options(ref_cmd.build_parser())
    assert ours - theirs == {"--device"}
    assert theirs <= ours
    opts = port_cmd.build_parser().parse_args(
        ["--algorithm_provider", "X", "--policy_config_file", "f",
         "--event_qps", "3", "--metrics_port", "9", "--pods_axis", "2"])
    assert (opts.algorithm_provider, opts.policy_config_file,
            opts.event_qps, opts.metrics_port, opts.pods_axis,
            opts.device, opts.algorithm) == ("X", "f", 3.0, 9, 2, "cuda",
                                             "serial")
    assert port_cmd.scheduler_server(["--algorithm", "bogus"]) == 2


def test_pprof_heap_profile_stops_tracing_after():
    was = tracemalloc.is_tracing()
    try:
        first = pprof.handle("heap")
        second = pprof.handle("heap")
        assert ("baseline" in first) != was
        assert "bytes live" in second
        assert "cpu profile" in pprof.cpu_profile(0.1)
        assert pprof.handle("nope") is None
    finally:
        if not was:
            tracemalloc.stop()
    assert tracemalloc.is_tracing() == was
