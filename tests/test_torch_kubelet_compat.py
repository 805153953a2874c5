"""The port's kubelet against the reference's.

- Each package's kubelet process (``--register-node --container-runtime
  process``) against the other package's kube-apiserver process: the
  same pods, bound to its node, reach Running as process groups under
  the pause sandbox, with the same status fields (phase, host, pod IP,
  conditions, each container's name, image, readiness, restarts and
  state), and stop again when deleted.
- A pod migrated from one kubelet's node to another's (the
  descheduler's migration binding), in process over each package's
  master: the source kubelet stops it, the target starts it, and its
  status is the target's.
- A source kubelet whose sync of a pod was under way when the pod was
  migrated, finishing after the target kubelet wrote its status: the
  reference's apiserver takes the late write, so the pod stays bound to
  the target with the source in ``status.host``; the port's refuses a
  status naming another host than the binding (409), and the target's
  status stands.
"""

import importlib
import os
import subprocess
import sys
import time

import pytest

from chip_smoke import (_free_port, _kill_runtime_procs, _runtime_procs,
                        _stop_process, _wait_http)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")

# runs the port's kubelet with jax and the reference package unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kubelet"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.kubelet",
                 run_name="__main__", alter_sys=True)
"""


def _mod(pkg, rel):
    return importlib.import_module(f"{pkg}.{rel}")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _status(pod) -> dict:
    st = pod.status
    return {
        "phase": st.phase, "host": st.host, "pod_ip": st.pod_ip,
        "conditions": sorted((c.type, c.status) for c in st.conditions),
        "containers": sorted(
            (cs.name, cs.image, cs.ready, cs.restart_count,
             cs.state.running is not None)
            for cs in st.container_statuses)}


def _pods(P):
    api, Q = P.api, P.Q
    return [api.Pod(
        metadata=api.ObjectMeta(name=f"w{k}", namespace="default",
                                labels={"app": "w"}),
        spec=api.PodSpec(containers=[api.Container(
            name="main", image=f"busybox:{k}", command=["sleep", "600"],
            env=[api.EnvVar(name="K", value=str(k))],
            resources=api.ResourceRequirements(limits={
                "cpu": Q("100m"), "memory": Q("32Mi")}))]))
        for k in range(3)]


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.api = _mod(name, "api.types")
        self.Q = _mod(name, "api.quantity").Quantity
        self.Client = _mod(name, "client.client").Client
        self.HTTP = _mod(name, "client.http").HTTPTransport


@pytest.mark.parametrize("server,kubelet_is_port", [
    ("kubernetes_tpu", True), ("kubernetes_tpu_torch", False),
], ids=["port-kubelet-ref-apiserver", "ref-kubelet-port-apiserver"])
def test_kubelet_runs_pods_on_the_other_apiserver(server, kubelet_is_port,
                                                  tmp_path):
    P = _Pkg(server)
    port = _free_port()
    root = os.path.realpath(str(tmp_path / "root"))
    log = open(tmp_path / "apiserver.log", "w")
    api_proc = subprocess.Popen(
        [sys.executable, "-m", f"{server}.cmd.apiserver", "--port",
         str(port)], cwd=ROOT, env=_env(), stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    url = f"http://127.0.0.1:{port}"
    kl = None
    try:
        _wait_http(url + "/healthz", api_proc, server, 60.0)
        head = ([sys.executable, "-c", LAUNCHER] if kubelet_is_port else
                [sys.executable, "-m", "kubernetes_tpu.cmd.kubelet"])
        klog = open(tmp_path / "kubelet.log", "w")
        kl = subprocess.Popen(
            head + ["--api-servers", url, "--hostname-override", "n0",
                    "--register-node", "--container-runtime", "process",
                    "--root-dir", root, "--port", str(_free_port()),
                    "--sync-frequency", "1"],
            cwd=ROOT, env=_env(), stdout=klog, stderr=subprocess.STDOUT)
        klog.close()
        c = P.Client(P.HTTP(url))
        _wait(lambda: [n.metadata.name for n in c.nodes().list().items]
              == ["n0"], "node registration")
        for pod in _pods(P):
            c.pods().create(pod)
            c.pods().bind(P.api.Binding(
                metadata=P.api.ObjectMeta(name=pod.metadata.name,
                                          namespace="default"),
                pod_name=pod.metadata.name, host="n0"))

        def running():
            pods = c.pods().list(label_selector="app=w").items
            return len(pods) == 3 and all(
                p.status.phase == "Running" and p.status.container_statuses
                and p.status.container_statuses[0].ready for p in pods)
        _wait(running, (tmp_path / "kubelet.log").read_text())
        got = {p.metadata.name: _status(p)
               for p in c.pods().list(label_selector="app=w").items}
        # a sandbox and a container process for each pod
        argv0 = sorted(a for _g, _c, a in _runtime_procs(root).values())
        assert argv0.count("sleep") == 3 and len(argv0) == 6
        for k in range(3):
            c.pods().delete(f"w{k}")
        _wait(lambda: not _runtime_procs(root), "the processes to stop")
    finally:
        if kl is not None:
            _stop_process(kl)
        _stop_process(api_proc)
        _kill_runtime_procs(root)
    want = {f"w{k}": {
        "phase": "Running", "host": "n0", "pod_ip": "127.0.0.1",
        "conditions": [("Ready", "True")],
        "containers": [("main", f"busybox:{k}", True, 0, True)]}
        for k in range(3)}
    assert got == want


def _two_kubelets(pkg):
    """An in-process master, two kubelets on FakeRuntimes (nodes a, b)
    with their apiserver sources, and a pod bound to a, Running there."""
    api = _mod(pkg, "api.types")
    Q = _mod(pkg, "api.quantity").Quantity
    client_mod = _mod(pkg, "client.client")
    kubelet = _mod(pkg, "kubelet")
    master = _mod(pkg, "apiserver.master").Master()
    c = client_mod.Client(client_mod.InProcessTransport(master))
    for n in ("a", "b"):
        c.nodes().create(api.Node(
            metadata=api.ObjectMeta(name=n),
            spec=api.NodeSpec(capacity={"cpu": Q("4"),
                                        "memory": Q("8Gi")})))
    c.pods().create(api.Pod(
        metadata=api.ObjectMeta(name="p", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(name="c",
                                                   image="img")])))
    c.pods().bind(api.Binding(metadata=api.ObjectMeta(
        name="p", namespace="default"), pod_name="p", host="a"))
    return api, c, kubelet


def _migrate(api, c, uid):
    res = c.pods().bind_many(api.BindingList(items=[api.Binding(
        metadata=api.ObjectMeta(name="p", namespace="default"),
        pod_name="p", host="b", from_host="a", pod_uid=uid)]))
    assert not res.items[0].error, res.items[0].error


def _live(runtime, uid):
    return [r for r in runtime.list_containers()
            if r.parsed and r.parsed[3] == uid]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_migrated_pod_moves_between_kubelets(pkg):
    api, c, kubelet = _two_kubelets(pkg)
    nodes = {}
    for n in ("a", "b"):
        rt = kubelet.FakeRuntime(ip_base=f"10.{9 + len(nodes)}.0.")
        kl = kubelet.Kubelet(n, rt, client=c, resync_period=0.2)
        cfg = kubelet.PodConfig()
        src = kubelet.ApiserverSource(cfg, c, n).run()
        kl.run(cfg)
        nodes[n] = (rt, kl, src)
    try:
        uid = c.pods().get("p").metadata.uid
        _wait(lambda: c.pods().get("p").status.phase == "Running"
              and _live(nodes["a"][0], uid), "Running on a")
        _migrate(api, c, uid)
        _wait(lambda: not _live(nodes["a"][0], uid), "stopped on a")
        _wait(lambda: len(_live(nodes["b"][0], uid)) == 2, "started on b")
        _wait(lambda: c.pods().get("p").status.pod_ip.startswith("10.10."),
              "b's status")
        pod = c.pods().get("p")
        assert (pod.spec.host, pod.status.host, pod.status.phase) == \
            ("b", "b", "Running")
    finally:
        for rt, kl, src in nodes.values():
            src.stop()
            kl.stop()


def test_a_late_status_write_of_the_source_kubelet():
    hosts = {}
    for pkg in PACKAGES:
        api, c, kubelet = _two_kubelets(pkg)
        rt_a, rt_b = (kubelet.FakeRuntime(ip_base="10.9.0."),
                      kubelet.FakeRuntime(ip_base="10.10.0."))
        kl_a = kubelet.Kubelet("a", rt_a, client=c)
        kl_b = kubelet.Kubelet("b", rt_b, client=c)
        pod_a = c.pods().get("p")
        uid = pod_a.metadata.uid
        start = rt_a.start_container

        def start_then_migrate(cid, start=start, api=api, c=c, uid=uid,
                               kl_b=kl_b):
            # a's sync is under way: the pod moves to b, whose kubelet
            # starts it and writes its status before a's sync ends
            start(cid)
            if rt_a.start_container is start_then_migrate:
                rt_a.start_container = start
                _migrate(api, c, uid)
                kl_b.sync_pods([c.pods().get("p")])
                assert kl_b.pod_workers.wait_idle()
                assert c.pods().get("p").status.host == "b"
        rt_a.start_container = start_then_migrate
        kl_a.sync_pods([pod_a])
        assert kl_a.pod_workers.wait_idle()
        pod = c.pods().get("p")
        hosts[pkg] = (pod.spec.host, pod.status.host)
        kl_a.stop()
        kl_b.stop()
    assert hosts == {"kubernetes_tpu": ("b", "a"),
                     "kubernetes_tpu_torch": ("b", "b")}
