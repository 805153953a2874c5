"""Each package's kubectl against the other's.

On one cluster seeded with numpy (nodes, pods with some bound, services,
replication controllers, priority classes and a pod's events), built in
each package's in-process ``Master`` from the same wire objects, both
packages' ``run_kubectl`` print the same text for ``get`` (human, json,
yaml, template and jsonpath output, in v1 and v1beta1), ``describe``
(pod, service, node, priority class) and ``api-versions``, with UIDs,
timestamps and ages normalized; and after the same ``create``,
``update``, ``label``, ``delete``, ``run-container``, ``expose``,
``resize``, ``stop``, ``rolling-update`` and ``cordon`` each store holds
the same objects (resourceVersions, UIDs and timestamps aside). A
kubeconfig that either package's ``kubectl config`` wrote loads in the
other to the same ``KubeConfig``; kube-version-change gives the same
output in both; gendocs and genman write the same trees (each into a
temporary directory, never the reference's ``docs/cli``).
"""

import dataclasses
import io
import json
import re
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.apiserver.master import Master as RefMaster
from kubernetes_tpu.client import clientcmd as ref_clientcmd
from kubernetes_tpu.client.client import Client as RefClient
from kubernetes_tpu.client.client import InProcessTransport as RefTransport
from kubernetes_tpu.cmd import gendocs as ref_gendocs
from kubernetes_tpu.cmd import genman as ref_genman
from kubernetes_tpu.cmd.version_change import version_change as ref_vc
from kubernetes_tpu.kubectl.cmd import Factory as RefFactory
from kubernetes_tpu.kubectl.cmd import run_kubectl as ref_run
from kubernetes_tpu.api.latest import scheme as ref_scheme
from kubernetes_tpu_torch.apiserver.master import Master as PortMaster
from kubernetes_tpu_torch.client import clientcmd as port_clientcmd
from kubernetes_tpu_torch.client.client import Client as PortClient
from kubernetes_tpu_torch.client.client import InProcessTransport as PortTransport
from kubernetes_tpu_torch.cmd import gendocs as port_gendocs
from kubernetes_tpu_torch.cmd import genman as port_genman
from kubernetes_tpu_torch.cmd.version_change import version_change as port_vc
from kubernetes_tpu_torch.kubectl.cmd import Factory as PortFactory
from kubernetes_tpu_torch.kubectl.cmd import run_kubectl as port_run
from kubernetes_tpu_torch.api.latest import scheme as port_scheme

SEED = 20261017
PKGS = {"ref": (RefMaster, RefClient, RefTransport, RefFactory, ref_run,
                ref_scheme),
        "port": (PortMaster, PortClient, PortTransport, PortFactory,
                 port_run, port_scheme)}
RESOURCES = ("nodes", "pods", "services", "replicationcontrollers",
             "priorityclasses", "events")


def _seed_wire(seed):
    """(resource, namespace, wire object) to create, then the binds."""
    rng = np.random.default_rng(seed)
    objs, binds = [], []
    for i in range(6):
        objs.append(("nodes", "", {
            "kind": "Node", "apiVersion": "v1",
            "metadata": {"name": f"n{i}",
                         "labels": {"zone": f"z{int(rng.integers(3))}"}},
            "spec": {"capacity": {"cpu": str(int(rng.choice([4, 8, 16]))),
                                  "memory": "32Gi"}}}))
    for name, value in (("pc-high", 1000), ("pc-low", -10)):
        objs.append(("priorityclasses", "", {
            "kind": "PriorityClass", "apiVersion": "v1",
            "metadata": {"name": name}, "value": value,
            "description": f"tier {name}"}))
    for i in range(10):
        app = f"app-{int(rng.integers(3))}"
        pod = {"kind": "Pod", "apiVersion": "v1",
               "metadata": {"name": f"p{i}", "namespace": "default",
                            "labels": {"app": app}},
               "spec": {"containers": [{
                   "name": "c", "image": f"img:{int(rng.integers(3))}",
                   "resources": {"limits": {
                       "cpu": f"{int(rng.choice([100, 250, 500]))}m",
                       "memory": "64Mi"}}}]}}
        if i % 3 == 0:
            pod["spec"]["priorityClassName"] = "pc-high"
        objs.append(("pods", "default", pod))
        if rng.random() < 0.6:
            binds.append((f"p{i}", f"n{int(rng.integers(6))}"))
    for s in range(3):
        objs.append(("services", "default", {
            "kind": "Service", "apiVersion": "v1",
            "metadata": {"name": f"s{s}", "namespace": "default"},
            "spec": {"port": 80 + s, "selector": {"app": f"app-{s}"}}}))
    for r in range(2):
        objs.append(("replicationcontrollers", "default", {
            "kind": "ReplicationController", "apiVersion": "v1",
            "metadata": {"name": f"rc{r}", "namespace": "default"},
            "spec": {"replicas": 2, "selector": {"rc": f"rc{r}"},
                     "template": {"metadata": {"labels": {"rc": f"rc{r}"}},
                                  "spec": {"containers": [{
                                      "name": "c", "image": "nginx"}]}}}}))
    objs.append(("events", "default", {
        "kind": "Event", "apiVersion": "v1",
        "metadata": {"name": "p1.fail", "namespace": "default"},
        "involvedObject": {"kind": "Pod", "name": "p1",
                           "namespace": "default"},
        "reason": "FailedScheduling", "source": {"component": "scheduler"},
        "message": "0/6 nodes available: 6 Insufficient cpu", "count": 1}))
    return objs, binds


class _Session:
    """One package's Master, client and kubectl over the seeded cluster."""

    def __init__(self, pkg):
        Master, Client, Transport, Factory, run, scheme = PKGS[pkg]
        self.master = Master()
        self.client = Client(Transport(self.master))
        self.scheme, self._run, self._factory = scheme, run, Factory
        objs, binds = _seed_wire(SEED)
        for resource, ns, wire in objs:
            self.client.resource(resource, ns).create(
                scheme.decode_from_wire(wire))
        api = type(self.client.pods("default").get("p0")).__module__
        types = __import__(api, fromlist=["Binding"])
        for pod, host in binds:
            self.client.pods("default").bind(types.Binding(
                pod_name=pod, host=host,
                metadata=types.ObjectMeta(namespace="default")))

    def kubectl(self, *argv, stdin=""):
        """-> (exit code, out, err); an exception that escapes
        ``run_kubectl`` (both packages let a few through) as its type
        and message in place of the code."""
        out, err = io.StringIO(), io.StringIO()
        f = self._factory(self.client, out=out, err=err,
                          stdin=io.StringIO(stdin) if stdin else None)
        try:
            rc = self._run(list(argv), f)
        except Exception as e:
            rc = f"raised {type(e).__name__}: {e}"
        return rc, out.getvalue(), err.getvalue()

    def state(self):
        """Every object of the seeded kinds as normalized v1 wire data."""
        out = {}
        for resource in RESOURCES:
            for obj in self.client.resource(resource, "").list().items:
                wire = json.loads(self.scheme.encode(obj, "v1"))
                meta = wire.get("metadata", {})
                for k in ("resourceVersion", "uid", "creationTimestamp"):
                    meta.pop(k, None)
                for k in list(wire):
                    if k.lower().endswith("timestamp"):
                        wire.pop(k)
                out[(resource, meta.get("namespace", ""),
                     meta["name"])] = wire
        return out


_NORM = [
    (re.compile(r"[0-9a-f]{20}-[0-9a-f]{12}"), "<uid>"),
    (re.compile(r"\d{4}-\d\d-\d\d[T ]\d\d:\d\d:\d\d(\.\d+)?(Z|\+00:00)?"),
     "<ts>"),
    (re.compile(r"(?<= )\d+[smhd](?=\s*$)", re.M), "<age>"),
]


def _norm(text):
    for pat, repl in _NORM:
        text = pat.sub(repl, text)
    return text


@pytest.fixture(scope="module")
def sessions():
    return _Session("ref"), _Session("port")


READS = [
    ("get", "pods"), ("get", "nodes"), ("get", "services"),
    ("get", "rc"), ("get", "priorityclasses"), ("get", "events"),
    ("get", "pods", "-o", "json"), ("get", "pods", "-o", "yaml"),
    ("get", "nodes", "-o", "json"),
    ("get", "pods", "-o", "template", "-t", "{metadata[name]}"),
    ("get", "pods", "-o", "jsonpath", "-t", "{.metadata.name} {.spec.host}"),
    ("get", "pods", "-l", "app=app-1"), ("get", "pods/p0", "pods/p3"),
    ("get", "pods", "--all-namespaces", "--no-headers"),
    ("--api-version", "v1beta1", "get", "pods", "-o", "json"),
    ("--api-version", "v1beta1", "get", "nodes", "-o", "yaml"),
    ("--api-version", "v1beta1", "get", "pods", "-o", "template", "-t",
     "{id} {currentState[status]}"),
    ("--api-version", "v1beta1", "get", "minions", "-o", "jsonpath", "-t",
     "{.id}"),
    ("--api-version", "v1beta2", "get", "services", "-o", "json"),
    ("describe", "pod", "p0"), ("describe", "pod", "p1"),
    ("describe", "service", "s0"), ("describe", "node", "n0"),
    ("describe", "priorityclass", "pc-high"), ("describe", "rc", "rc0"),
    ("api-versions",), ("version",), ("get", "bogus"),
    ("describe", "pod", "missing"), ("namespace",),
]


@pytest.mark.parametrize("argv", READS, ids=[" ".join(a) for a in READS])
def test_reads_print_the_same_text(sessions, argv):
    ref, port = sessions
    want, got = ref.kubectl(*argv), port.kubectl(*argv)
    assert (got[0], _norm(got[1]), _norm(got[2])) == \
        (want[0], _norm(want[1]), _norm(want[2]))
    assert want[1] or want[2]


def _settle_status(client, stop):
    """Stands in for the replication manager: each RC's status follows
    its spec (as tests/test_kubectl.py's rolling-update case does)."""
    while not stop.is_set():
        for rc in client.replication_controllers("default").list().items:
            if rc.status.replicas != rc.spec.replicas:
                rc.status.replicas = rc.spec.replicas
                try:
                    client.replication_controllers("default").update(rc)
                except Exception:
                    pass
        time.sleep(0.005)


def _writes(tmp_path):
    docs = tmp_path / "objs.json"
    docs.write_text(json.dumps({"kind": "List", "apiVersion": "v1beta1",
                                "items": [
        {"kind": "Pod", "apiVersion": "v1beta1", "id": "legacy-pod",
         "namespace": "default", "labels": {"app": "app-2"},
         "desiredState": {"manifest": {"version": "v1beta1",
                                       "containers": [{"name": "c",
                                                       "image": "i"}]}}},
        {"kind": "Service", "apiVersion": "v1", "metadata": {"name": "s9"},
         "spec": {"port": 90, "selector": {"app": "app-2"}}}]}))
    minion = tmp_path / "minion.json"
    minion.write_text(json.dumps(
        {"kind": "Minion", "apiVersion": "v1beta1", "id": "n9",
         "resources": {"capacity": {"cpu": "2", "memory": "4Gi"}}}))
    upd = tmp_path / "upd.json"
    upd.write_text(json.dumps(
        {"kind": "Service", "apiVersion": "v1beta2", "id": "s9",
         "namespace": "default", "port": 91, "selector": {"app": "app-1"},
         "labels": {"updated": "yes"}}))
    rc0 = tmp_path / "rc0.json"
    rc0.write_text(json.dumps(
        {"kind": "ReplicationController", "apiVersion": "v1beta2",
         "id": "rc0", "namespace": "default", "labels": {"updated": "yes"},
         "desiredState": {"replicas": 3, "replicaSelector": {"rc": "rc0"},
                          "podTemplate": {
                              "labels": {"rc": "rc0"},
                              "desiredState": {"manifest": {
                                  "version": "v1beta2", "containers": [
                                      {"name": "c", "image": "nginx"}]}}}}}))
    v2 = tmp_path / "rc1-v2.json"
    v2.write_text(json.dumps(
        {"kind": "ReplicationController", "apiVersion": "v1",
         "metadata": {"name": "rc1-v2"},
         "spec": {"replicas": 2, "selector": {"rc": "rc1-v2"},
                  "template": {"metadata": {"labels": {"rc": "rc1-v2"}},
                               "spec": {"containers": [{
                                   "name": "c", "image": "nginx:2"}]}}}}))
    return [
        ("create", "-f", str(docs)), ("create", "-f", str(minion)),
        ("update", "-f", str(upd)), ("update", "-f", str(rc0)),
        ("label", "pods", "p1", "tier=front"),
        ("label", "pods", "p1", "tier=back"),
        ("label", "--overwrite", "pods", "p1", "tier=back"),
        ("label", "pods", "p2", "app-"), ("delete", "pods", "p3"),
        ("delete", "pods", "p3"), ("delete", "-f", str(upd)),
        ("run-container", "web", "--image=nginx", "--replicas=2"),
        ("expose", "web", "--port=8080"), ("resize", "rc", "web",
                                           "--replicas=3"),
        ("resize", "rc", "web", "--replicas=5", "--current-replicas=2"),
        ("stop", "rc", "rc0"),
        ("rolling-update", "rc1", "-f", str(v2), "--timeout=20"),
        ("cordon", "n1"), ("cordon", "n1"), ("uncordon", "n2"),
        ("drain", "n3"), ("delete", "pods", "-l", "app=app-0"),
    ]


def test_writes_leave_the_same_store_state(tmp_path):
    ref, port = _Session("ref"), _Session("port")
    assert ref.state() == port.state()
    for argv in _writes(tmp_path):
        if argv[-1].endswith("minion.json"):
            # the reference's Builder maps a resource from the wire kind,
            # which a v1beta1 "Minion" is not, and raises; the port maps
            # the decoded kind, a Node, and creates it
            assert ref.kubectl(*argv)[0] == "raised KeyError: 'Minion'"
            assert port.kubectl(*argv) == (0, "n9\n", "")
            with open(argv[-1]) as fh:
                ref.client.nodes().create(
                    ref_scheme.decode_from_wire(json.load(fh)))
            assert port.state() == ref.state()
            continue
        outs = []
        for s in (ref, port):
            stop = threading.Event()
            t = threading.Thread(target=_settle_status,
                                 args=(s.client, stop), daemon=True)
            t.start()
            try:
                rc, out, err = s.kubectl(*argv)
            finally:
                stop.set()
                t.join(timeout=5)
            outs.append((rc, _norm(out), _norm(err)))
        assert outs[1] == outs[0], argv
        assert port.state() == ref.state(), argv
    state = port.state()
    assert {k[2] for k in state if k[0] == "replicationcontrollers"} == \
        {"web", "rc1-v2"}
    assert state[("services", "default", "web")]["spec"]["port"] == 8080
    assert state[("nodes", "", "n1")]["spec"]["unschedulable"] is True
    assert state[("pods", "default", "p1")]["metadata"]["labels"]["tier"] \
        == "back"
    assert ("pods", "default", "legacy-pod") in state
    assert ("nodes", "", "n9") in state


# -- kubeconfig, version-change, doc generators ---------------------------

CONFIG_STEPS = [
    ("config", "set-cluster", "local", "--server=http://127.0.0.1:8080"),
    ("config", "set-cluster", "prod", "--server=https://10.0.0.1"),
    ("config", "set-credentials", "ops", "--token=t0k"),
    ("config", "set-credentials", "dev", "--username=u", "--password=p"),
    ("config", "set-context", "c", "--cluster=local", "--user=dev"),
    ("config", "set-context", "p", "--cluster=prod", "--user=ops"),
    ("config", "use-context", "p"),
]
CLIENTCMD = {"ref": ref_clientcmd, "port": port_clientcmd}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_kubeconfig_written_by_either_loads_in_both(writer, tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("KUBECONFIG", raising=False)
    path = tmp_path / "kubeconfig"
    Factory, run = PKGS[writer][3], PKGS[writer][4]
    for argv in CONFIG_STEPS:
        out, err = io.StringIO(), io.StringIO()
        assert run([*argv, f"--kubeconfig={path}"],
                   Factory(None, out=out, err=err)) == 0, err.getvalue()
    loaded = {pkg: mod.load_file(str(path)) for pkg, mod in CLIENTCMD.items()}
    assert dataclasses.asdict(loaded["port"]) == \
        dataclasses.asdict(loaded["ref"])
    assert loaded["port"].current_context == "p"
    for pkg, mod in CLIENTCMD.items():
        cfg = mod.load_config(str(path), env={}, home=str(tmp_path))
        cluster, user, _ns = cfg.resolve("")
        assert (cluster.server, user.token) == ("https://10.0.0.1", "t0k")
        cluster, user, _ns = cfg.resolve("c")
        assert (cluster.server, user.username, user.password) == \
            ("http://127.0.0.1:8080", "u", "p")
    # the views print the same text
    views = []
    for Factory, run in ((RefFactory, ref_run), (PortFactory, port_run)):
        out = io.StringIO()
        assert run(["config", "view", f"--kubeconfig={path}"],
                   Factory(None, out=out, err=io.StringIO())) == 0
        views.append(out.getvalue())
    assert views[0] == views[1] and "current-context: p" in views[0]


VC_CASES = [
    ("v1", "v1beta1"), ("v1", "v1beta2"), ("v1beta1", "v1"),
    ("v1beta1", "v1beta2"), ("v1beta2", "v1beta1"),
]


@pytest.mark.parametrize("src,dst", VC_CASES)
@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_version_change_gives_the_same_output(src, dst, fmt):
    objs, _binds = _seed_wire(SEED + 1)
    for _res, _ns, wire in objs:
        text = json.dumps(ref_scheme.convert_wire(wire, "v1", src))
        outs = []
        for vc in (ref_vc, port_vc):
            out = io.StringIO()
            rc = vc(["--version", dst, "--format", fmt],
                    stdin=io.StringIO(text), stdout=out)
            outs.append((rc, out.getvalue()))
        assert outs[0] == outs[1] and outs[0][0] == 0, wire["kind"]
    for vc in (ref_vc, port_vc):
        assert vc(["--version", "v9"], stdin=io.StringIO("{}"),
                  stdout=io.StringIO()) == 2
        assert vc([], stdin=io.StringIO("[1]"), stdout=io.StringIO()) == 1


@pytest.mark.parametrize("gen", ["gendocs", "genman"])
def test_doc_generators_write_the_same_trees(gen, tmp_path):
    mods = {"gendocs": (ref_gendocs, port_gendocs),
            "genman": (ref_genman, port_genman)}[gen]
    trees = []
    for pkg, mod in zip(("ref", "port"), mods):
        outdir = tmp_path / pkg
        assert mod.main([str(outdir)]) == 0
        trees.append({p.relative_to(outdir).as_posix(): p.read_text()
                      for p in sorted(outdir.rglob("*")) if p.is_file()})
    assert trees[0] == trees[1]
    assert len(trees[0]) > 20
