"""The port's controller slice against the reference's, package by package.

- One sync of each control loop (replication, endpoints, the node
  controller with a ``FakeCloud``, namespace, quota), from one seeded
  store state, run by each package in process over its own master: the
  stores after the sync are equal (pods created per RC and the victims
  deleted, endpoints, node conditions and deletions, the namespace's
  finalisation, quota usage), with generated names compared by their
  prefix and UIDs, timestamps and resourceVersions left out; the fake
  clouds recorded the same calls.
- The same inventory file and probe output give equal instances,
  addresses, resources, zones and clusters in both packages.
- The same ``.dockercfg``, ``config.json`` and ``REGISTRY_AUTH_*``
  variables give equal keyring lookups for a seeded set of image names.
- The port's kube-controller-manager process brings an RC to its count
  against the reference's apiserver process, and the reference's against
  the port's; both binaries refuse ``--machines`` with
  ``--cloud-provider`` (exit 2), and the port's exits 0 on SIGTERM.
"""

import importlib
import json
import os
import random
import signal
import subprocess
import sys
import time

import pytest

from chip_smoke import _free_port, _stop_process, _wait_http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261017
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")

# runs the port's controller manager with jax and the reference package
# unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu", "torch", "numpy")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kube-controller-manager"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.controller_manager",
                 run_name="__main__", alter_sys=True)
"""


class _Pkg:
    """One package's modules under the names the tests use."""

    def __init__(self, name: str):
        def mod(rel):
            return importlib.import_module(f"{name}.{rel}")
        self.name = name
        self.api = mod("api.types")
        self.Quantity = mod("api.quantity").Quantity
        self.scheme = mod("api.latest").scheme
        self.Master = mod("apiserver.master").Master
        client = mod("client.client")
        self.Client, self.InProcess = client.Client, client.InProcessTransport
        self.HTTPTransport = mod("client.http").HTTPTransport
        self.controllers = mod("controllers")
        self.cloud = mod("cloudprovider")
        self.inventory = mod("cloudprovider.inventory")
        self.probe = mod("cloudprovider.probe")
        self.keyring = mod("credentialprovider.keyring")

    def client(self):
        return self.Client(self.InProcess(self.Master()))


@pytest.fixture(scope="module")
def pkgs():
    return [_Pkg(n) for n in PACKAGES]


# -- one seeded store state ------------------------------------------------

def _pod(P, name, ns, labels, rng, port=None):
    api, Q = P.api, P.Quantity
    ports = [api.ContainerPort(container_port=port)] if port else []
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace=ns, labels=dict(labels)),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img", ports=ports,
            resources=api.ResourceRequirements(limits={
                "cpu": Q(f"{rng.choice((100, 250, 500))}m"),
                "memory": Q(f"{rng.choice((64, 128, 256))}Mi")}))]))


def _bind(P, c, name, ns, host):
    api = P.api
    c.pods(ns).bind(api.Binding(
        metadata=api.ObjectMeta(name=name, namespace=ns),
        pod_name=name, host=host))


def _run(P, c, name, ns, ip, phase=None):
    pod = c.pods(ns).get(name)
    pod.status.phase = phase or P.api.PodRunning
    pod.status.pod_ip = ip
    c.pods(ns).update_status(pod)


def _rc(P, name, replicas, labels):
    api = P.api
    return api.ReplicationController(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=replicas, selector=dict(labels),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels=dict(labels),
                                        annotations={"tier": name}),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", image="img",
                    ports=[api.ContainerPort(container_port=8080)])]))))


def _seed(P, seed):
    """The same cluster in each package, drawn from ``seed``: nodes, RCs
    below, at and above their counts with some pods bound, running pods
    with IPs behind two services (one UDP, one with a failed pod and one
    without an IP), a namespace being deleted with content, and a quota."""
    api, Q = P.api, P.Quantity
    rng = random.Random(seed)
    c = P.client()
    n_nodes = rng.randint(5, 8)
    for i in range(n_nodes):
        c.nodes().create(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}"),
            spec=api.NodeSpec(capacity={"cpu": Q("4"),
                                        "memory": Q("8Gi")})))
    c.services().create(api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": "web"})))
    c.services().create(api.Service(
        metadata=api.ObjectMeta(name="dns", namespace="default"),
        spec=api.ServiceSpec(port=53, container_port=5353,
                             protocol=api.ProtocolUDP,
                             selector={"app": "dns"})))
    # RCs: web short of its count, shrink above it, steady at it
    shapes = {"web": (rng.randint(4, 7), 2), "shrink": (1, rng.randint(4, 6)),
              "steady": (2, 2)}
    for rc, (want, have) in shapes.items():
        c.replication_controllers().create(_rc(P, rc, want, {"app": rc}))
        for k in range(have):
            c.pods().create(_pod(P, f"{rc}-{k}", "default", {"app": rc}, rng,
                                 port=8080))
    _bind(P, c, "web-0", "default", "n0")
    for k in rng.sample(range(shapes["shrink"][1]), 2):
        _bind(P, c, f"shrink-{k}", "default", f"n{k % n_nodes}")
    _run(P, c, "web-0", "default", "10.1.0.10")
    _run(P, c, "web-1", "default", "10.1.0.11")
    for k in range(3):
        c.pods().create(_pod(P, f"dns-{k}", "default", {"app": "dns"}, rng,
                             port=5353))
    _run(P, c, "dns-0", "default", "10.1.1.1")
    _run(P, c, "dns-1", "default", "10.1.1.2", phase=api.PodFailed)
    # a pod on a node the cloud no longer lists, one on a deleted node
    c.pods().create(_pod(P, "gone-0", "default", {"app": "gone"}, rng))
    _bind(P, c, "gone-0", "default", f"n{n_nodes - 1}")
    c.pods().create(_pod(P, "orphan-0", "default", {"app": "orphan"}, rng))
    _bind(P, c, "orphan-0", "default", "n-deleted")
    # a namespace being deleted, with content
    c.namespaces().create(api.Namespace(metadata=api.ObjectMeta(
        name="doomed")))
    for k in range(rng.randint(2, 4)):
        c.pods("doomed").create(_pod(P, f"d-{k}", "doomed", {"x": "y"}, rng))
    c.services("doomed").create(api.Service(
        metadata=api.ObjectMeta(name="s", namespace="doomed"),
        spec=api.ServiceSpec(port=80)))
    c.secrets("doomed").create(api.Secret(
        metadata=api.ObjectMeta(name="k", namespace="doomed")))
    c.namespaces().delete("doomed")
    c.resource_quotas().create(api.ResourceQuota(
        metadata=api.ObjectMeta(name="q", namespace="default"),
        spec=api.ResourceQuotaSpec(hard={
            api.ResourcePods: Q("50"), api.ResourceCPU: Q("20"),
            api.ResourceMemory: Q("64Gi"), api.ResourceServices: Q("10"),
            api.ResourceReplicationControllers: Q("10"),
            api.ResourceQuotas: Q("5"), api.ResourceSecrets: Q("5")})))
    return c, n_nodes


# -- the store, normalised -------------------------------------------------

_VOLATILE = ("uid", "resourceVersion", "selfLink")


def _norm(doc, gen=""):
    """Drop what is random, wall-clock or order-dependent: UIDs,
    timestamps, resourceVersions, a generated name's suffix."""
    if isinstance(doc, dict):
        gen = doc.get("generateName", gen)
        out = {}
        for k, v in doc.items():
            if k in _VOLATILE or k.lower().endswith(("timestamp", "time")):
                continue
            if k == "name" and gen and isinstance(v, str) \
                    and v.startswith(gen):
                v = gen + "<generated>"
            out[k] = _norm(v, gen if k == "metadata" else "")
        return out
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    return doc


def _dump(P, c) -> dict:
    out = {}
    lists = {"pods": c.pods(""), "rcs": c.replication_controllers(""),
             "services": c.services(""), "endpoints": c.endpoints(""),
             "nodes": c.nodes(), "namespaces": c.namespaces(),
             "quotas": c.resource_quotas(""), "secrets": c.secrets("")}
    for kind, rc in lists.items():
        docs = [json.dumps(_norm(P.scheme.encode_to_wire(o)), sort_keys=True)
                for o in rc.list().items]
        out[kind] = sorted(docs)
    return out


def _sync(P, c, which, n_nodes):
    """One sync of one controller -> the fake cloud, if any."""
    ctl = P.controllers
    if which == "replication":
        mgr = ctl.ReplicationManager(c)
        for rc in c.replication_controllers().list().items:
            mgr.sync(rc)
    elif which == "endpoints":
        ctl.EndpointsController(c).sync_service_endpoints()
    elif which == "node":
        api, Q = P.api, P.Quantity
        cloud = P.cloud.FakeCloud(
            machines=[f"n{i}" for i in range(n_nodes - 1)] + ["cloud-new"],
            node_resources=api.NodeSpec(capacity={"cpu": Q("16"),
                                                  "memory": Q("64Gi")}))
        nc = ctl.NodeController(c, cloud=cloud,
                                node_prober=lambda n: n.metadata.name != "n1")
        nc.sync_cloud_nodes()
        nc.sync_node_status()
        return cloud
    elif which == "namespace":
        ctl.NamespaceController(c).sync_all()
    elif which == "quota":
        ctl.ResourceQuotaController(c).sync_all()
    return None


@pytest.mark.parametrize("which", ["replication", "endpoints", "node",
                                   "namespace", "quota"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_one_sync_has_the_same_effects(which, seed, pkgs):
    befores, afters, calls = [], [], []
    for P in pkgs:
        c, n_nodes = _seed(P, seed)
        befores.append(_dump(P, c))
        cloud = _sync(P, c, which, n_nodes)
        afters.append(_dump(P, c))
        calls.append(cloud and [tuple(x) for x in cloud.calls])
    ref, port = afters
    assert befores[0] == befores[1]
    assert port == ref
    assert calls[0] == calls[1]
    # the sync did something in each package
    assert afters[0] != befores[0]


def test_replication_effects_in_detail(pkgs):
    """What the replication sync did, spelled out: the shortfall created
    from the template (generated names, its labels and annotations), the
    surplus deleted unbound first, the counts written to status."""
    for P in pkgs:
        c, _ = _seed(P, SEED)
        mgr = P.controllers.ReplicationManager(c)
        counts = {rc.metadata.name: mgr.sync(rc)
                  for rc in c.replication_controllers().list().items}
        rcs = {rc.metadata.name: rc
               for rc in c.replication_controllers().list().items}
        assert counts == {k: v.spec.replicas for k, v in rcs.items()}
        assert all(v.status.replicas == v.spec.replicas for v in rcs.values())
        made = [p for p in c.pods().list(label_selector="app=web").items
                if p.metadata.generate_name == "web-"]
        assert len(made) == rcs["web"].spec.replicas - 2
        assert all(p.metadata.annotations == {"tier": "web"} for p in made)
        left = c.pods().list(label_selector="app=shrink").items
        assert len(left) == 1 and left[0].spec.host


# -- providers: the same files give the same answers -----------------------

INVENTORY = {
    "zone": {"failure_domain": "cell-b", "region": "dc2"},
    "instances": [
        {"name": "w-1", "addresses": ["10.2.0.1", "10.2.1.1"], "cpu": "8",
         "memory": "16Gi"},
        {"name": "w-2", "addresses": ["10.2.0.2"], "cpu": "500m"},
        {"name": "w-3", "addresses": [], "memory": "1536Mi",
         "external_id": "i-0003"},
        {"name": "m-1", "addresses": ["10.2.0.100"]},
    ],
    "clusters": {"names": ["beta", "alpha"],
                 "masters": {"alpha": "10.2.9.1", "beta": "10.2.9.2"}},
}


def _provider_view(P, cloud, clusters: bool):
    inst = cloud.instances()
    out = {}
    for rx in (".*", "w-.*", "m-1"):
        out[rx] = inst.list_instances(rx)
    for name in inst.list_instances():
        spec = inst.get_node_resources(name)
        out[name] = (inst.node_addresses(name), inst.external_id(name),
                     None if spec is None else
                     {k: str(v) for k, v in spec.capacity.items()})
    z = cloud.zones().get_zone()
    out["zone"] = (z.failure_domain, z.region)
    out["lb"] = cloud.tcp_load_balancer() is None
    if clusters:
        cl = cloud.clusters()
        out["clusters"] = [(n, cl.master(n)) for n in cl.list_clusters()]
    return out


def test_inventory_and_probe_agree(pkgs, tmp_path):
    inv = tmp_path / "inv.json"
    inv.write_text(json.dumps(INVENTORY))
    probe = [sys.executable, "-c",
             f"import sys; sys.stdout.write(open({str(inv)!r}).read())"]
    views = []
    for P in pkgs:
        views.append((_provider_view(P, P.inventory.InventoryCloud(str(inv)),
                                     False),
                      _provider_view(P, P.probe.ProbeCloud(probe), True)))
    assert views[0] == views[1]
    assert views[0][0]["w-1"][2] == {"cpu": "8", "memory": "16Gi"}


IMAGES = ["nginx", "library/nginx:1.7", "gcr.io/proj/img:v1",
          "gcr.io/proj-other/img", "gcr.io/other/x", "quay.io/team/app",
          "localhost:5000/app", "localhost/app", "registry.example.com:443/a/b",
          "docker.io/library/busybox", "index.docker.io/u/i", "gcr.i/x"]


def test_keyring_lookups_agree(pkgs, tmp_path):
    import base64
    rng = random.Random(SEED)
    flat = tmp_path / ".dockercfg"
    flat.write_text(json.dumps({
        "https://gcr.io": {"auth": base64.b64encode(b"broad:pw1").decode(),
                           "email": "a@x"},
        "gcr.io/proj": {"auth": base64.b64encode(b"narrow:pw2").decode()},
        "http://localhost:5000/": {"username": "local", "password": "pw3"},
        "index.docker.io": {"auth": base64.b64encode(b"hub:pw4").decode()}}))
    nested = tmp_path / "config.json"
    nested.write_text(json.dumps({"auths": {
        "quay.io": {"username": "q", "password": "w"},
        "registry.example.com:443": {"auth": "bm90LWJhc2U2NA=="}}}))
    env = {"REGISTRY_AUTH_QUAY_IO": "envq:pw5", "PATH": "/bin"}
    images = IMAGES + [f"gcr.io/{rng.choice(('proj', 'projx', 'other'))}/"
                       f"i{k}" for k in range(8)]
    results = []
    for P in pkgs:
        k = P.keyring
        ring = k.DockerKeyring()
        for provider in (k.FileProvider(paths=[str(flat)]),
                         k.FileProvider(paths=[str(tmp_path / "none"),
                                               str(nested)]),
                         k.EnvProvider(env=env)):
            assert provider.enabled()
            ring.add(provider.provide())
        got = []
        for image in images:
            entry, found = ring.lookup(image)
            got.append((image, found, entry and (entry.username,
                                                 entry.password,
                                                 entry.email)))
        results.append(got)
        assert k.DockerConfigEntry(username="u", password="p").to_wire() == \
            {"auth": "dTpw", "email": ""}
    assert results[0] == results[1]
    assert ("gcr.io/proj/img:v1", True, ("narrow", "pw2", "")) in results[1]


# -- the binaries against the other package's apiserver --------------------

def _apiserver(module, tmp_path, tag):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    log = open(tmp_path / f"{tag}_apiserver.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", module, "--port",
                             str(port)], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    url = f"http://127.0.0.1:{port}"
    _wait_http(url + "/healthz", proc, f"{module}", 60.0)
    return proc, url


def _manager(port: bool, args, tmp_path, tag):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    cmd = ([sys.executable, "-c", LAUNCHER] if port else
           [sys.executable, "-m", "kubernetes_tpu.cmd.controller_manager"])
    err = open(tmp_path / f"{tag}_manager.log", "w")
    proc = subprocess.Popen(cmd + list(args), cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    return proc


def _wait_log(path, text, proc, timeout=30.0):
    deadline = time.monotonic() + timeout
    while text not in path.read_text():
        assert proc.poll() is None, path.read_text()
        assert time.monotonic() < deadline, path.read_text()
        time.sleep(0.05)


@pytest.mark.parametrize("server,manager", [
    ("kubernetes_tpu.cmd.apiserver", True),
    ("kubernetes_tpu_torch.cmd.apiserver", False),
], ids=["port-manager-ref-apiserver", "ref-manager-port-apiserver"])
def test_manager_brings_an_rc_to_its_count(server, manager, pkgs, tmp_path):
    P = pkgs[1] if manager else pkgs[0]   # the manager's package's client
    api_proc, url = _apiserver(server, tmp_path, "a")
    mgr = None
    try:
        mgr = _manager(manager, ["--master", url], tmp_path, "m")
        _wait_log(tmp_path / "m_manager.log", "kube-controller-manager running",
                  mgr)
        c = P.Client(P.HTTPTransport(url))
        c.replication_controllers().create(_rc(P, "web", 3, {"app": "web"}))
        deadline = time.monotonic() + 30
        while True:
            pods = c.pods().list(label_selector="app=web").items
            rc = c.replication_controllers().get("web")
            if len(pods) == 3 and rc.status.replicas == 3:
                break
            assert time.monotonic() < deadline, (len(pods),
                                                 rc.status.replicas)
            time.sleep(0.1)
        assert all(p.metadata.generate_name == "web-" for p in pods)
        if manager:   # the port's binary stops cleanly on SIGTERM
            mgr.send_signal(signal.SIGTERM)
            assert mgr.wait(timeout=15) == 0
    finally:
        if mgr is not None:
            _stop_process(mgr)
        _stop_process(api_proc)


@pytest.mark.parametrize("port", [True, False], ids=["port", "ref"])
def test_machines_with_a_cloud_is_refused(port, tmp_path):
    proc = _manager(port, ["--machines", "a,b", "--cloud-provider", "fake"],
                    tmp_path, "x")
    assert proc.wait(timeout=30) == 2
    assert "mutually exclusive" in (tmp_path / "x_manager.log").read_text()


def test_node_sync_keeps_pods_of_a_node_created_while_it_ran():
    """The NodeController's status sync lists the nodes, writes each
    one's conditions, then sweeps pods bound to a node that is gone. A
    node created (and a pod bound to it) while the writes ran is missing
    from that first list: the port lists the nodes again before it
    deletes; the reference's sweep deletes the pod as an orphan."""
    from kubernetes_tpu.apiserver.master import Master as RefMaster
    from kubernetes_tpu.client.client import Client as RefClient
    from kubernetes_tpu.client.client import InProcessTransport as RefIPT
    from kubernetes_tpu.controllers.node import NodeController as RefNC
    from kubernetes_tpu_torch.apiserver.master import Master as PortMaster
    from kubernetes_tpu_torch.client.client import Client as PortClient
    from kubernetes_tpu_torch.client.client import InProcessTransport as PortIPT
    from kubernetes_tpu_torch.controllers.node import NodeController as PortNC

    survived = {}
    for name, Master, Client, IPT, NC in (
            ("ref", RefMaster, RefClient, RefIPT, RefNC),
            ("port", PortMaster, PortClient, PortIPT, PortNC)):
        api = __import__(NC.__module__.replace("controllers.node", "api.types"),
                         fromlist=["Pod"])
        client = Client(IPT(Master()))
        client.nodes().create(api.Node(metadata=api.ObjectMeta(name="n0")))
        nc = NC(client)
        check = nc._check_one

        def late_node(node, check=check, client=client, api=api):
            check(node)
            if not client.nodes().list(field_selector="metadata.name=n1"
                                       ).items:
                client.nodes().create(
                    api.Node(metadata=api.ObjectMeta(name="n1")))
                client.pods("default").create(api.Pod(
                    metadata=api.ObjectMeta(name="late", namespace="default"),
                    spec=api.PodSpec(host="n1", containers=[
                        api.Container(name="c", image="i")])))
        nc._check_one = late_node
        nc.sync_node_status()
        survived[name] = [p.metadata.name
                          for p in client.pods("default").list().items]
    assert survived == {"ref": [], "port": ["late"]}


class _CountingPodControl:
    """Counts creates; each goes through the package's own PodControl."""

    def __init__(self, inner):
        self.inner, self.created = inner, 0
        self._lock = __import__("threading").Lock()

    def create_replica(self, ns, rc, *name):
        with self._lock:
            self.created += 1
        self.inner.create_replica(ns, rc, *name)

    def delete_pod(self, ns, name):
        self.inner.delete_pod(ns, name)


def test_two_syncs_of_one_rc_create_its_shortfall_once(pkgs):
    """The watch thread's sync and the periodic resync's can run on one
    RC at once. Here each sync waits after its list of the RC's pods
    until the other has listed too (a barrier of two, which gives up
    after a second if only one arrives):
    the reference's two syncs each see no pods and each create the RC's
    count; the port runs one sync of an RC at a time, so the second lists
    after the first's creates and makes none."""
    import threading

    created = {}
    for P in pkgs:
        c = P.client()
        c.replication_controllers().create(_rc(P, "web", 6, {"app": "web"}))
        rc = c.replication_controllers().get("web")
        barrier = threading.Barrier(2, timeout=1.0)
        pods = c.pods

        class _Pods:
            def __init__(self, ns):
                self.inner = pods(ns)

            def list(self, **kw):
                out = self.inner.list(**kw)
                try:
                    barrier.wait()
                except threading.BrokenBarrierError:
                    pass
                return out

            def __getattr__(self, name):
                return getattr(self.inner, name)

        c.pods = _Pods
        control = _CountingPodControl(P.controllers.PodControl(c))
        mgr = P.controllers.ReplicationManager(c, pod_control=control)
        threads = [threading.Thread(target=mgr.sync, args=(rc,))
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        del c.pods
        active = [p for p in c.pods().list(label_selector="app=web").items]
        created[P.name] = (control.created, len(active))
    assert created == {"kubernetes_tpu": (12, 12),
                       "kubernetes_tpu_torch": (6, 6)}


class _LateCreate:
    """The third create's answer is lost (a reset connection) and the
    apiserver commits it only later, when ``land`` is called: what a
    loaded apiserver does with a request it accepted late."""

    def __init__(self, inner):
        self.inner, self.n, self.held = inner, 0, None
        self._lock = __import__("threading").Lock()

    def create_replica(self, ns, rc, *name):
        with self._lock:
            self.n += 1
            k = self.n
        if k == 3:
            self.held = (ns, rc, name)
            raise ConnectionResetError("the answer was lost")
        self.inner.create_replica(ns, rc, *name)

    def delete_pod(self, ns, name):
        self.inner.delete_pod(ns, name)

    def land(self):
        ns, rc, name = self.held
        try:
            self.inner.create_replica(ns, rc, *name)
        except Exception as e:
            return getattr(e, "code", repr(e))
        return 201


def test_a_create_that_lands_late_makes_no_extra_replica(pkgs):
    """One create of an RC's sync goes unanswered and lands after the
    next sync listed the RC's pods. The reference's next sync creates the
    missing pod again under a new name, and the late one makes a replica
    beyond the count; the port's sends the unanswered create again under
    its name, so the late one is refused as a duplicate (409)."""
    out = {}
    for P in pkgs:
        c = P.client()
        c.replication_controllers().create(_rc(P, "web", 6, {"app": "web"}))
        control = _LateCreate(P.controllers.PodControl(c))
        mgr = P.controllers.ReplicationManager(c, pod_control=control)
        rc = c.replication_controllers().get("web")
        with pytest.raises(ConnectionResetError):
            mgr.sync(rc)
        # (the creates not yet started when one failed are cancelled)
        assert len(c.pods().list(label_selector="app=web").items) < 6
        mgr.sync(c.replication_controllers().get("web"))
        assert len(c.pods().list(label_selector="app=web").items) == 6
        landed = control.land()
        out[P.name] = (len(c.pods().list(label_selector="app=web").items),
                       landed)
    assert out == {"kubernetes_tpu": (7, 201),
                   "kubernetes_tpu_torch": (6, 409)}


class _ReadAfterDeletes:
    """A client that watches an RC's pods and, once the surplus is gone,
    reads the RC to resize it again: ``observed`` is its read, taken
    right after the sync's last delete."""

    def __init__(self, inner, rcs, deletes):
        self.inner, self.rcs, self.left = inner, rcs, deletes
        self.observed = None
        self._lock = __import__("threading").Lock()

    def create_replica(self, ns, rc, *name):
        self.inner.create_replica(ns, rc, *name)

    def delete_pod(self, ns, name):
        self.inner.delete_pod(ns, name)
        with self._lock:
            self.left -= 1
            if self.left == 0:
                self.observed = self.rcs.get("web")


def test_a_resize_read_after_the_deletes_conflicts_and_the_resizer_retries(
        pkgs):
    """The e2e suite's replication case resizes an RC of 3 to 1, waits
    until one pod is left, then reads the RC and writes it with 0. Both
    packages' syncs write the RC's status after their deletes (so the
    status never counts a delete that has not happened), so that read can
    come before the status write, and a bare update then fails with 409.
    kubectl's Resizer reads again after a conflict and gets through."""
    out = {}
    for P in pkgs:
        c = P.client()
        rcs = c.replication_controllers()
        rcs.create(_rc(P, "web", 3, {"app": "web"}))
        mgr = P.controllers.ReplicationManager(c)
        mgr.sync(rcs.get("web"))
        rc = rcs.get("web")
        assert rc.status.replicas == 3
        rc.spec.replicas = 1
        rcs.update(rc)
        control = _ReadAfterDeletes(P.controllers.PodControl(c), rcs, 2)
        P.controllers.ReplicationManager(c, pod_control=control).sync(
            rcs.get("web"))
        assert control.observed.status.replicas == 3  # before the write
        resize = control.observed
        resize.spec.replicas = 0
        try:
            rcs.update(resize)
            code = 200
        except Exception as e:
            code = getattr(e, "code", repr(e))
        left = (len(c.pods().list(label_selector="app=web").items),
                rcs.get("web").status.replicas, code)
        resizer = importlib.import_module(f"{P.name}.kubectl.scale").Resizer
        resized = resizer(c).resize("default", "web", 0)
        out[P.name] = left + (resized.spec.replicas,)
    assert out == {"kubernetes_tpu": (1, 1, 409, 0),
                   "kubernetes_tpu_torch": (1, 1, 409, 0)}
