"""The port's descheduler against the reference's, across the wire.

From one seeded cluster (nodes of two sizes, residents of seeded sizes,
two nodes cordoned; on one of them a pod that opts out of disruption, in
``kube-system`` another), each package's kube-descheduler process runs
one wave (``--one-shot``) against the other package's kube-apiserver
process: the reference's descheduler against the port's apiserver, and
the port's against the reference's. Both report the same wave (scores,
proposals, commits, drained and emptied nodes, undrainable pods) and
leave the same pods on the same nodes, with the same uids, and the
cordoned nodes hold only the pods that may not move. A second wave on
each changes nothing more than the reference's own second wave does.
"""

import json
import os
import random
import subprocess
import sys

import pytest

from chip_smoke import _free_port, _stop_process, _wait_http

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018

# runs the port's descheduler with jax and the reference package
# unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kube-descheduler"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.descheduler",
                 run_name="__main__", alter_sys=True)
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def _apiserver(pkg, tmp_path, tag):
    port = _free_port()
    log = open(tmp_path / f"{tag}_apiserver.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", f"{pkg}.cmd.apiserver",
                             "--port", str(port)], cwd=ROOT, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    url = f"http://127.0.0.1:{port}"
    _wait_http(url + "/healthz", proc, pkg, 60.0)
    return proc, url


def _one_shot(port: bool, url: str) -> dict:
    head = ([sys.executable, "-c", LAUNCHER] if port else
            [sys.executable, "-m", "kubernetes_tpu.cmd.descheduler"])
    proc = subprocess.run(head + ["--master", url, "--one-shot",
                                  "--max-moves", "6"],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _seed(pkg: str, url: str, seed: int):
    """The cluster, through ``pkg``'s client -> the cordoned nodes."""
    import importlib

    api = importlib.import_module(f"{pkg}.api.types")
    Q = importlib.import_module(f"{pkg}.api.quantity").Quantity
    Client = importlib.import_module(f"{pkg}.client.client").Client
    HTTP = importlib.import_module(f"{pkg}.client.http").HTTPTransport
    c = Client(HTTP(url))
    rng = random.Random(seed)
    n_nodes = 14
    for i in range(n_nodes):
        big = i % 3 == 0
        c.nodes().create(api.Node(
            metadata=api.ObjectMeta(name=f"n{i:02d}"),
            spec=api.NodeSpec(capacity={
                "cpu": Q("8" if big else "4"),
                "memory": Q("16Gi" if big else "8Gi")})))
    c.namespaces().create(api.Namespace(
        metadata=api.ObjectMeta(name="kube-system")))
    cordoned = [f"n{i:02d}" for i in rng.sample(range(n_nodes), 2)]
    pods = []
    for k in range(34):
        ns = "kube-system" if k == 0 else "default"
        ann = ({"scheduler.kubernetes.io/do-not-disrupt": "true"}
               if k == 1 else {})
        host = cordoned[0] if k in (0, 1) else f"n{rng.randrange(n_nodes):02d}"
        pod = api.Pod(
            metadata=api.ObjectMeta(name=f"p{k:02d}", namespace=ns,
                                    labels={"app": f"a{k % 3}"},
                                    annotations=ann),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img",
                resources=api.ResourceRequirements(limits={
                    "cpu": Q(f"{rng.choice((200, 500, 1000))}m"),
                    "memory": Q(f"{rng.choice((256, 512, 1024))}Mi")}))]))
        c.pods(ns).create(pod)
        pods.append((ns, f"p{k:02d}", host))
    for ns, name, host in pods:
        c.pods(ns).bind(api.Binding(
            metadata=api.ObjectMeta(name=name, namespace=ns),
            pod_name=name, host=host))
    for name in cordoned:
        node = c.nodes().get(name)
        node.spec.unschedulable = True
        c.nodes().update(node)
    return c, cordoned


def _placements(c) -> dict:
    return {(p.metadata.namespace, p.metadata.name):
            (p.spec.host, p.status.host)
            for p in c.pods("").list().items}


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_one_wave_is_the_same_across_the_packages(seed, tmp_path):
    out = {}
    for server, desched_is_port in (("kubernetes_tpu_torch", False),
                                    ("kubernetes_tpu", True)):
        proc, url = _apiserver(server, tmp_path, server)
        try:
            c, cordoned = _seed(server, url, seed)
            uids = {(p.metadata.namespace, p.metadata.name): p.metadata.uid
                    for p in c.pods("").list().items}
            first = _one_shot(desched_is_port, url)
            placed = _placements(c)
            second = _one_shot(desched_is_port, url)
            again = _placements(c)
            assert {(p.metadata.namespace, p.metadata.name): p.metadata.uid
                    for p in c.pods("").list().items} == uids
        finally:
            _stop_process(proc)
        # a pod's spec and status agree; the cordoned nodes keep only the
        # two pods that may not move
        assert all(h == s for h, s in placed.values())
        left = sorted(k for k, (h, _s) in placed.items() if h in cordoned)
        assert left == [("default", "p01"), ("kube-system", "p00")]
        out[server] = (first, placed, second, again)
    ref, port = out["kubernetes_tpu"], out["kubernetes_tpu_torch"]
    assert ref[0] == port[0]
    assert ref[0]["committed"] == ref[0]["proposed"] > 2
    # the node with the two pods that may not move is never drained
    assert ref[0]["undrainable"] == 2
    assert ref[0]["nodes_drained"] == sorted(
        {h for k, (h, _s) in out["kubernetes_tpu"][1].items()
         if h in cordoned} ^ set(cordoned))
    assert ref[1] == port[1]
    assert ref[2] == port[2] and ref[3] == port[3]
