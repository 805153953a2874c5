"""The port's service proxy, DNS and logging addons, hyperkube and deploy
script against the reference's.

- Each package's kube-proxy process (an in-memory rule table) over the
  other package's kube-apiserver process relays to the same echo
  backends, in the same round-robin order.
- The two ``DNSServer``s answer byte-identical packets for the same
  services and queries (mixed case, the short form, another namespace,
  a non-A query, NXDOMAIN, the label-bounded suffix, too many labels).
- The two ``LogAggregator``s, over one fetch seam and the same pods,
  ingest the same lines through appends, a container restart, a node
  flap and a delete, and answer every query alike (the records' ``ts``
  left out).
- The two ``hyperkube.SERVERS`` name the same servers.
- ``kubernetes_tpu_torch/deploy/local-up.sh``, run with bash on a free
  port, serves ``/healthz`` and ``/api/v1/nodes``, and SIGTERM leaves no
  process.
"""

import importlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time

from chip_smoke import (_children, _free_port, _listening_ports,
                        _stop_process, _wait_http)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs the port's kube-proxy with jax and the reference package
# unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kube-proxy"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.proxy", run_name="__main__",
                 alter_sys=True)
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


def _echo_server(prefix: bytes):
    """A TCP server answering each connection with prefix + what it read;
    -> (port, closer)."""
    import threading

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)

    def run():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                conn.sendall(prefix + conn.recv(64))
            finally:
                conn.close()
    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1], srv.close


def _call(port) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(b"hi")
        out = b""
        while True:
            chunk = s.recv(64)
            if not chunk:
                return out
            out += chunk


def _relay_order(server: str, proxy_is_port: bool, backends, tmp_path):
    """Start ``server``'s apiserver process, create the service ``web``
    and its Endpoints naming ``backends`` in order, then the other
    package's kube-proxy process -> its first seven answers."""
    api = _mod(server, "api.types")
    client_mod, http = _mod(server, "client.client"), _mod(server,
                                                            "client.http")
    port = _free_port()
    log = open(tmp_path / f"{server}_apiserver.log", "w")
    api_proc = subprocess.Popen(
        [sys.executable, "-m", f"{server}.cmd.apiserver", "--port",
         str(port)], cwd=ROOT, env=_env(), stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    url = f"http://127.0.0.1:{port}"
    proxy = None
    try:
        _wait_http(url + "/healthz", api_proc, server, 60.0)
        c = client_mod.Client(http.HTTPTransport(url))
        c.services().create(api.Service(
            metadata=api.ObjectMeta(name="web", namespace="default"),
            spec=api.ServiceSpec(port=80, selector={"app": "web"})))
        c.endpoints("default").create(api.Endpoints(
            metadata=api.ObjectMeta(name="web", namespace="default"),
            endpoints=[api.Endpoint(ip="127.0.0.1", port=p)
                       for p in backends]))
        head = ([sys.executable, "-c", LAUNCHER] if proxy_is_port else
                [sys.executable, "-m", "kubernetes_tpu.cmd.proxy"])
        plog = open(tmp_path / f"{server}_proxy.log", "w")
        proxy = subprocess.Popen(head + ["--master", url], cwd=ROOT,
                                 env=_env(), stdout=plog,
                                 stderr=subprocess.STDOUT)
        plog.close()
        _wait(lambda: len(_listening_ports(proxy.pid)) == 1,
              "the proxy's port of web")
        (pport,) = _listening_ports(proxy.pid)
        # answers start once the endpoints reached the balancer: a call
        # before that is closed without a backend, and moves no index
        first = b""
        deadline = time.monotonic() + 30
        while not first:
            assert time.monotonic() < deadline, "no answer through the proxy"
            first = _call(pport)
        order = [first] + [_call(pport) for _ in range(6)]
        assert proxy.poll() is None
        return order
    finally:
        if proxy is not None:
            _stop_process(proxy)
        _stop_process(api_proc)


def test_each_proxy_relays_over_the_other_apiserver_in_one_order(tmp_path):
    servers = [_echo_server(p) for p in (b"a:", b"b:", b"c:")]
    try:
        ports = [p for p, _c in servers]
        port_over_ref = _relay_order("kubernetes_tpu", True, ports, tmp_path)
        ref_over_port = _relay_order("kubernetes_tpu_torch", False, ports,
                                     tmp_path)
    finally:
        for _p, close in servers:
            close()
    want = [b"a:hi", b"b:hi", b"c:hi"] * 2 + [b"a:hi"]
    assert port_over_ref == ref_over_port == want


def _packet(name, qtype=1, txid=0x4242):
    q = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    for label in name.split("."):
        q += bytes([len(label)]) + label.encode()
    return q + b"\x00" + struct.pack(">HH", qtype, 1)


_QUERIES = [
    ("web.default.cluster.local", 1), ("WEB.Default.CLUSTER.local", 1),
    ("web.cluster.local", 1), ("db.prod.cluster.local", 1),
    ("DB.Prod.Cluster.Local", 1), ("web.default.cluster.local", 28),
    ("web.default.cluster.local", 16), ("ghost.default.cluster.local", 1),
    ("ghost.default.cluster.local", 28), ("web.default.example.com", 1),
    ("webcluster.local", 1), ("web.defaultcluster.local", 1),
    ("cluster.local", 1), ("a.web.default.cluster.local", 1),
    ("db.default.cluster.local", 1)]


def _dns_answers(pkg):
    api = _mod(pkg, "api.types")
    master = _mod(pkg, "apiserver.master").Master()
    cm = _mod(pkg, "client.client")
    client = cm.Client(cm.InProcessTransport(master))
    client.services().create(api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": "web"})))
    client.resource("services", "prod").create(api.Service(
        metadata=api.ObjectMeta(name="db", namespace="prod"),
        spec=api.ServiceSpec(port=5432, selector={"app": "db"})))
    dns = _mod(pkg, "addons.dns").DNSServer(client).start()
    try:
        _wait(lambda: dns.resolve("db.prod.cluster.local")
              and dns.resolve("web.default.cluster.local"), "the services")
        out = []
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(5)
        try:
            for k, (name, qtype) in enumerate(_QUERIES):
                s.sendto(_packet(name, qtype, txid=k), dns.addr)
                out.append(s.recvfrom(512)[0])
        finally:
            s.close()
        return out, [dns.resolve(n) for n, _t in _QUERIES]
    finally:
        dns.stop()


def test_dns_servers_answer_the_same_bytes():
    ref, port = _dns_answers("kubernetes_tpu"), _dns_answers(
        "kubernetes_tpu_torch")
    assert port == ref
    rcodes = [p[3] & 0xF for p in port[0]]
    assert rcodes == [0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3, 3, 3, 3, 3]


class _Logs:
    """One fetch seam for both packages' aggregators: the text of each
    (node, namespace, pod, container), or None where the kubelet does
    not answer."""

    def __init__(self):
        self.text = {}
        self.down = set()

    def __call__(self, node, ns, pod, container):
        name = node.metadata.name
        if name in self.down:
            return None
        return self.text.get((name, ns, pod, container), "")


def _pods(api, specs):
    return [api.Pod(
        metadata=api.ObjectMeta(name=name, namespace=ns),
        spec=api.PodSpec(host=host, containers=[
            api.Container(name=c, image="img") for c in containers]))
        for name, ns, host, containers in specs]


def _aggregate(pkg, steps):
    """Run ``steps`` (each: fetch texts, down nodes, pods, nodes) through
    ``pkg``'s LogAggregator -> each collect's new lines and the answers
    of a fixed set of queries after each."""
    api = _mod(pkg, "api.types")
    fetch = _Logs()
    agg = _mod(pkg, "addons.logging").LogAggregator(
        client=None, fetch=fetch, period_s=3600, max_records=7)
    out = []
    try:
        for texts, down, pods, nodes in steps:
            fetch.text.update(texts)
            fetch.down = set(down)
            agg.node_store.replace([api.Node(metadata=api.ObjectMeta(
                name=n)) for n in nodes])
            agg.pod_store.replace(_pods(api, pods))
            lines = agg.collect_once()
            answers = [[{k: v for k, v in r.items() if k != "ts"}
                        for r in agg.query(**q)] for q in (
                {}, {"namespace": "prod"}, {"pod": "p1"},
                {"container": "side"}, {"node": "n2"}, {"q": "err"},
                {"q": "o", "limit": 2})]
            out.append((lines, answers, sorted(agg._offsets.items())))
    finally:
        agg._httpd.server_close()
    return out


def test_log_aggregators_answer_alike():
    pods = [("p1", "default", "n1", ["main", "side"]),
            ("p2", "prod", "n2", ["main"]),
            ("p3", "default", "", ["main"])]
    steps = [
        ({("n1", "default", "p1", "main"): "one\ntwo\n",
          ("n1", "default", "p1", "side"): "err: x\n",
          ("n2", "prod", "p2", "main"): "boot\n"}, (), pods, ["n1", "n2"]),
        ({("n1", "default", "p1", "main"): "one\ntwo\nthree\n",
          ("n2", "prod", "p2", "main"): "up\n"}, (), pods, ["n1", "n2"]),
        ({("n1", "default", "p1", "side"): "err: x\nerr: y\n"}, ("n2",),
         pods, ["n1"]),
        ({("n2", "prod", "p2", "main"): "up\nagain\nno err\n"}, (),
         pods[1:], ["n1", "n2"]),
    ]
    ref = _aggregate("kubernetes_tpu", steps)
    port = _aggregate("kubernetes_tpu_torch", steps)
    assert port == ref
    assert [lines for lines, _a, _o in port] == [4, 2, 1, 2]


def test_hyperkube_tables_name_the_same_servers():
    ref = _mod("kubernetes_tpu", "cmd.hyperkube").SERVERS
    port = _mod("kubernetes_tpu_torch", "cmd.hyperkube").SERVERS
    assert len(port) == 20 and set(port) == set(ref)


def test_local_up_serves_and_stops(tmp_path):
    """The port's deploy/local-up.sh with bash: the standalone cluster's
    apiserver answers, and SIGTERM leaves no process of the script's."""
    port = _free_port()
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" '
                                   f'"$@"\n')
    (bindir / "python").chmod(0o755)
    env = _env()
    env["PATH"] = f"{bindir}{os.pathsep}{env.get('PATH', '')}"
    log = open(tmp_path / "local-up.log", "w")
    proc = subprocess.Popen(
        ["bash", os.path.join(ROOT, "kubernetes_tpu_torch", "deploy",
                              "local-up.sh"), str(port), "1"],
        cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    log.close()
    try:
        url = f"http://127.0.0.1:{port}"
        body = _wait_http(url + "/healthz", proc, "local-up.sh", 120.0)
        assert json.loads(body)["healthy"] is True
        _wait(lambda: "node-0" in _wait_http(url + "/api/v1/nodes", proc,
                                             "local-up.sh"),
              "the node", 30.0)
        kids = _children(proc.pid) | {proc.pid}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        _wait(lambda: not any(os.path.exists(f"/proc/{k}") for k in kids),
              "every process of the script to exit", 15.0)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
