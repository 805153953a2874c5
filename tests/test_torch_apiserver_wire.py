"""The port's apiserver against the JAX package's, on the wire.

Each package's ``HTTPTransport`` drives one scenario — creates, gets,
selector lists, updates, a stale update, a merge patch, the per-pod and
the batched bind, a watch, deletes and the errors between — against the
port's ``APIServer`` and against the reference's; what each client sees
must be the same from both. Then a seeded differential run sends the same
raw requests (at least 200, drawn with numpy from a seed) to a reference
and a port server side by side: pods, nodes, services, limit ranges and
quotas created, read, listed with label and field selectors, updated,
patched, bound in batches and deleted, and requests that must fail
(conflict, not found, invalid, admission-forbidden, bad request). Status
codes and bodies must be equal with UIDs and timestamps normalized, and
so must the frames of a watch on each server over the whole run.
Every server stops in a ``finally``; every socket read has a timeout.
"""

import dataclasses
import http.client
import json
import re
import types

import numpy as np
import pytest

from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.quantity import Quantity as RefQuantity
from kubernetes_tpu.apiserver.http import APIServer as RefAPIServer
from kubernetes_tpu.apiserver.master import Master as RefMaster
from kubernetes_tpu.client.client import Client as RefClient
from kubernetes_tpu.client.http import HTTPTransport as RefHTTPTransport
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.apiserver.http import APIServer as PortAPIServer
from kubernetes_tpu_torch.apiserver.master import Master as PortMaster
from kubernetes_tpu_torch.client.client import Client as PortClient
from kubernetes_tpu_torch.client.http import HTTPTransport as PortHTTPTransport

TIMEOUT_S = 10.0
SEED = 20261017
N_OPS = 240
RELABEL = "<relabel>"

REF = (RefClient, RefHTTPTransport, ref_api, RefQuantity)
PORT = (PortClient, PortHTTPTransport, port_api, PortQuantity)


def _servers():
    """A reference and a port server, each over a fresh Master."""
    return (RefAPIServer(RefMaster()).start(),
            PortAPIServer(PortMaster()).start())


# -- normalization --------------------------------------------------------

_HOSTPORT = re.compile(r"127\.0\.0\.1:\d+")


def _norm(doc):
    """Drop what is random or wall-clock: UIDs, timestamps, the server's
    address. Everything else, resourceVersions included, must match."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "uid" or k.lower().endswith(("timestamp", "time")):
                out[k] = "<norm>" if v else v
            else:
                out[k] = _norm(v)
        return out
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    if isinstance(doc, str):
        return _HOSTPORT.sub("<host>", doc)
    return doc


def _as_data(obj):
    """A decoded API object (or an error) as comparable plain data."""
    if isinstance(obj, Exception):
        st = getattr(obj, "status", None)
        return ("error", getattr(st, "code", None), getattr(st, "reason", None))
    if obj is None:
        return None
    if hasattr(obj, "type") and hasattr(obj, "object"):
        return (obj.type, _as_data(obj.object))
    return _norm(json.loads(json.dumps(dataclasses.asdict(obj), default=str)))


# -- one client scenario, run against both servers ------------------------

def _scenario(pkg, base_url):
    Client, HTTPTransport, api, Q = pkg
    c = Client(HTTPTransport(base_url, timeout=TIMEOUT_S))
    out = []

    def step(fn):
        try:
            out.append(_as_data(fn()))
        except Exception as e:  # errors are part of the transcript
            out.append(_as_data(e))

    def pod(name, labels=None, cpu="100m"):
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default",
                                    labels=labels or {}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="img", resources=api.ResourceRequirements(
                    limits={"cpu": Q(cpu), "memory": Q("64Mi")}))]))

    w = c.pods().watch()
    try:
        step(lambda: c.nodes().create(api.Node(
            metadata=api.ObjectMeta(name="n1"),
            spec=api.NodeSpec(capacity={"cpu": Q("4"),
                                        "memory": Q("8Gi")}))))
        for i in range(4):
            step(lambda i=i: c.pods().create(
                pod(f"p{i}", {"app": "web" if i % 2 else "db"})))
        step(lambda: c.pods().create(pod("p0")))            # 409
        step(lambda: c.pods().create(pod("Bad_Name")))      # 422
        step(lambda: c.pods().get("p1"))
        step(lambda: c.pods().get("missing"))               # 404
        step(lambda: c.pods().list(label_selector="app=web"))
        step(lambda: c.pods().list(label_selector="app in (db),!gone"))
        step(lambda: c.pods().list(field_selector="spec.host="))

        def relabel():
            got = c.pods().get("p2")
            got.metadata.labels = {"app": "cache"}
            return c.pods().update(got)
        step(relabel)

        def stale():
            got = c.pods().get("p2")
            got.metadata.resource_version = "2"
            return c.pods().update(got)
        step(stale)                                          # 409
        step(lambda: c.transport.request(
            "patch", "pods", namespace="default", name="p3",
            body={"metadata": {"labels": {"patched": "yes"}}}))
        step(lambda: c.pods().bind(api.Binding(
            pod_name="p0", host="n1",
            metadata=api.ObjectMeta(namespace="default"))))
        step(lambda: c.pods().bind_many(api.BindingList(items=[
            api.Binding(metadata=api.ObjectMeta(name=n, namespace="default"),
                        pod_name=n, host="n1")
            for n in ("p0", "p1", "missing")])))
        step(lambda: c.pods().list(field_selector="spec.host=n1"))
        step(lambda: c.pods().delete("p3"))
        step(lambda: c.pods().delete("p3"))                  # 404
        step(lambda: c.services().create(api.Service(
            metadata=api.ObjectMeta(name="s1", namespace="default"),
            spec=api.ServiceSpec(port=80, selector={"app": "web"}))))
        step(lambda: c.pods().list())
        events = [w.next_event(timeout=TIMEOUT_S) for _ in range(9)]
    finally:
        w.stop()
    out += [_as_data(ev) for ev in events]
    return out


@pytest.mark.parametrize("client_pkg", [REF, PORT], ids=["ref", "port"])
def test_each_client_sees_the_same_from_both_apiservers(client_pkg):
    ref_srv, port_srv = _servers()
    try:
        want = _scenario(client_pkg, ref_srv.base_url)
        got = _scenario(client_pkg, port_srv.base_url)
    finally:
        ref_srv.stop()
        port_srv.stop()
    assert len(got) > 30
    assert got == want


def test_port_client_decodes_what_the_reference_client_decodes():
    """The same server through either client: equal objects as data."""
    ref_srv, port_srv = _servers()
    try:
        a = _scenario(REF, port_srv.base_url)
        b = _scenario(PORT, ref_srv.base_url)
    finally:
        ref_srv.stop()
        port_srv.stop()
    assert a == b


# -- the seeded differential run ------------------------------------------

class _Wire:
    """Raw HTTP to one server: (status, normalized JSON body)."""

    def __init__(self, srv):
        self.conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                               timeout=TIMEOUT_S)

    def call(self, method, path, body=None, ctype="application/json",
             norm=True):
        if body is not None and RELABEL in body:
            code, cur = self.call("GET", path, norm=False)
            if code != 200:
                return code, _norm(cur)
            cur["metadata"]["labels"] = body[RELABEL]
            if body["stale"]:
                cur["metadata"]["resourceVersion"] = "3"
            body = cur
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": ctype} if data is not None else {}
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        try:
            doc = json.loads(raw) if raw else None
        except ValueError:
            doc = raw.decode("utf-8", "replace")
        return resp.status, _norm(doc) if norm else doc

    def close(self):
        self.conn.close()


class _WatchStream:
    """A chunked watch read to its end; one JSON frame per chunk."""

    def __init__(self, srv, path):
        import socket
        self.sock = socket.create_connection(("127.0.0.1", srv.port),
                                             timeout=TIMEOUT_S)
        self.sock.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        self.f = self.sock.makefile("rb")
        while self.f.readline() not in (b"\r\n", b""):
            pass

    def frames(self):
        out = []
        while True:
            size = self.f.readline()
            if not size or int(size.strip(), 16) == 0:
                return out
            out.append(_norm(json.loads(self.f.read(int(size.strip(), 16)))))
            self.f.readline()

    def close(self):
        self.sock.close()


def _pod_wire(name, ns, labels, cpu_m, mem_mi, host_port=0):
    c = {"name": "c", "image": "img",
         "resources": {"limits": {"cpu": f"{cpu_m}m",
                                  "memory": f"{mem_mi}Mi"}}}
    if host_port:
        c["ports"] = [{"containerPort": 80, "hostPort": host_port}]
    return {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": ns, "labels": labels},
            "spec": {"containers": [c]}}


def _ops(rng, n):
    """``n`` requests drawn from ``rng``: (method, path, body)."""
    nss = ["default", "ns-a", "ns-limited", "ns-quota"]
    apps = ["web", "db", "cache"]
    setup = [
        ("POST", "/api/v1/namespaces/ns-limited/limitranges",
         {"kind": "LimitRange", "apiVersion": "v1",
          "metadata": {"name": "lr", "namespace": "ns-limited"},
          "spec": {"limits": [{"type": "Container",
                               "max": {"cpu": "500m"}}]}}),
        ("POST", "/api/v1/namespaces/ns-quota/resourcequotas",
         {"kind": "ResourceQuota", "apiVersion": "v1",
          "metadata": {"name": "rq", "namespace": "ns-quota"},
          "spec": {"hard": {"pods": "3"}}}),
    ] + [
        ("POST", "/api/v1/nodes",
         {"kind": "Node", "apiVersion": "v1",
          "metadata": {"name": f"node-{i}", "labels": {"zone": f"z{i % 2}"}},
          "spec": {"capacity": {"cpu": "4", "memory": "8Gi"}}})
        for i in range(4)
    ]
    out = list(setup)
    names = []   # (ns, name) created so far, live or not
    kinds = ["create", "create", "create", "get", "get_missing", "list_label",
             "list_field", "update", "update_stale", "patch", "delete",
             "delete_missing", "duplicate", "invalid", "batch_bind",
             "service", "bad_body", "list_ns"]
    while len(out) < n:
        kind = kinds[int(rng.integers(len(kinds)))]
        ns = nss[int(rng.integers(len(nss)))]
        if kind in ("create", "duplicate", "invalid") or not names:
            name = f"p{len(names):03d}"
            labels = {"app": apps[int(rng.integers(3))]}
            if rng.random() < 0.3:
                labels["tier"] = "front"
            cpu = int(rng.choice([100, 250, 400, 1000]))
            port = int(rng.choice([0, 0, 8080]))
            if kind == "duplicate" and names:
                ns, name = names[int(rng.integers(len(names)))]
            elif kind == "invalid":
                name = "Bad_" + name
            else:
                names.append((ns, name))
            out.append(("POST", f"/api/v1/namespaces/{ns}/pods",
                        _pod_wire(name, ns, labels, cpu, 64, port)))
            continue
        pns, pname = names[int(rng.integers(len(names)))]
        base = f"/api/v1/namespaces/{pns}/pods"
        if kind == "get":
            out.append(("GET", f"{base}/{pname}", None))
        elif kind == "get_missing":
            out.append(("GET", f"{base}/nope-{int(rng.integers(99))}", None))
        elif kind == "list_label":
            sel = ["app%3Dweb", "app%21%3Ddb", "app+in+%28web%2Ccache%29",
                   "tier", "%21tier", "app%3Ddb%2Ctier%3Dfront"][
                int(rng.integers(6))]
            out.append(("GET", f"/api/v1/namespaces/{ns}/pods"
                               f"?labelSelector={sel}", None))
        elif kind == "list_field":
            sel = ["spec.host%3D", "spec.host%3Dnode-1",
                   f"metadata.name%3D{pname}", "status.phase%3DPending",
                   "spec.host%21%3D"][int(rng.integers(5))]
            out.append(("GET", f"/api/v1/pods?fieldSelector={sel}", None))
        elif kind in ("update", "update_stale"):
            # relabel the pod as each server holds it just before the
            # PUT, at its current resourceVersion or at a stale one
            body = {RELABEL: {"app": "updated",
                              "round": str(int(rng.integers(9)))},
                    "stale": kind == "update_stale"}
            out.append(("PUT", f"{base}/{pname}", body))
        elif kind == "patch":
            out.append(("PATCH", f"{base}/{pname}",
                        {"metadata": {"labels": {
                            "patched": str(int(rng.integers(9)))}}}))
        elif kind == "delete":
            out.append(("DELETE", f"{base}/{pname}", None))
        elif kind == "delete_missing":
            out.append(("DELETE", f"{base}/gone-{int(rng.integers(9))}",
                        None))
        elif kind == "batch_bind":
            picks = [names[int(i)] for i in rng.integers(len(names), size=3)]
            items = [{"metadata": {"name": nm, "namespace": pns},
                      "podName": nm,
                      "host": f"node-{int(rng.integers(5))}"}
                     for _, nm in picks]
            out.append(("POST", f"/api/v1/namespaces/{pns}/bindings:batch",
                        {"kind": "BindingList", "apiVersion": "v1",
                         "items": items}))
        elif kind == "service":
            out.append(("POST", f"/api/v1/namespaces/{ns}/services",
                        {"kind": "Service", "apiVersion": "v1",
                         "metadata": {"name": f"svc-{len(out)}",
                                      "namespace": ns},
                         "spec": {"port": 80, "selector": {"app": "web"}}}))
        elif kind == "bad_body":
            out.append(("POST", f"/api/v1/namespaces/{ns}/pods",
                        {"kind": "NoSuchKind", "apiVersion": "v1"}))
        elif kind == "list_ns":
            out.append(("GET", "/api/v1/namespaces", None))
    return out


def test_seeded_differential_run_matches_the_reference():
    ops = _ops(np.random.default_rng(SEED), N_OPS)
    assert len(ops) >= 200
    ref_srv, port_srv = _servers()
    streams, wires = [], []
    try:
        for srv in (ref_srv, port_srv):
            streams.append(_WatchStream(srv, "/api/v1/pods?watch=1"))
            wires.append(_Wire(srv))
        codes = set()
        for i, (method, path, body) in enumerate(ops):
            want = wires[0].call(method, path, body)
            got = wires[1].call(method, path, body)
            assert got == want, (i, method, path, body)
            codes.add((method, want[0]))
        # every outcome the run was built to reach, reached
        assert {(m, c) for m in ("GET", "PUT", "PATCH", "DELETE")
                for c in (200, 404)} <= codes, codes
        assert {("POST", c) for c in (200, 201, 400, 403, 409, 422)} \
            <= codes, codes
        assert ("PUT", 409) in codes, codes
        for w in wires:
            w.close()
        ref_srv.stop()
        port_srv.stop()
        ref_frames, port_frames = (s.frames() for s in streams)
    finally:
        for s in streams:
            s.close()
        ref_srv.stop()
        port_srv.stop()
    assert len(ref_frames) > 50
    assert [f["type"] for f in ref_frames].count("DELETED") > 0
    assert port_frames == ref_frames


# -- the transport's arguments: scheme, TLS, the connect window -----------

TRANSPORTS = pytest.mark.parametrize(
    "transport", [RefHTTPTransport, PortHTTPTransport],
    ids=["reference", "port"])


def _closed_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@TRANSPORTS
def test_transport_takes_the_scheme_it_is_given(transport):
    from kubernetes_tpu.api.latest import scheme as ref_scheme
    from kubernetes_tpu_torch.api.latest import scheme as port_scheme
    mine = port_scheme if transport is PortHTTPTransport else ref_scheme
    assert transport("http://127.0.0.1:1").scheme is mine
    other = types.SimpleNamespace(default_version="v1")
    assert transport("http://127.0.0.1:1", scheme=other).scheme is other


@TRANSPORTS
def test_connect_retry_zero_fails_at_once_on_a_closed_port(transport):
    import time
    c = transport(f"http://127.0.0.1:{_closed_port()}", connect_retry_s=0)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        c.request("list", "pods", namespace="default")
    assert time.monotonic() - t0 < 0.5


@TRANSPORTS
def test_connect_retry_window_retries_then_surfaces(transport):
    import time
    c = transport(f"http://127.0.0.1:{_closed_port()}", connect_retry_s=0.6)
    assert c.connect_retry_s == 0.6
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        c.request("list", "pods", namespace="default")
    assert 0.2 < time.monotonic() - t0 < 3.0


@TRANSPORTS
def test_tls_context_follows_the_arguments(transport, tmp_path):
    import ssl
    assert transport("http://127.0.0.1:1").ssl_context is None
    ctx = transport("https://127.0.0.1:1").ssl_context
    assert ctx.verify_mode == ssl.CERT_REQUIRED and ctx.check_hostname
    ctx = transport("http://127.0.0.1:1",
                    insecure_skip_tls_verify=True).ssl_context
    assert ctx.verify_mode == ssl.CERT_NONE and not ctx.check_hostname
    if _tls_files(tmp_path) is None:
        return
    ca, cert, key = _tls_files(tmp_path)
    ctx = transport("https://127.0.0.1:1", ca_cert=ca).ssl_context
    assert any(c.get("serialNumber") for c in ctx.get_ca_certs())
    ctx = transport("https://127.0.0.1:1", ca_cert=ca, client_cert=cert,
                    client_key=key).ssl_context
    assert ctx.verify_mode == ssl.CERT_REQUIRED


def _tls_files(tmp_path):
    """A self-signed certificate for 127.0.0.1 made by the openssl
    command, or None where it is missing: (ca, cert, key)."""
    import shutil
    import subprocess
    if shutil.which("openssl") is None:
        return None
    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    if not cert.exists():
        proc = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=127.0.0.1", "-addext",
             "subjectAltName=IP:127.0.0.1"],
            capture_output=True, timeout=60)
        if proc.returncode != 0:
            return None
    return str(cert), str(cert), str(key)


@pytest.mark.parametrize("server", ["reference", "port"])
@TRANSPORTS
def test_tls_round_trip_with_a_client_certificate(transport, server,
                                                  tmp_path):
    """Mutual TLS: the server requires a client certificate signed by its
    CA (the same self-signed pair here); each package's transport creates,
    gets and lists through it, and fails verification without the CA. The
    port's watch carries the same context; the reference's watch opens its
    connection without it, so a watch there verifies against the system's
    trust store and refuses a private CA."""
    import ssl
    files = _tls_files(tmp_path)
    if files is None:
        # no openssl here: the context checks above stand in
        test_tls_context_follows_the_arguments(transport, tmp_path)
        return
    ca, cert, key = files
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    sctx.load_verify_locations(ca)
    sctx.verify_mode = ssl.CERT_REQUIRED
    srv_cls, master = ((RefAPIServer, RefMaster) if server == "reference"
                       else (PortAPIServer, PortMaster))
    srv = srv_cls(master(), ssl_context=sctx).start()
    try:
        url = f"https://127.0.0.1:{srv.port}"
        port = transport is PortHTTPTransport
        client_cls = PortClient if port else RefClient
        api = port_api if port else ref_api
        c = client_cls(transport(url, ca_cert=ca, client_cert=cert,
                                 client_key=key, connect_retry_s=0,
                                 timeout=TIMEOUT_S))
        w = c.pods("default").watch(resource_version="0") if port else None
        try:
            c.pods("default").create(api.Pod(
                metadata=api.ObjectMeta(name="tls-pod"),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", image="busybox")])))
            if w is not None:
                ev = w.next_event(timeout=TIMEOUT_S)
                assert ev.object.metadata.name == "tls-pod"
        finally:
            if w is not None:
                w.stop()
        assert c.pods("default").get("tls-pod").metadata.name == "tls-pod"
        names = [p.metadata.name for p in c.pods("default").list().items]
        assert names == ["tls-pod"]
        bad = client_cls(transport(url, connect_retry_s=0,
                                   timeout=TIMEOUT_S))
        with pytest.raises(ssl.SSLError):
            bad.pods("default").list()
    finally:
        srv.stop()


def test_a_burst_of_new_connections_is_queued_not_dropped():
    """64 clients connect at once to an apiserver whose accept loop has
    not started. The reference listens with socketserver's backlog of 5,
    so its kernel queues 6 and drops the other SYNs (a connect then waits a
    retransmit, 1 s or more: a controller's burst of creates, a 1 s health
    probe timing out); the port listens with the system's backlog, as Go's
    net.Listen does, and queues all 64 within half a second."""
    import select
    import socket
    import time

    out = {}
    for name, srv_cls, master in (("reference", RefAPIServer, RefMaster),
                                  ("port", PortAPIServer, PortMaster)):
        srv = srv_cls(master())        # listening; start() would accept
        socks = [socket.socket() for _ in range(64)]
        try:
            for s in socks:
                s.setblocking(False)
                s.connect_ex(("127.0.0.1", srv.port))
            waiting, connected = set(socks), 0
            deadline = time.monotonic() + 0.5
            while waiting and time.monotonic() < deadline:
                _r, done, _x = select.select(
                    [], list(waiting), [], deadline - time.monotonic())
                waiting.difference_update(done)
                connected += sum(s.getsockopt(socket.SOL_SOCKET,
                                              socket.SO_ERROR) == 0
                                 for s in done)
            out[name] = connected
        finally:
            for s in socks:
                s.close()
            srv._httpd.server_close()
    assert out == {"reference": 6, "port": 64}
