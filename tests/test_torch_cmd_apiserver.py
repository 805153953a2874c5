"""The port's kube-apiserver binary (cmd/apiserver.py).

``python -m kubernetes_tpu_torch.cmd.apiserver`` runs as a subprocess
under a launcher that refuses any import of ``jax`` or ``kubernetes_tpu``
(and of ``torch`` and ``numpy``: the apiserver is host code),
with token and basic auth files, an ABAC policy, a CORS allow-list, the
read-only port, a watch lag bound, ``--trace`` and ``--flightrec``:
authentication and authorization answer 401/403/2xx, the port's client
creates, lists, binds in a batch and watches through it, and ``/healthz``,
``/version``, ``/validate``, ``/metrics`` (fairshed's and the request
families), ``/ui/``, ``/debug/pprof/``, ``/debug/trace`` and
``/debug/vars`` answer. Each store option builds the store the reference
builds for it and ``--share-seg`` wires the share segment as the
reference does; ``--cloud-provider`` gives the service registry the
reference's provider (none for an unknown name), and the legacy
v1beta1/v1beta2 wire is served and spoken with the reference's bytes.
Every process stops in a ``finally``; every HTTP read has a timeout.
"""

import base64
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from chip_smoke import _free_port, _stop_process, _wait_http
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.http import APIServer
from kubernetes_tpu_torch.apiserver.master import Master
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport
from kubernetes_tpu_torch.cmd.apiserver import build_parser, build_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 10.0

# runs the port's binary with jax, the reference package, torch and numpy
# unimportable
LAUNCHER = r"""
import importlib.abc, runpy, sys
BAD = ("jax", "jaxlib", "kubernetes_tpu", "torch", "numpy")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = ["kube-apiserver"] + sys.argv[1:]
runpy.run_module("kubernetes_tpu_torch.cmd.apiserver", run_name="__main__",
                 alter_sys=True)
"""


def test_parser_flags_accept_go_style_underscores():
    opts = build_parser().parse_args(["--portal_net", "10.1.0.0/24"])
    assert opts.portal_net == "10.1.0.0/24"
    opts = build_parser().parse_args(["--portal-net", "10.2.0.0/24"])
    assert opts.portal_net == "10.2.0.0/24"
    opts = build_parser().parse_args([])
    assert opts.fairshed is True
    assert opts.admission_control == ("NamespaceAutoProvision,"
                                      "NamespaceLifecycle,LimitRanger,"
                                      "ResourceQuota,PriorityDefault")


@pytest.mark.parametrize("flags,item", [
    (["--cloud-provider", "fake"], "FakeCloud"),
    (["--cloud-provider", "no-such-cloud"], None),
], ids=["cloud-provider", "cloud-provider-unknown"])
def test_options_left_for_later_raise(flags, item):
    """The one option once left for a later slice, ``--cloud-provider``,
    now builds what the reference's binary builds: the named provider of
    ``cloudprovider/`` in the service registry (its external load
    balancers), and no cloud for a name no provider registered, as
    ``get_provider`` answers in both packages."""
    from kubernetes_tpu.cmd import apiserver as ref_apiserver
    built = []
    try:
        for parse, build in ((build_parser, build_server),
                             (ref_apiserver.build_parser,
                              ref_apiserver.build_server)):
            srv = build(parse().parse_args(["--port", "0", *flags])).start()
            built.append(srv)
            cloud = srv.master.services.cloud
            assert (None if cloud is None else type(cloud).__name__) == item
        port_cloud = built[0].master.services.cloud
        if item is not None:
            assert type(port_cloud).__module__ == \
                "kubernetes_tpu_torch.cloudprovider.cloud"
            assert built[0].master.services.node_lister() == []
    finally:
        for srv in built:
            srv.stop()


def _wiring(srv):
    """(store class, share worker or None, fairshed ledger attached?)"""
    share = srv.share
    return (type(srv.master.store).__name__,
            None if share is None else share.worker_index,
            srv.fairshed is not None and srv.fairshed._ledger is not None)


@pytest.mark.parametrize("flags,want", [
    (["--store-server", "{store}"], ("RemoteStore", None, False)),
    (["--data-dir", "{dir}"], ("DurableStore", None, False)),
    (["--store-shards", "4"], ("StripedStore", None, False)),
    (["--data-dir", "{dir}", "--store-shards", "4"],
     ("DurableStripedStore", None, False)),
    (["--store-server", "{store}", "--data-dir", "{dir}",
      "--store-shards", "4"], ("RemoteStore", None, False)),
    (["--share-seg", "{seg}", "--share-worker", "1"],
     ("MemStore", 1, True)),
    (["--store-server", "{store}", "--share-seg", "{seg}",
      "--share-worker", "0", "--reuse-port"], ("RemoteStore", 0, True)),
], ids=["store-server", "data-dir", "shards-4", "data-dir-shards-4",
        "store-server-first", "share-seg", "fleet-worker"])
def test_store_options_build_the_reference_store(flags, want, tmp_path):
    """Each store flag builds the store the reference's binary picks for
    it (``--store-server`` first, then ``--data-dir``, striped with
    ``--store-shards`` > 1, then ``--store-shards`` alone), and
    ``--share-seg`` wires one segment into the server and fairshed's
    ledger, as both packages' binaries do for the same flags."""
    from kubernetes_tpu.apiserver.share import ShareSegment as RefSegment
    from kubernetes_tpu.cmd import apiserver as ref_apiserver
    from kubernetes_tpu_torch.storage.remote import StoreServer
    store_srv = StoreServer().start()
    RefSegment.create(str(tmp_path / "seg"), 2)
    built = []
    try:
        for n, (parse, build) in enumerate((
                (build_parser, build_server),
                (ref_apiserver.build_parser, ref_apiserver.build_server))):
            args = [a.format(store=store_srv.address, seg=tmp_path / "seg",
                             dir=tmp_path / f"data{n}") for a in flags]
            srv = build(parse().parse_args(["--port", "0", *args])).start()
            built.append(srv)
            assert _wiring(srv) == want, (n, flags)
        port_srv, ref_srv = built
        assert type(port_srv.master.store).__module__ == \
            "kubernetes_tpu_torch." + \
            type(ref_srv.master.store).__module__[len("kubernetes_tpu."):]
    finally:
        for srv in built:
            srv.stop()
            if srv.share is not None:
                srv.share.close()
        store_srv.stop()


def test_legacy_wire_is_refused_and_not_served():
    """The legacy wire, once refused, is now served and spoken (the name
    is the case's first one): the port's server lists v1, v1beta1 and
    v1beta2 under /api, and the same minion and pod created through the
    port's client in each legacy version, then read back by name, as a
    list and under the legacy field selector, give the reference
    server's status codes and bodies (UIDs and timestamps normalized)."""
    from kubernetes_tpu.apiserver.http import APIServer as RefAPIServer
    from kubernetes_tpu.apiserver.master import Master as RefMaster
    from test_torch_apiserver_wire import _norm
    servers = (RefAPIServer(RefMaster()).start(), APIServer(Master()).start())
    seen = []
    try:
        for srv in servers:
            code, body, _ = _get(srv.base_url + "/api")
            assert (code, json.loads(body)["versions"]) == \
                (200, ["v1", "v1beta1", "v1beta2"])
            got = []
            for version in ("v1beta1", "v1beta2"):
                transport = HTTPTransport(srv.base_url, version=version)
                assert transport.version == version
                c = Client(transport)
                c.nodes().create(api.Node(
                    metadata=api.ObjectMeta(name=f"n-{version}"),
                    spec=api.NodeSpec(capacity={})))
                c.pods().create(api.Pod(
                    metadata=api.ObjectMeta(name=f"p-{version}",
                                            namespace="default"),
                    spec=api.PodSpec(containers=[api.Container(
                        name="c", image="img")])))
                assert c.pods().get(f"p-{version}").metadata.name == \
                    f"p-{version}"
                base = f"{srv.base_url}/api/{version}"
                for path in (f"/minions/n-{version}",
                             f"/pods/p-{version}?namespace=default",
                             "/minions",
                             "/pods?namespace=default"
                             "&fields=DesiredState.Host%3D"):
                    code, body, _ = _get(base + path)
                    got.append((code, _norm(json.loads(body))))
            seen.append(got)
    finally:
        for srv in servers:
            srv.stop()
    want, got = seen
    assert got == want
    assert [code for code, _ in got] == [200] * 8
    minion, pod = got[0][1], got[1][1]
    assert (minion["kind"], minion["id"]) == ("Minion", "n-v1beta1")
    assert pod["desiredState"]["manifest"]["version"] == "v1beta1"
    assert len(got[6][1]["items"]) == 2 and "minions" not in got[6][1]
    assert len(got[2][1]["minions"]) == 1


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_the_binary_serves_the_default_path(tmp_path):
    (tmp_path / "tokens.csv").write_text(
        "tok-admin,admin,u1\ntok-viewer,viewer,u2\ntok-nobody,nobody,u3\n")
    (tmp_path / "basic.csv").write_text("pw-admin,admin-basic,u4\n")
    (tmp_path / "policy.jsonl").write_text(
        '{"user": "admin"}\n{"user": "admin-basic"}\n'
        '{"user": "viewer", "readonly": true}\n')
    port, ro_port = _free_port(), _free_port()
    log = open(tmp_path / "apiserver.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, "--port", str(port),
         "--read-only-port", str(ro_port), "--api-rate", "1000",
         "--token-auth-file", str(tmp_path / "tokens.csv"),
         "--basic-auth-file", str(tmp_path / "basic.csv"),
         "--authorization-policy-file", str(tmp_path / "policy.jsonl"),
         "--cors-allowed-origins", r"https://ui\.example\.com",
         "--watch-lag-limit", "1000", "--trace", "--flightrec"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    url, ro = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{ro_port}"
    admin = {"Authorization": "Bearer tok-admin"}
    try:
        assert _wait_http(ro + "/healthz/ping", proc,
                          "the port's apiserver", 60.0) == "ok"
        assert _get(url + "/healthz/ping")[0] == 401
        pods = url + "/api/v1/namespaces/default/pods"
        pod = {"kind": "Pod", "apiVersion": "v1",
               "metadata": {"name": "p0", "namespace": "default"},
               "spec": {"containers": [{"name": "c", "image": "img"}]}}
        # authentication, then ABAC: admin writes, viewer only reads,
        # nobody matches no line; basic auth works too
        assert _get(pods)[0] == 401
        assert _get(pods, {"Authorization": "Bearer bad"})[0] == 401
        assert _post(pods, pod, {"Authorization": "Bearer tok-viewer"}) \
            == 403
        assert _get(pods, {"Authorization": "Bearer tok-nobody"})[0] == 403
        assert _post(pods, pod, admin) == 201
        basic = base64.b64encode(b"admin-basic:pw-admin").decode()
        assert _get(pods, {"Authorization": "Basic " + basic})[0] == 200
        code, body, _ = _get(pods, {"Authorization": "Bearer tok-viewer"})
        assert code == 200
        assert [p["metadata"]["name"] for p in json.loads(body)["items"]] \
            == ["p0"]

        # the port's client through the token: create, batch bind, watch
        client = Client(HTTPTransport(url, auth=("bearer", "tok-admin"),
                                      timeout=TIMEOUT_S))
        w = client.pods().watch()
        try:
            client.nodes().create(api.Node(
                metadata=api.ObjectMeta(name="n1"),
                spec=api.NodeSpec(capacity={})))
            client.pods().create(api.Pod(
                metadata=api.ObjectMeta(name="p1", namespace="default"),
                spec=api.PodSpec(containers=[
                    api.Container(name="c", image="img")])))
            res = client.pods().bind_many(api.BindingList(items=[
                api.Binding(metadata=api.ObjectMeta(
                    name=n, namespace="default"), pod_name=n, host="n1")
                for n in ("p0", "p1")]))
            assert [r.error for r in res.items] == ["", ""]
            seen = [(ev.type, ev.object.metadata.name, ev.object.spec.host)
                    for ev in (w.next_event(timeout=TIMEOUT_S)
                               for _ in range(3))]
        finally:
            w.stop()
        assert seen == [("ADDED", "p1", ""), ("MODIFIED", "p0", "n1"),
                        ("MODIFIED", "p1", "n1")]

        # the read-only port: no credentials, so the policy (no line for
        # the anonymous user) refuses its reads; its writes are refused
        # before authorization
        code, body, _ = _get(ro + "/api/v1/namespaces/default/pods")
        assert code == 403 and "<anonymous>" in body
        req = urllib.request.Request(
            ro + "/api/v1/namespaces/default/pods",
            data=json.dumps(pod).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT_S)
        assert ei.value.code == 403
        assert "read-only" in ei.value.read().decode()

        # CORS for an allowed origin only
        hdrs = _get(url + "/version",
                    dict(admin, Origin="https://ui.example.com"))[2]
        assert hdrs.get("Access-Control-Allow-Origin") == \
            "https://ui.example.com"
        assert "Access-Control-Allow-Origin" not in _get(
            url + "/version", dict(admin, Origin="https://evil.example.net"))[2]

        # the unversioned and debug endpoints (the health probes run as
        # the anonymous user, whom the policy denies, on either port)
        assert json.loads(_get(url + "/version", admin)[1])["gitVersion"]
        code, body, _ = _get(ro + "/healthz")
        assert code == 503 and json.loads(body)["healthy"] is False
        assert "/validate" in json.loads(_get(ro + "/")[1])["paths"]
        metrics = _get(url + "/metrics", admin)[1]
        for family in ("apiserver_request_count",
                       "apiserver_batch_bind_size", "request_admitted_total",
                       "apiserver_watch_frame_cache_hits_total"):
            assert family in metrics, family
        code, body, hdrs = _get(url + "/ui/", admin)
        assert code == 200 and hdrs["Content-Type"].startswith("text/html")
        assert _get(url + "/debug/pprof/", admin)[0] == 200
        trace = json.loads(_get(url + "/debug/trace?peek=1", admin)[1])
        assert isinstance(trace, dict)
        vars_ = json.loads(_get(url + "/debug/vars?since=0", admin)[1])
        assert vars_["service"] == "apiserver"
        assert "apiserver_request_count" in json.dumps(vars_["series"])
    finally:
        _stop_process(proc)
    text = (tmp_path / "apiserver.log").read_text()
    assert "refused import" not in text, text
    assert "kube-apiserver listening on" in text, text


def test_apiserver_time_tool_turn_on_the_cpu(tmp_path):
    """tools/apiserver_time.py's turn: the port's binary seeded and bound
    at 20 nodes, every pod read back bound."""
    from kubernetes_tpu_torch.tools import apiserver_time
    r = apiserver_time.turn("kubernetes_tpu_torch.cmd.apiserver", 20, 2,
                            str(tmp_path / "apiserver.log"))
    assert (r["nodes"], r["pods"]) == (20, 40)
    assert r["creates_per_s"] > 0 and r["binds_per_s"] > 0
