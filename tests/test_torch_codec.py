"""The port's v1 wire codec and HTTP client against the JAX package's
apiserver.

The reference apiserver (``kubernetes_tpu.cmd.apiserver``) serves in this
process; what it returns over HTTP — Pods with every field, Nodes,
Services, Events, Binding results, Status errors, lists and watch frames —
must decode in the port (``api/latest.scheme``) and re-encode to JSON
equal to what the reference scheme wrote. Objects built field for field
in both packages encode to the same JSON, a Binding with victims
included. The port's types declare every wire field the reference's do,
over the whole tree of each kind the scheduler decodes, and a field
neither models is ignored as the reference ignores it; a transport asked
for a legacy version speaks it to the reference apiserver, whose legacy
bytes the port decodes and writes again unchanged; a watch at an expired
resourceVersion raises the 410 the reflector relists on, and the port's
reflector over HTTP loses nothing across that relist.
"""

import dataclasses
import datetime
import json
import socket
import typing
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.latest import scheme as ref_scheme
from kubernetes_tpu.api.quantity import Quantity as RefQuantity
from kubernetes_tpu.cmd.apiserver import apiserver_server
from kubernetes_tpu_torch.api import errors as port_errors
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.latest import scheme as port_scheme
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.client.cache import ListWatch, Reflector, Store
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def master():
    port = _free_port()
    ready, stop = threading.Event(), threading.Event()
    t = threading.Thread(target=apiserver_server, args=(
        ["--port", str(port)],), kwargs={"ready": ready, "stop": stop},
        daemon=True)
    t.start()
    assert ready.wait(20), "the reference apiserver never became ready"
    yield f"http://127.0.0.1:{port}"
    stop.set()
    t.join(timeout=10)


def _get(url):
    """-> (status, parsed JSON body)."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _roundtrip(wire):
    """The port's decode then encode of one wire dict, as JSON data."""
    return json.loads(port_scheme.encode(port_scheme.decode_from_wire(wire)))


def _full_pod(api, Q, name, host="", priority=None):
    """A pod using every field group the port models."""
    probe = api.Probe(http_get=api.HTTPGetAction(path="/healthz", port=8080),
                      initial_delay_seconds=3, timeout_seconds=2)
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, namespace="default", uid=f"uid-{name}",
            labels={"app": "web", "tier": "fe"},
            annotations={"note": "full"}),
        spec=api.PodSpec(
            volumes=[api.Volume(name="pd", source=api.VolumeSource(
                gce_persistent_disk=api.GCEPersistentDiskVolumeSource(
                    pd_name="disk-1", fs_type="ext4", read_only=True))),
                api.Volume(name="tmp", source=api.VolumeSource(
                    empty_dir=api.EmptyDirVolumeSource(medium="Memory")))],
            containers=[api.Container(
                name="c", image="img:1", command=["/bin/app"],
                args=["--v", "2"], working_dir="/w",
                ports=[api.ContainerPort(name="http", container_port=8080,
                                         host_port=80, protocol="TCP")],
                env=[api.EnvVar(name="A", value="1")],
                resources=api.ResourceRequirements(
                    limits={"cpu": Q("250m"), "memory": Q("64Mi")},
                    requests={"cpu": Q("100m")}),
                volume_mounts=[api.VolumeMount(name="tmp",
                                               mount_path="/tmp")],
                liveness_probe=probe, readiness_probe=probe,
                lifecycle=api.Lifecycle(pre_stop=api.Handler(
                    exec=api.ExecAction(command=["sleep", "1"]))),
                image_pull_policy="IfNotPresent")],
            restart_policy="OnFailure", termination_grace_period_seconds=30,
            node_selector={"disk": "ssd"}, host=host, priority=priority,
            preemption_policy="Never"),
        status=api.PodStatus(phase="Pending", message="waiting"))


def _bare_pod(name):
    return port_api.Pod(
        metadata=port_api.ObjectMeta(name=name, namespace="default",
                                     uid=f"uid-{name}"),
        spec=port_api.PodSpec(containers=[port_api.Container(name="c",
                                                             image="i")]))


def _node(api, Q, name):
    return api.Node(
        metadata=api.ObjectMeta(name=name, labels={"zone": "z1"}),
        spec=api.NodeSpec(capacity={"cpu": Q("4"), "memory": Q("8Gi"),
                                    "pods": Q("110")},
                          pod_cidr="10.0.0.0/24", external_id=name),
        status=api.NodeStatus(
            phase="Running",
            conditions=[api.NodeCondition(
                type="Ready", status="True", reason="KubeletReady",
                last_probe_time=datetime.datetime(
                    2024, 5, 1, 12, 0, 0, tzinfo=datetime.timezone.utc))],
            addresses=[api.NodeAddress(type="InternalIP",
                                       address="10.0.0.5")],
            node_info=api.NodeSystemInfo(kernel_version="6.1",
                                         kubelet_version="v0")))


def _service(api, name):
    return api.Service(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": "web"},
                             container_port=8080,
                             session_affinity="ClientIP"))


def test_objects_built_alike_encode_alike():
    """The same object tree built through each package's types encodes to
    the same JSON, and decodes back to an equal port object."""
    when = datetime.datetime(2024, 5, 1, 12, 0, 0, 500000,
                             tzinfo=datetime.timezone.utc)
    pairs = [
        (_full_pod(ref_api, RefQuantity, "p", priority=7),
         _full_pod(port_api, PortQuantity, "p", priority=7)),
        (_node(ref_api, RefQuantity, "n"), _node(port_api, PortQuantity, "n")),
        (_service(ref_api, "s"), _service(port_api, "s")),
    ]
    for api in (ref_api, port_api):
        victims = [api.ObjectReference(kind="Pod", namespace="default",
                                       name=f"v{i}", uid=f"u{i}")
                   for i in range(2)]
        b = api.Binding(metadata=api.ObjectMeta(name="p",
                                                namespace="default"),
                        pod_name="p", host="n", victims=victims)
        ev = api.Event(
            metadata=api.ObjectMeta(generate_name="p.", namespace="default"),
            involved_object=api.ObjectReference(kind="Pod", name="p",
                                                namespace="default"),
            reason="Scheduled", message="ok", count=2,
            source=api.EventSource(component="scheduler"),
            first_timestamp=when, last_timestamp=when)
        st = api.Status(status="Failure", code=409, reason="Conflict",
                        message="m", details=api.StatusDetails(
                            name="p", kind="pods", retry_after_seconds=1,
                            causes=[api.StatusCause(reason="r",
                                                    message="c")]))
        pairs_extra = [b, api.BindingList(items=[b]), ev, st,
                       api.BindingResultList(items=[api.BindingResult(
                           pod_name="p", error="conflict", code=409)])]
        if api is ref_api:
            ref_extra = pairs_extra
        else:
            pairs += list(zip(ref_extra, pairs_extra))
    for ref_obj, port_obj in pairs:
        want = ref_scheme.encode(ref_obj)
        assert port_scheme.encode(port_obj) == want
        assert port_scheme.decode(want) == port_obj
        assert port_scheme.encode(port_scheme.decode(want)) == want


def test_what_the_apiserver_returns_decodes_and_reencodes(master):
    client = Client(HTTPTransport(master))
    client.nodes().create(_node(port_api, PortQuantity, "codec-n"))
    client.services().create(_service(port_api, "codec-s"))
    created = client.pods().create(_full_pod(port_api, PortQuantity,
                                             "codec-p"))
    assert created.metadata.uid == "uid-codec-p"
    assert created.spec.containers[0].liveness_probe.http_get.port == 8080
    paths = ["/api/v1/nodes/codec-n", "/api/v1/nodes",
             "/api/v1/namespaces/default/pods/codec-p",
             "/api/v1/namespaces/default/pods",
             "/api/v1/pods?fieldSelector=spec.host%3D",
             "/api/v1/namespaces/default/services/codec-s",
             "/api/v1/services"]
    for path in paths:
        code, wire = _get(master + path)
        assert code == 200, (path, wire)
        assert _roundtrip(wire) == wire, path
    # the typed client gets the same objects
    got = client.pods().get("codec-p")
    assert port_scheme.encode(got) == json.dumps(
        _get(master + "/api/v1/namespaces/default/pods/codec-p")[1],
        sort_keys=True)


def test_status_errors_decode_and_raise(master):
    client = Client(HTTPTransport(master))
    code, wire = _get(master + "/api/v1/namespaces/default/pods/missing")
    assert code == 404 and wire["kind"] == "Status"
    assert _roundtrip(wire) == wire
    with pytest.raises(port_errors.StatusError) as ei:
        client.pods().get("missing")
    assert port_errors.is_not_found(ei.value) and ei.value.code == 404
    client.pods().create(_bare_pod("dup"))
    with pytest.raises(port_errors.StatusError) as ei:
        client.pods().create(_bare_pod("dup"))
    assert ei.value.code == 409
    assert ei.value.status.kind == "Status"


def test_bind_with_victims_and_events_over_the_wire(master):
    client = Client(HTTPTransport(master))
    for name in ("bv-a", "bv-b", "bv-c"):
        client.pods().create(_bare_pod(name))
    client.nodes().create(_node(port_api, PortQuantity, "bv-n"))
    res = client.pods().bind_many(port_api.BindingList(items=[
        port_api.Binding(metadata=port_api.ObjectMeta(
            name=n, namespace="default"), pod_name=n, host="bv-n")
        for n in ("bv-a", "bv-b")]))
    assert [(r.pod_name, r.error) for r in res.items] == \
        [("bv-a", ""), ("bv-b", "")]
    # an atomic evict+bind: the victim is deleted, the pod bound
    victim = client.pods().get("bv-a")
    res = client.pods().bind_many(port_api.BindingList(items=[
        port_api.Binding(metadata=port_api.ObjectMeta(
            name="bv-c", namespace="default"), pod_name="bv-c", host="bv-n",
            victims=[port_api.ObjectReference(
                kind="Pod", namespace="default", name="bv-a",
                uid=victim.metadata.uid)])]))
    assert res.items[0].error == ""
    assert client.pods().get("bv-c").spec.host == "bv-n"
    with pytest.raises(port_errors.StatusError):
        client.pods().get("bv-a")
    # a stale victim uid fails the item, applying nothing
    res = client.pods().bind_many(port_api.BindingList(items=[
        port_api.Binding(metadata=port_api.ObjectMeta(
            name="bv-c", namespace="default"), pod_name="bv-c", host="bv-n",
            victims=[port_api.ObjectReference(
                kind="Pod", namespace="default", name="bv-b",
                uid="not-its-uid")])]))
    assert res.items[0].error and res.items[0].code == 409
    assert client.pods().get("bv-b").spec.host == "bv-n"
    ev = client.events().create(port_api.Event(
        metadata=port_api.ObjectMeta(generate_name="bv-c.",
                                     namespace="default"),
        involved_object=port_api.ObjectReference(kind="Pod", name="bv-c",
                                                 namespace="default"),
        reason="Scheduled", message="assigned", count=1,
        source=port_api.EventSource(component="scheduler")))
    assert ev.metadata.name.startswith("bv-c.")
    code, wire = _get(master + "/api/v1/namespaces/default/events")
    assert code == 200 and wire["items"]
    assert _roundtrip(wire) == wire


def test_watch_frames_decode_and_reencode(master):
    client = Client(HTTPTransport(master))
    rv = client.pods().list().metadata.resource_version
    raw = urllib.request.urlopen(
        f"{master}/api/v1/watch/namespaces/default/pods?resourceVersion={rv}",
        timeout=10)
    w = client.pods().watch(resource_version=rv)
    try:
        client.pods().create(_full_pod(port_api, PortQuantity, "w-p"))
        client.nodes().create(_node(port_api, PortQuantity, "w-n"))
        client.pods().bind_many(port_api.BindingList(items=[
            port_api.Binding(metadata=port_api.ObjectMeta(
                name="w-p", namespace="default"), pod_name="w-p",
                host="w-n")]))
        frames = [json.loads(raw.readline()) for _ in range(2)]
        assert [f["type"] for f in frames] == ["ADDED", "MODIFIED"]
        for f in frames:
            assert _roundtrip(f["object"]) == f["object"]
        evs = [w.next_event(timeout=10) for _ in range(2)]
        assert [e.type for e in evs] == ["ADDED", "MODIFIED"]
        assert evs[1].object.spec.host == "w-n"
        assert port_scheme.encode(evs[1].object) == json.dumps(
            frames[1]["object"], sort_keys=True)
    finally:
        w.stop()
        raw.close()


def _dataclasses_reached(cls, seen):
    """``cls`` and every dataclass its field hints reach, into ``seen``."""
    if cls in seen:
        return
    seen.add(cls)
    stack = list(typing.get_type_hints(cls).values())
    while stack:
        hint = stack.pop()
        if dataclasses.is_dataclass(hint) and isinstance(hint, type):
            _dataclasses_reached(hint, seen)
        stack.extend(typing.get_args(hint))


@pytest.mark.parametrize("kind", [
    "Pod", "PodList", "Node", "NodeList", "Service", "ServiceList",
    "Binding", "BindingList", "BindingResultList", "Event", "EventList",
    "Status"])
def test_port_types_carry_every_reference_wire_field(kind):
    """Over the whole type tree of each kind the scheduler lists, watches,
    posts or gets back as an error, the port's class of the same name
    declares every field of the reference's under the same wire name, so
    a decoded object drops nothing the apiserver wrote."""
    def wire_fields(cls):
        return {(f.name, f.metadata.get("wire"))
                for f in dataclasses.fields(cls)}

    reached: set = set()
    _dataclasses_reached(getattr(ref_api, kind), reached)
    for ref_cls in reached:
        port_cls = getattr(port_api, ref_cls.__name__)
        missing = wire_fields(ref_cls) - wire_fields(port_cls)
        assert not missing, f"{ref_cls.__name__} lacks {sorted(missing)}"


def test_unknown_wire_fields_are_ignored_as_the_reference_ignores_them():
    wire = json.loads(ref_scheme.encode(_full_pod(ref_api, RefQuantity, "x")))
    extra = json.loads(json.dumps(wire))
    extra["spec"]["containers"][0]["newField"] = True
    extra["newTopLevel"] = {"a": 1}
    assert port_scheme.decode_from_wire(extra) == \
        port_scheme.decode_from_wire(wire)
    assert ref_scheme.decode_from_wire(extra) == \
        ref_scheme.decode_from_wire(wire)
    for scheme in (port_scheme, ref_scheme):
        with pytest.raises(Exception):
            scheme.decode_from_wire({"kind": "NoSuchKind",
                                     "apiVersion": "v1"})


def test_legacy_wire_versions_are_not_ported(master):
    """The legacy wire, once refused, is now spoken (the name is the
    case's first one): the port's transport in v1beta1 and v1beta2
    creates a pod with every field group on the reference apiserver and
    reads back what a v1 transport reads; the reference's bytes of it, single and as a list,
    decode in the port and encode again to the same JSON."""
    assert HTTPTransport(master, version="v1").version == "v1"
    for version in ("v1beta1", "v1beta2"):
        transport = HTTPTransport(master, version=version)
        assert transport.version == version
        pods = Client(transport).pods("default")
        name = f"legacy-{version}"
        pods.create(_full_pod(port_api, PortQuantity, name))
        assert pods.get(name) == \
            Client(HTTPTransport(master)).pods("default").get(name)
        status, one = _get(f"{master}/api/{version}/pods/{name}"
                           f"?namespace=default")
        assert status == 200 and one["apiVersion"] == version
        assert one["id"] == name and "desiredState" in one
        status, lst = _get(f"{master}/api/{version}/pods?namespace=default")
        assert status == 200 and lst["kind"] == "PodList"
        for wire in (one, lst):
            obj = port_scheme.decode_from_wire(wire)
            assert json.loads(port_scheme.encode(obj, version)) == wire
            assert port_scheme.encode(obj, version) == \
                ref_scheme.encode(ref_scheme.decode_from_wire(wire), version)


def test_expired_watch_raises_410_and_the_reflector_relists(master):
    client = Client(HTTPTransport(master))
    pods = client.pods("window")

    def pod(name):
        return port_api.Pod(
            metadata=port_api.ObjectMeta(name=name, namespace="window"),
            spec=port_api.PodSpec(containers=[port_api.Container(
                name="c", image="i")]))

    # push resourceVersion 1 out of the server's watch window
    # (MemStore.HISTORY_WINDOW = 1000 events)
    for i in range(1010):
        pods.create(pod(f"win-{i}"))
    with pytest.raises(port_errors.StatusError) as ei:
        pods.watch(resource_version="1")
    assert port_errors.is_resource_expired(ei.value)
    assert ei.value.code == 410

    lists = []

    def list_fn():
        out = pods.list()
        if not lists:
            out.metadata.resource_version = "1"   # a stale first list
        lists.append(out.metadata.resource_version)
        return out

    store = Store()
    r = Reflector(ListWatch(list_fn, lambda rv: pods.watch(
        resource_version=rv)), store, name="codec-reflector").run()
    try:
        deadline = time.monotonic() + 20
        while len(lists) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(lists) >= 2, "the reflector never relisted"
        for i in range(5):
            pods.create(pod(f"after-{i}"))
        while len(store) < 1015 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(store) == 1015
    finally:
        r.stop()
        assert r.join(5)
