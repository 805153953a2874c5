"""The port's BatchScheduler (the causal wave loop) against the JAX
package's, on the CPU.

(a) Both packages' BatchSchedulers, each over its own FakeClient-backed
    ConfigFactory (tools/fake_cluster.FakeCluster with that package's
    types), are fed one seeded event sequence — arrivals, binds,
    deletions, a node added, an unschedulable pod requeued, a gang below
    quorum, a lost changelog cursor — and called with ``schedule_wave()``
    in turn: both must bind the same pods to the same hosts, wave by wave,
    and those hosts are the serial oracle's for the wave. The waves take
    all three encode paths (delta, journal replay, full list).
(b) The scenario of tests/test_tpu_batch.py against the JAX package's
    apiserver (``Master``), reached through a test-only transport that
    converts objects between the two packages by field name.
(c) What the port does not do yet raises NotImplementedError naming its
    ROADMAP item: the pipelined loop, the solver daemon, the device mesh,
    the boot prewarm; and the default device needs a card.
(d) Preemption: a preempting pod binds with its victims through the
    FakeCluster's and the apiserver's atomic evict+bind; a binder without
    ``bind_many`` commits pod by pod.
"""

import dataclasses
import json
import random
import threading
import time

import jax

jax.config.update("jax_enable_x64", True)

import pytest
import torch

from kubernetes_tpu.api import errors as ref_errors
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.quantity import Quantity as RefQuantity
from kubernetes_tpu.apiserver.master import Master
from kubernetes_tpu.client.client import FakeClient as RefFakeClient
from kubernetes_tpu.client.client import InProcessTransport
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.models.oracle import solve_serial
from kubernetes_tpu.runtime.clone import deep_clone as ref_clone
from kubernetes_tpu.scheduler import driver as ref_driver
from kubernetes_tpu.scheduler import tpu_batch as ref_tpu_batch
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu.util import metrics as ref_metrics
from kubernetes_tpu_torch import watch as port_watch
from kubernetes_tpu_torch.api import errors as port_errors
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.client.client import Client as PortClient
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler.plugins import \
    load_policy as port_load_policy
from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from kubernetes_tpu_torch.util import metrics as port_metrics
from test_torch_batch_solver import REF
from test_torch_policy import to_port

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def gang_pod(name, group, quorum, **kw):
    return REF.pod(name, annotations={
        ref_gang.GANG_NAME_ANNOTATION: group,
        ref_gang.GANG_MIN_MEMBERS_ANNOTATION: str(quorum)}, **kw)


# -- (a) both schedulers, one event sequence ---------------------------------

class Side:
    """One package's scheduler over its own fake cluster."""

    def __init__(self, name, world, mk, policy_json=None):
        self.name = name
        nodes, bound, pending, services = (mk(list(x)) for x in world)
        if name == "ref":
            self.cluster = FakeCluster(nodes, bound, pending, services,
                                       api=ref_api, client_cls=RefFakeClient,
                                       errors=ref_errors, clone=ref_clone)
            drv, sched_cls, kw = ref_driver, ref_tpu_batch.BatchScheduler, {}
        else:
            self.cluster = FakeCluster(nodes, bound, pending, services)
            drv, sched_cls, kw = port_driver, BatchScheduler, {
                "device": "cpu"}
        self.mk = mk
        self.factory = drv.ConfigFactory(self.cluster.client,
                                         node_poll_period=3600)
        self.cluster.attach(self.factory)
        load = ref_load_policy if name == "ref" else port_load_policy
        self.config = self.factory.create(
            policy=load(policy_json) if policy_json else None)
        # the factory's handler requeues from one thread per pod, in no
        # fixed order; here the failed pods requeue after the wave, in the
        # order the wave failed them, so both sides see one FIFO order
        self.failed = []
        self.config.error = lambda pod, err: self.failed.append(pod)
        self.sched = sched_cls(self.config, self.factory, self.cluster.client,
                               wave_size=256, wave_linger_s=0.01, **kw)
        self.cluster.wait_synced()
        self.waves = []
        inner = self.sched._prepare_wave

        def record(pods):
            prep = inner(pods)
            self.waves.append(None if prep is None else prep[0])
            return prep

        self.sched._prepare_wave = record

    def placement(self):
        return {p.metadata.name: p.spec.host for p in self.cluster.bound()}

    def wave(self):
        before = self.placement()
        existing = self.cluster.bound()
        nodes = self.config.minion_lister.list().items
        services = self.factory.service_store.list()
        self.sched.schedule_wave(timeout=1.0)
        for pod in self.failed:
            fresh = self.cluster.client.pods(pod.metadata.namespace).get(
                pod.metadata.name)
            if not fresh.spec.host:
                self.factory.pod_queue.add(fresh)
        self.failed.clear()
        after = self.placement()
        binds = {k: v for k, v in after.items() if before.get(k) != v}
        return binds, (nodes, existing, self.waves[-1], services)

    def stop(self):
        assert self.factory.stop(join=True)


def _counts():
    return [(m.slipstream_metrics().resync_replay.total(),
             m.slipstream_metrics().resync_full.total())
            for m in (ref_metrics, port_metrics)]


def test_both_schedulers_bind_the_same_pods_wave_by_wave():
    rng = random.Random(42)
    nodes = [REF.node(f"n{i}", cpu_m=rng.choice([2000, 4000]),
                      mem=rng.choice([4 << 30, 8 << 30]),
                      labels={"zone": f"z{i % 2}"}) for i in range(6)]
    services = [REF.svc("web", {"app": "web"}), REF.svc("db", {"app": "db"})]

    def pod(name, **kw):
        kw.setdefault("cpu_m", rng.choice([100, 300, 500]))
        kw.setdefault("mem", rng.choice([128 << 20, 512 << 20]))
        kw.setdefault("labels", {"app": rng.choice(["web", "db", "x"])})
        if rng.random() < 0.2:
            kw.setdefault("host_ports", (rng.choice([8080, 9090]),))
        return REF.pod(name, **kw)

    bound = [pod(f"old{i}", host=f"n{i % 6}") for i in range(8)]
    pending = [pod(f"a{i}") for i in range(10)]
    pending.append(pod("huge", cpu_m=64000))
    pending += [gang_pod(f"g-m{m}", "g", 3, cpu_m=200) for m in range(2)]
    world = (nodes, bound, pending, services)
    sides = [Side("ref", world, lambda x: x),
             Side("port", world, to_port)]
    try:
        def wave(queued_after):
            out = [s.wave() for s in sides]
            assert out[0][0] == out[1][0], "the waves bound differently"
            nodes_w, existing, order, svcs = out[0][1]
            want = solve_serial(nodes_w, existing, order, svcs, gangs=True)
            assert {p.metadata.name: h for p, h in zip(order, want)
                    if h} == out[0][0]
            for s in sides:
                assert len(s.factory.pod_queue) == queued_after
            return out[0][0]

        c0 = _counts()
        # wave 1: the first full sync; the gang is below quorum and the
        # huge pod fits nowhere: both are requeued
        got = wave(queued_after=3)
        assert len(got) == 10 and "huge" not in got
        assert [c[1] for c in _counts()] == [c[1] + 1 for c in c0]
        # churn: three bound pods deleted, arrivals, the gang's third
        # member (quorum reached), all as deltas
        arrivals = [pod(f"b{i}") for i in range(5)]
        arrivals.append(gang_pod("g-m2", "g", 3, cpu_m=200))
        for s in sides:
            gone = [p for p in s.cluster.bound()
                    if p.metadata.name in ("old1", "old4", "old6")]
            s.cluster.delete_bound(gone)
            s.cluster.add_pending(s.mk(arrivals))
        c1 = _counts()
        got = wave(queued_after=1)
        assert {"g-m0", "g-m1", "g-m2"} <= set(got)
        assert _counts() == c1          # the delta path: no resync
        # a lost changelog cursor: journal replay, no full re-encode
        arrivals = [pod("c0")]
        for s in sides:
            s.sched._delta_token = None
            s.cluster.add_pending(s.mk(arrivals))
        c2 = _counts()
        wave(queued_after=1)
        assert [c[0] for c in _counts()] == [c[0] + 1 for c in c2]
        assert [c[1] for c in _counts()] == [c[1] for c in c2]
        # a node big enough for the huge pod: the node planes rebuild and
        # the wave resyncs through the full list
        big = REF.node("n9", cpu_m=128000, mem=64 << 30)
        for s in sides:
            s.cluster.add_node(s.mk(big))
        c3 = _counts()
        got = wave(queued_after=0)
        assert got["huge"] == "n9"
        assert [c[1] for c in _counts()] == [c[1] + 1 for c in c3]
        assert sides[1].placement() == sides[0].placement()
    finally:
        for s in sides:
            s.stop()


def test_service_affinity_policy_takes_the_full_encoder():
    """A CheckServiceAffinity policy (which the incremental encoder
    refuses) re-encodes the cluster every wave with encode_snapshot; both
    packages still bind alike, and as the oracle under that policy."""
    text = json.dumps({
        "predicates": [{"name": "PodFitsResources"},
                       {"name": "region", "argument": {
                           "serviceAffinity": {"labels": ["region"]}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]})
    nodes = [REF.node(f"n{i}", labels={"region": f"r{i % 2}"})
             for i in range(4)]
    services = [REF.svc("web", {"app": "web"})]
    bound = [REF.pod("peer", cpu_m=100, labels={"app": "web"}, host="n1")]
    pending = [REF.pod(f"w{i}", cpu_m=300, labels={"app": "web"})
               for i in range(5)] + [REF.pod("free", cpu_m=100)]
    world = (nodes, bound, pending, services)
    sides = [Side("ref", world, lambda x: x, text),
             Side("port", world, to_port, text)]
    try:
        assert sides[1].sched._encoder is None
        out = [s.wave() for s in sides]
        assert out[0][0] == out[1][0]
        nodes_w, existing, order, svcs = out[0][1]
        want = solve_serial(nodes_w, existing, order, svcs,
                            policy=ref_load_policy(text), gangs=True)
        assert {p.metadata.name: h for p, h in zip(order, want)
                if h} == out[0][0]
        # the service's pods follow their peer into region r1
        assert {out[0][0][f"w{i}"] for i in range(5)} <= {"n1", "n3"}
    finally:
        for s in sides:
            s.stop()


def test_chip_smoke_scheduler_phase_runs_on_the_cpu_at_a_small_size():
    """chip_smoke's phase 7 at a small size, on the plain version: every
    pending pod binds, the encode takes full, delta, then full after the
    node add, and each wave equals solve(encode_snapshot(...)) of its
    state (the phase raises otherwise)."""
    import chip_smoke
    from kubernetes_tpu_torch.ops import commit_solver

    launches = commit_solver.solve_commit.launches
    sc = chip_smoke._scheduler_phase(
        "cpu", n_nodes=40, n_pending=300, n_churn=70, n_deleted=20,
        n_last=32, wave_size=32, count_launches=False)
    stages = [w["stage"] for w in sc["waves"]]
    assert stages == ["north_star"] * 10 + ["churn"] * 3 + ["node added"]
    assert [w["path"] for w in sc["waves"]] == \
        ["full"] + ["delta"] * 12 + ["full"]
    assert sum(w["bound"] for w in sc["waves"]) == 300 + 70 + 32
    assert commit_solver.solve_commit.launches == launches


def test_events_and_requeue_of_an_unschedulable_pod():
    """FailedScheduling and Scheduled events go through the port's
    EventRecorder; an unschedulable pod is requeued by the error handler
    and binds once a node fits it."""
    nodes = [REF.node("tiny", cpu_m=1000, mem=1 << 30)]
    pending = [REF.pod("big", cpu_m=4000), REF.pod("ok", cpu_m=100)]
    cluster = FakeCluster(to_port(nodes), [], to_port(pending), [])
    factory = port_driver.ConfigFactory(cluster.client, node_poll_period=3600)
    factory.backoff = port_driver.PodBackoff(initial=0.02, max_duration=0.05)
    cluster.attach(factory)
    recorder = EventRecorder(cluster.client,
                             port_api.EventSource(component="scheduler"))
    config = factory.create(recorder=recorder)
    sched = BatchScheduler(config, factory, cluster.client, wave_size=8,
                           wave_linger_s=0.01, device="cpu")
    try:
        cluster.wait_synced()
        assert sched.schedule_wave(timeout=1.0) == 1
        reasons = [(a.kw["body"].involved_object.name, a.kw["body"].reason)
                   for a in cluster.client.actions_of("create", "events")]
        assert ("big", "FailedScheduling") in reasons
        assert ("ok", "Scheduled") in reasons
        assert _wait(lambda: len(factory.pod_queue) == 1)
        cluster.add_node(to_port(REF.node("large", cpu_m=8000,
                                          mem=8 << 30)))
        assert sched.schedule_wave(timeout=1.0) == 1
        assert {p.metadata.name: p.spec.host for p in cluster.bound()} == \
            {"ok": "tiny", "big": "large"}
    finally:
        assert factory.stop(join=True)


# -- (b) the port's scheduler against the JAX package's apiserver ------------

def _convert(obj, api, quantity):
    """An API object tree -> the same tree in ``api``'s types, field by
    field (fields the target lacks are dropped)."""
    if isinstance(obj, (RefQuantity, PortQuantity)):
        return quantity(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(api, type(obj).__name__)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{f.name: _convert(getattr(obj, f.name), api, quantity)
                      for f in dataclasses.fields(obj) if f.name in names})
    if isinstance(obj, dict):
        return {k: _convert(v, api, quantity) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_convert(v, api, quantity) for v in obj)
    return obj


class _BridgeTransport:
    """The port's client -> the JAX package's Master: bodies go over as
    the reference's types, results, errors and watch events come back as
    the port's."""

    def __init__(self, master):
        self.inner = InProcessTransport(master)

    def request(self, verb, resource, **kw):
        if kw.get("body") is not None:
            kw["body"] = _convert(kw["body"], ref_api, RefQuantity)
        try:
            out = self.inner.request(verb, resource, **kw)
        except ref_errors.StatusError as e:
            raise port_errors.StatusError(
                _convert(e.status, port_api, PortQuantity)) from e
        if verb == "watch":
            return self._bridge_watch(out)
        return _convert(out, port_api, PortQuantity)

    @staticmethod
    def _bridge_watch(src):
        out = port_watch.Watcher(on_stop=lambda _w: src.stop())

        def pump():
            for ev in src:
                obj = ev.object
                if obj is not None:
                    obj = _convert(obj, port_api, PortQuantity)
                out.send(port_watch.Event(ev.type, obj))
            out.close()

        threading.Thread(target=pump, daemon=True, name="bridge").start()
        return out


def test_scheduler_on_the_reference_apiserver_spreads():
    """tests/test_tpu_batch.py's first scenario: 12 service pods over 4
    nodes through the port's factory, loop and CPU solve — a perfect
    spread."""
    client = PortClient(_BridgeTransport(Master()))

    def node(name):
        return port_api.Node(
            metadata=port_api.ObjectMeta(name=name),
            spec=port_api.NodeSpec(capacity={
                "cpu": PortQuantity("8"), "memory": PortQuantity("16Gi")}))

    for i in range(4):
        client.nodes().create(node(f"n{i}"))
    client.services().create(port_api.Service(
        metadata=port_api.ObjectMeta(name="web", namespace="default"),
        spec=port_api.ServiceSpec(port=80, selector={"app": "web"})))
    factory = port_driver.ConfigFactory(client, node_poll_period=0.1)
    config = factory.create()
    sched = BatchScheduler(config, factory, client, wave_size=64,
                           wave_linger_s=0.1, device="cpu").run()
    try:
        assert _wait(lambda: len(factory.node_store) == 4
                     and len(factory.service_store) == 1)
        for i in range(12):
            client.pods().create(port_api.Pod(
                metadata=port_api.ObjectMeta(name=f"w{i}",
                                             namespace="default",
                                             labels={"app": "web"}),
                spec=port_api.PodSpec(containers=[port_api.Container(
                    name="c", image="i",
                    resources=port_api.ResourceRequirements(limits={
                        "cpu": PortQuantity("500m"),
                        "memory": PortQuantity("512Mi")}))])))
        assert _wait(lambda: all(p.spec.host
                                 for p in client.pods().list().items),
                     timeout=30.0)
        placement = {}
        for p in client.pods().list().items:
            placement[p.spec.host] = placement.get(p.spec.host, 0) + 1
        assert sorted(placement.values()) == [3, 3, 3, 3], placement
        assert sched.fault is None
    finally:
        assert sched.stop(timeout=5.0)
        assert factory.stop(join=True)


# -- (c) what is not ported yet ------------------------------------------------

def _small_factory(pending=(), bound=()):
    nodes = [REF.node("n0"), REF.node("n1")]
    cluster = FakeCluster(to_port(nodes), to_port(list(bound)),
                          to_port(list(pending)), [])
    factory = port_driver.ConfigFactory(cluster.client, node_poll_period=3600)
    factory.backoff = port_driver.PodBackoff(initial=0.02, max_duration=0.05)
    cluster.attach(factory)
    return cluster, factory


@pytest.mark.parametrize("kw, create_kw, item", [
    ({"pipeline": True}, {}, "the pipelined loop"),
    ({}, {"pipeline": True}, "the pipelined loop"),
    ({}, {"solver_addr": "localhost:1"}, "solverd"),
    ({}, {"mesh": "on"}, "parallel/mesh.py"),
    ({}, {"prewarm": True}, "cmd/scheduler.py"),
])
def test_unported_options_raise_naming_their_roadmap_item(kw, create_kw,
                                                          item):
    cluster, factory = _small_factory()
    try:
        config = factory.create(**create_kw)
        with pytest.raises(NotImplementedError, match="ROADMAP") as err:
            BatchScheduler(config, factory, cluster.client, device="cpu",
                           **kw)
        assert item in str(err.value)
    finally:
        assert factory.stop(join=True)


def test_preemption_wave_raises_out_of_schedule_wave_and_stops_the_loop():
    """Once refused, a preemption wave now binds: a pending pod above the
    resident priority, in a full cluster, binds with its victims through
    the FakeCluster's atomic evict+bind, the victims leave the cluster and
    the scheduler's store, the scheduler_preemption_* counters move, and
    the loop thread runs on with no fault. Then the same through the JAX
    package's apiserver, whose evict+bind deletes the victims."""
    from kubernetes_tpu.client.client import Client as RefClient
    low = [REF.pod(f"low{i}", cpu_m=2000, host=f"n{i % 2}", priority=i // 2)
           for i in range(4)]
    high = [REF.pod("high", cpu_m=2000, priority=100)]
    cluster, factory = _small_factory(pending=high, bound=low)
    config = factory.create()
    sched = BatchScheduler(config, factory, cluster.client, wave_size=8,
                           wave_linger_s=0.01, device="cpu")
    pmx = port_metrics.preemption_metrics()
    before = (pmx.attempts.total(), pmx.victims.total())
    try:
        cluster.wait_synced()
        assert sched.schedule_wave(timeout=1.0) == 1
        (bound,) = cluster.bind_log
        assert bound.metadata.name == "high"
        # the lowest sufficient band on the chosen node: its priority-0 pod
        victims = cluster.victims_of["default/high"]
        assert [v.metadata.name for v in victims] == \
            [f"low{0 if bound.spec.host == 'n0' else 1}"]
        assert cluster.evict_log == victims
        gone = f"default/{victims[0].metadata.name}"
        assert gone not in cluster.pods
        assert factory.scheduled_pods.get_by_key(gone) is None
        assert (pmx.attempts.total(), pmx.victims.total()) == \
            (before[0] + 1, before[1] + 1)
        sched.run()
        time.sleep(0.3)
        assert sched.fault is None
        assert sched.stop(timeout=5.0)
    finally:
        sched.stop(timeout=5.0)
        assert factory.stop(join=True)

    master = Master()
    ref = RefClient(InProcessTransport(master))
    for i in range(2):
        ref.nodes().create(ref_api.Node(
            metadata=ref_api.ObjectMeta(name=f"n{i}"),
            spec=ref_api.NodeSpec(capacity={
                "cpu": RefQuantity("1"), "memory": RefQuantity("4Gi")})))
    ref.resource("priorityclasses").create(ref_api.PriorityClass(
        metadata=ref_api.ObjectMeta(name="high"), value=1000))

    def pod(name, cls=""):
        return ref_api.Pod(
            metadata=ref_api.ObjectMeta(name=name, namespace="default"),
            spec=ref_api.PodSpec(containers=[ref_api.Container(
                name="c", image="i",
                resources=ref_api.ResourceRequirements(limits={
                    "cpu": RefQuantity("500m"),
                    "memory": RefQuantity("128Mi")}))],
                priority_class_name=cls))

    client = PortClient(_BridgeTransport(master))
    factory = port_driver.ConfigFactory(client, node_poll_period=0.1)
    sched = BatchScheduler(factory.create(), factory, client, wave_size=64,
                           wave_linger_s=0.01, device="cpu").run()
    try:
        for i in range(4):
            ref.pods().create(pod(f"low-{i}"))
        assert _wait(lambda: sum(1 for p in ref.pods().list().items
                                 if p.spec.host) == 4, timeout=30.0)
        ref.pods().create(pod("storm", cls="high"))
        assert _wait(lambda: any(p.metadata.name == "storm" and p.spec.host
                                 for p in ref.pods().list().items),
                     timeout=30.0)
        # 4 low + the storm - 2 victims (one node's two low pods)
        left = ref.pods().list().items
        assert len(left) == 3
        storm = next(p for p in left if p.metadata.name == "storm")
        assert sum(p.spec.host == storm.spec.host for p in left) == 1
        assert sched.fault is None
    finally:
        assert sched.stop(timeout=5.0)
        assert factory.stop(join=True)


def test_binder_without_bind_many_binds_pod_by_pod():
    """A binder with ``bind`` only (no batch seam) commits the wave one
    binding per pod, a preemptor's with its victims, and the wave counts
    in scheduler_bind_fallback_total, as the reference's fallback
    (kubernetes_tpu/scheduler/tpu_batch.py:832-846)."""

    class BindOnly:
        def __init__(self, client):
            self.client = client

        def bind(self, binding):
            self.client.pods(binding.metadata.namespace).bind(binding)

    low = [REF.pod(f"low{i}", cpu_m=2000, host=f"n{i % 2}", priority=i // 2)
           for i in range(4)]
    pending = [REF.pod("high", cpu_m=2000, priority=100),
               REF.pod("tiny", cpu_m=0, priority=100)]
    cluster, factory = _small_factory(pending=pending, bound=low)
    config = factory.create()
    config.binder = BindOnly(cluster.client)
    sched = BatchScheduler(config, factory, cluster.client, wave_size=8,
                           wave_linger_s=0.01, device="cpu")
    fallback = port_metrics.default_registry().counter(
        "scheduler_bind_fallback_total")
    before = fallback.total()
    try:
        cluster.wait_synced()
        assert sched.schedule_wave(timeout=1.0) == 2
        assert fallback.total() == before + 1
        binds = cluster.client.actions_of("create", "pods")
        assert [a.kw["name"] for a in binds] == ["high", "tiny"]
        assert all(a.kw["subresource"] == "binding" for a in binds)
        assert not cluster.client.actions_of("create", "bindings")
        assert [v.name for v in binds[0].kw["body"].victims] == \
            [v.metadata.name for v in cluster.evict_log]
        assert len(cluster.evict_log) == 1
        assert not binds[1].kw["body"].victims
        # a binding that loses its race fails that pod alone, as a 409
        with pytest.raises(port_errors.StatusError) as err:
            config.binder.bind(port_api.Binding(
                metadata=port_api.ObjectMeta(name="tiny",
                                             namespace="default"),
                pod_name="tiny", host="n0"))
        assert err.value.code == 409
    finally:
        assert factory.stop(join=True)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cluster, factory = _small_factory()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchScheduler(factory.create(), factory, cluster.client)
    finally:
        assert factory.stop(join=True)
