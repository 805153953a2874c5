"""The scheduler driver + factory.

Port of ``kubernetes_tpu/scheduler/driver.py`` (ref: plugin/pkg/
scheduler/), the harness around the pure algorithm:

- ``Scheduler.schedule_one`` (scheduler.go:90-119): blocking FIFO pop ->
  algorithm.schedule -> POST binding -> modeler.assume_pod, with events
  on every outcome; ``run`` loops it on a thread.
- ``SimpleModeler`` (modeler.go:56-155): the optimistic "assumed pods"
  cache bridging bind -> watch-confirmation latency, with the combined
  changelog (``token``/``delta``) the incremental encoder reads.
- ``PodBackoff`` (factory.go:245-369): per-pod exponential backoff 1s ->
  60s with gc; the default error handler re-fetches and re-queues.
- ``ConfigFactory`` (factory.go:40-172): wires reflectors (unassigned pods
  -> FIFO via field selector spec.host=; assigned pods -> store), a node
  poller filtering Schedulable/Ready conditions (factory.go:203-238), and
  a services reflector.

``ConfigFactory.create`` builds the serial algorithm — a
``GenericScheduler`` over the provider's or the Policy's plugins — and
records the provider and policy, which the wave loop
(scheduler/tpu_batch.BatchScheduler) reads instead.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import (
    FIFO,
    Poller,
    Reflector,
    Store,
    StorePodLister,
    StoreServiceLister,
    meta_namespace_key_func,
)
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.scheduler import plugins as schedplugins
from kubernetes_tpu_torch.scheduler.generic import GenericScheduler
from kubernetes_tpu_torch.util import metrics

_log = logging.getLogger("kubernetes_tpu_torch.scheduler")

__all__ = ["Scheduler", "SchedulerConfig", "SimpleModeler", "PodBackoff",
           "ConfigFactory", "filter_schedulable_nodes"]


class SimpleModeler:
    """ref: modeler.go:56-155."""

    def __init__(self, queued_pods: FIFO, scheduled_pods: Store):
        self.queued = queued_pods
        self.scheduled = scheduled_pods
        self.assumed = Store()

    def assume_pod(self, pod: api.Pod) -> None:
        self.assumed.add(pod)

    def _prune_assumed(self) -> None:
        """Drop assumed pods once seen in the scheduled store, or queued
        under another uid (the name was deleted and created again)
        (ref: modeler.go:90-139 listPods). A queued copy with the
        assumed pod's own uid is stale: a pod is assumed only once its
        bind was acknowledged, and a relist that listed it before the
        bind landed queues it again; that copy leaves the queue and the
        assumption stays (the reference drops the assumption, so the
        node's share of the pod is forgotten and the pod placed again)."""
        for pod in self.assumed.list():
            key = meta_namespace_key_func(pod)
            queued = self.queued.get_by_key(key)
            if queued is not None and \
                    queued.metadata.uid == pod.metadata.uid:
                self.queued.delete(queued)
                queued = None
            if queued is not None or \
                    self.scheduled.get_by_key(key) is not None:
                self.assumed.delete(pod)

    def placed(self, pod: api.Pod) -> bool:
        """Whether this pod (its uid) is bound as far as the modeler
        knows: seen bound, or assumed after an acknowledged bind."""
        key = meta_namespace_key_func(pod)
        held = self.scheduled.get_by_key(key) or self.assumed.get_by_key(key)
        return held is not None and held.metadata.uid == pod.metadata.uid

    def list(self, selector: Optional[labels_pkg.Selector] = None):
        self._prune_assumed()
        scheduled = StorePodLister(self.scheduled).list(selector)
        assumed = StorePodLister(self.assumed).list(selector)
        return scheduled + assumed

    # -- O(changed) view -----------------------------------------------------
    def token(self):
        """Changelog position over both stores; pair with delta()."""
        return (self.scheduled.token(), self.assumed.token())

    def delta(self, token):
        """Events on the COMBINED (scheduled + assumed) pod set since
        ``token``: -> (upserted_pods, removed_pods, new_token), or None
        only when the log window was exceeded (resync via list()). A
        reflector relist is not a window break: Store.replace diffs the
        new list against the cache and logs only the real changes.
        Consumers MUST apply upserts before removes. A delete event is
        suppressed while the pod's key is live in either store with the
        same uid — an assumed pod disappearing because the reflector
        caught its binding (prune) is a migration, not a removal."""
        self._prune_assumed()
        ds = self.scheduled.delta_since(token[0])
        da = self.assumed.delta_since(token[1])
        if ds is None or da is None:
            return None
        upserted, removed = [], []
        for events in (ds[0], da[0]):
            for op, pod in events:
                if op == "set":
                    upserted.append(pod)
                else:
                    key = meta_namespace_key_func(pod)
                    live = self.scheduled.get_by_key(key) \
                        or self.assumed.get_by_key(key)
                    # a delete + recreate of the name inside one window
                    # is a new pod: the old uid must still be removed or
                    # its resources leak in the encoder
                    if live is None or live.metadata.uid != pod.metadata.uid:
                        removed.append(pod)
        return upserted, removed, (ds[1], da[1])

    def pod_lister(self):
        return self


class PodBackoff:
    """ref: factory.go:245-268,320-369 — exponential 1s -> 60s + gc."""

    def __init__(self, initial: float = 1.0, max_duration: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.initial = initial
        self.max_duration = max_duration
        self.clock = clock
        self._lock = threading.Lock()
        # key -> [backoff_seconds, last_update]
        self._entries: Dict[str, list] = {}

    def get_backoff(self, pod_key: str) -> float:
        """Returns the duration to wait, doubling for next time."""
        with self._lock:
            entry = self._entries.setdefault(pod_key,
                                             [self.initial, self.clock()])
            duration = entry[0]
            entry[0] = min(entry[0] * 2, self.max_duration)
            entry[1] = self.clock()
            return duration

    def gc(self, max_age: float = 60.0) -> None:
        with self._lock:
            now = self.clock()
            for key in [k for k, e in self._entries.items()
                        if now - e[1] > max_age]:
                del self._entries[key]


@dataclass
class SchedulerConfig:
    """ref: scheduler.go:55-75 Config — the DI seam for tests, with the
    fields the batch loop reads."""

    modeler: SimpleModeler = None
    minion_lister: object = None
    algorithm: object = None                       # .schedule(pod, lister)
    binder: object = None                          # .bind / .bind_many
    next_pod: Callable[[], api.Pod] = None
    error: Callable[[api.Pod, Exception], None] = None
    recorder: Optional[EventRecorder] = None
    # what the config was built from, so the batch loop refuses a
    # configuration it cannot model instead of solving the default one
    provider: str = schedplugins.DEFAULT_PROVIDER
    policy: Optional[schedplugins.Policy] = None
    # HOST:PORT of a shared kube-solverd daemon; empty = solve in-process.
    # Recorded here (not on the driver) so any wave-capable driver built
    # from this config inherits the cluster's solver topology.
    solver_addr: str = ""
    # What a wave does when the daemon is away (kube-scheduler
    # --solver-fallback): "inprocess" solves the wave in this process on
    # the scheduler's own device, "requeue" fails the wave instead, every
    # pod requeues through the error handler and the next wave retries the
    # daemon
    solver_fallback: str = "inprocess"
    # the speculative double-buffered loop (kube-scheduler --pipeline)
    pipeline: bool = False
    # Device-mesh solve for the IN-PROCESS path (kube-scheduler --mesh):
    # "auto" shards waves above parallel.mesh.DEFAULT_MESH_MIN_NODES over
    # the host's CUDA devices when more than one exists, "on" requires
    # more than one, "off" never builds a mesh. A solver daemon has its
    # own --mesh flag; this one covers workers solving in-process (and
    # the daemon fallback). Decisions are identical either way.
    mesh: str = "auto"
    # the mesh's "pods" axis length (the rest of the devices shard nodes)
    pods_axis: int = 1
    # build the solve kernel and run one exemplar wave at boot, off the
    # wave loop (scheduler/tpu_batch.py _prewarm_boot)
    prewarm: bool = False


class Scheduler:
    """ref: scheduler.go:78-119 — the serial one-pod-at-a-time loop."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self._stop = threading.Event()

    def run(self) -> "Scheduler":
        t = threading.Thread(target=self._loop, daemon=True, name="scheduler")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        # per-pod failures are evented + requeued inside schedule_one
        # (c.error); anything escaping to here is an infrastructure fault
        # that must not spin silently (ref: util.HandleCrash, every
        # reference loop logs its crashes, scheduler.go:90-119)
        errs = metrics.default_registry().counter(
            "scheduler_loop_errors_total",
            "exceptions escaping the serial scheduling loop")
        while not self._stop.is_set():
            try:
                self.schedule_one(timeout=0.2)
            except TimeoutError:
                continue
            except Exception:
                errs.inc()
                _log.exception("scheduler loop error (backing off 10ms)")
                time.sleep(0.01)

    def _record(self, pod, reason, fmt, *args):
        if self.config.recorder is not None:
            self.config.recorder.eventf(pod, reason, fmt, *args)

    def schedule_one(self, timeout: Optional[float] = None) -> Optional[str]:
        """ref: scheduler.go:90-119 scheduleOne."""
        c = self.config
        pod = c.next_pod() if timeout is None else c.next_pod(timeout)
        try:
            dest = c.algorithm.schedule(pod, c.minion_lister)
        except Exception as e:
            self._record(pod, "FailedScheduling", "Error scheduling: %s", e)
            c.error(pod, e)
            return None
        binding = api.Binding(
            metadata=api.ObjectMeta(name=pod.metadata.name,
                                    namespace=pod.metadata.namespace),
            pod_name=pod.metadata.name, host=dest)
        try:
            c.binder.bind(binding)
        except Exception as e:
            self._record(pod, "FailedScheduling", "Binding rejected: %s", e)
            c.error(pod, e)
            return None
        self._record(pod, "Scheduled", "Successfully assigned %s to %s",
                     pod.metadata.name, dest)
        # copy before mutating, like the reference's `assumed := *pod`
        # (scheduler.go:114-117): the popped pod may be shared
        assumed = deep_clone(pod)
        assumed.spec.host = dest
        assumed.status.host = dest
        c.modeler.assume_pod(assumed)
        return dest


def filter_schedulable_nodes(nodes: api.NodeList) -> api.NodeList:
    """ref: factory.go:203-238 pollMinions — keep nodes whose Schedulable
    condition isn't false and that are Ready (or Reachable, or carry no
    conditions at all). Cordoned nodes (``spec.unschedulable``) are
    dropped here too; the encoder's cordon fold is the second guard."""
    out = []
    for node in nodes.items:
        if node.spec.unschedulable:
            continue
        conds = {c.type: c for c in node.status.conditions}
        sched = conds.get(api.NodeSchedulable)
        if sched is not None and sched.status != api.ConditionTrue:
            continue
        ready = conds.get(api.NodeReady)
        reachable = conds.get(api.NodeReachable)
        if ready is not None:
            if ready.status == api.ConditionTrue:
                out.append(node)
        elif reachable is not None:
            if reachable.status == api.ConditionTrue:
                out.append(node)
        else:
            out.append(node)
    return api.NodeList(items=out)


class _StoreMinionLister:
    def __init__(self, store: Store):
        self.store = store

    def list(self) -> api.NodeList:
        items = sorted(self.store.list(), key=lambda n: n.metadata.name)
        return api.NodeList(items=items)


class ConfigFactory:
    """ref: factory.go:40-172 ConfigFactory/CreateFromKeys."""

    def __init__(self, client, node_poll_period: float = 10.0):
        self.client = client
        self.node_poll_period = node_poll_period
        self.pod_queue = FIFO()              # unassigned pods
        self.scheduled_pods = Store()        # assigned pods
        self.node_store = Store()
        self.service_store = Store()
        self.modeler = SimpleModeler(self.pod_queue, self.scheduled_pods)
        self.backoff = PodBackoff()
        self._runners = []
        # backoff-requeue threads (error handler): tracked so stop() can
        # wake them early (they wait on this event) and join them
        self._stopping = threading.Event()
        self._requeue_threads: list = []
        self._requeue_lock = threading.Lock()

    def create(self, provider: str = schedplugins.DEFAULT_PROVIDER,
               policy: Optional[schedplugins.Policy] = None,
               recorder: Optional[EventRecorder] = None,
               solver_addr: str = "", pipeline: bool = False,
               mesh: str = "auto", pods_axis: int = 1,
               solver_fallback: str = "inprocess",
               prewarm: bool = False) -> SchedulerConfig:
        """ref: factory.go:77-172 CreateFromProvider/CreateFromConfig/
        CreateFromKeys."""
        # reflector: unassigned pods -> FIFO (field selector spec.host=)
        self._runners.append(Reflector(
            self.client.pods(api.NamespaceAll).list_watch(
                field_selector="spec.host="),
            self.pod_queue, name="unassigned-pods").run())
        # reflector: assigned pods -> store
        self._runners.append(Reflector(
            self.client.pods(api.NamespaceAll).list_watch(
                field_selector="spec.host!="),
            self.scheduled_pods, name="assigned-pods").run())
        # poller: nodes every node_poll_period, filtered (factory.go:139)
        self._runners.append(Poller(
            lambda: filter_schedulable_nodes(self.client.nodes().list()),
            self.node_poll_period, self.node_store).run())
        # reflector: services
        self._runners.append(Reflector(
            self.client.services(api.NamespaceAll).list_watch(),
            self.service_store, name="services").run())

        minion_lister = _StoreMinionLister(self.node_store)
        pod_lister = self.modeler.pod_lister()
        args = schedplugins.PluginFactoryArgs(
            pod_lister=pod_lister,
            service_lister=StoreServiceLister(self.service_store),
            node_lister=minion_lister,
            node_info=_NodeStoreInfo(self.node_store))

        if policy is not None:
            algorithm = GenericScheduler(
                schedplugins.predicates_from_policy(policy, args),
                schedplugins.priorities_from_policy(policy, args),
                pod_lister)
        else:
            keys = schedplugins.get_algorithm_provider(provider)
            algorithm = GenericScheduler(
                schedplugins.get_predicates(keys["predicates"], args),
                schedplugins.get_priorities(keys["priorities"], args),
                pod_lister)

        return SchedulerConfig(
            modeler=self.modeler,
            minion_lister=minion_lister,
            algorithm=algorithm,
            binder=_Binder(self.client),
            next_pod=self._next_pod,
            error=self._make_error_func(),
            recorder=recorder,
            provider=provider,
            policy=policy,
            solver_addr=solver_addr,
            solver_fallback=solver_fallback,
            pipeline=pipeline,
            mesh=mesh,
            pods_axis=pods_axis,
            prewarm=prewarm,
        )

    def stop(self, join: bool = False, timeout: float = 2.0) -> bool:
        """Stop every reflector/poller. With ``join=True``, wait for their
        threads to exit so no in-flight watch delivery can land in the
        stores afterwards. Returns False iff a join timed out.
        Backoff-requeue threads are always woken and joined."""
        self._stopping.set()
        for r in self._runners:
            r.stop()
        frozen = True
        if join:
            for r in self._runners:
                if not r.join(timeout):
                    frozen = False
        with self._requeue_lock:
            requeues = list(self._requeue_threads)
        for t in requeues:
            t.join(timeout)
            if t.is_alive() and join:
                frozen = False
        return frozen

    def _next_pod(self, timeout: Optional[float] = None) -> api.Pod:
        """ref: factory.go:164-168 — blocking FIFO pop. A pod the modeler
        already holds as bound (a relist queued it again from a list
        taken before its bind landed) is dropped, not scheduled twice."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            pod = self.pod_queue.pop(timeout=left)
            if not self.modeler.placed(pod):
                return pod

    def _make_error_func(self):
        """ref: factory.go makeDefaultErrorFunc — backoff, re-fetch,
        re-queue if still unscheduled."""

        def handle(pod: api.Pod, err: Exception) -> None:
            if self._stopping.is_set():
                return
            key = meta_namespace_key_func(pod)
            delay = self.backoff.get_backoff(key)

            def requeue():
                # stop() wakes this immediately — no orphaned sleeper
                if self._stopping.wait(delay):
                    return
                try:
                    fresh = self.client.pods(pod.metadata.namespace).get(
                        pod.metadata.name)
                    if not fresh.spec.host:
                        self.pod_queue.add(fresh)
                except errors.StatusError:
                    pass  # deleted meanwhile
                except OSError:
                    pass  # apiserver unreachable: a live pod relists
                self.backoff.gc()

            t = threading.Thread(target=requeue, daemon=True,
                                 name="scheduler-requeue")
            with self._requeue_lock:
                self._requeue_threads[:] = [x for x in self._requeue_threads
                                            if x.is_alive()]
                self._requeue_threads.append(t)
                # started under the lock: stop() joins only started threads
                t.start()

        return handle


class _Binder:
    """ref: factory.go:297-308 binder — POST pods/{name}/binding, and POST
    /bindings batched."""

    def __init__(self, client):
        self.client = client

    def bind(self, binding: api.Binding) -> None:
        """Bind one pod (with its victims, an atomic evict+bind)."""
        self.client.pods(binding.metadata.namespace).bind(binding)

    def bind_many(self, namespace: str,
                  bindings: api.BindingList) -> api.BindingResultList:
        """Commit one namespace's wave bindings in one transactional store
        pass (per-pod CAS semantics kept)."""
        return self.client.pods(namespace).bind_many(bindings)


class _NodeStoreInfo:
    """NodeInfo over the scheduler's node store (GetNodeInfo by name)."""

    def __init__(self, store: Store):
        self.store = store

    def get_node_info(self, name: str) -> api.Node:
        node = self.store.get_by_key(name)
        if node is None:
            raise KeyError(f"unknown node {name!r}")
        return node
