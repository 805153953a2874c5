"""The scheduler driver's plumbing: modeler, backoff, config and factory.

Port of ``kubernetes_tpu/scheduler/driver.py`` (ref: plugin/pkg/
scheduler/), the harness the wave scheduler runs on:

- ``SimpleModeler`` (modeler.go:56-155): the optimistic "assumed pods"
  cache bridging bind -> watch-confirmation latency, with the combined
  changelog (``token``/``delta``) the incremental encoder reads.
- ``PodBackoff`` (factory.go:245-369): per-pod exponential backoff 1s ->
  60s with gc; the default error handler re-fetches and re-queues.
- ``ConfigFactory`` (factory.go:40-172): wires reflectors (unassigned pods
  -> FIFO via field selector spec.host=; assigned pods -> store), a node
  poller filtering Schedulable/Ready conditions (factory.go:203-238), and
  a services reflector.

``ConfigFactory.create`` records ``algorithm=None``: the serial
``GenericScheduler`` and its plugin predicates and priorities are not
ported, and neither is the serial ``Scheduler`` loop. The batch loop
(scheduler/tpu_batch.BatchScheduler) reads the recorded provider and
policy instead.
"""

from __future__ import annotations

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
    meta_namespace_key_func,
)
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.scheduler import plugins as schedplugins

__all__ = ["SchedulerConfig", "SimpleModeler", "PodBackoff", "ConfigFactory",
           "filter_schedulable_nodes"]


class SimpleModeler:
    """ref: modeler.go:56-155."""

    def __init__(self, queued_pods: FIFO, scheduled_pods: Store):
        self.queued = queued_pods
        self.scheduled = scheduled_pods
        self.assumed = Store()

    def assume_pod(self, pod: api.Pod) -> None:
        self.assumed.add(pod)

    def _prune_assumed(self) -> None:
        """Drop assumed pods once seen in the queued or scheduled stores
        (ref: modeler.go:90-139 listPods)."""
        for pod in self.assumed.list():
            key = meta_namespace_key_func(pod)
            if self.queued.get_by_key(key) is not None:
                self.assumed.delete(pod)
            elif self.scheduled.get_by_key(key) is not None:
                self.assumed.delete(pod)

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
    """ref: scheduler.go:55-75 Config — the DI seam, with the fields the
    batch loop reads."""

    modeler: SimpleModeler = None
    minion_lister: object = None
    algorithm: object = None                       # None: no serial path
    binder: object = None                          # .bind_many
    next_pod: Callable[[], api.Pod] = None
    error: Callable[[api.Pod, Exception], None] = None
    recorder: Optional[EventRecorder] = None
    # what the config was built from, so the batch loop refuses a
    # configuration it cannot model instead of solving the default one
    provider: str = schedplugins.DEFAULT_PROVIDER
    policy: Optional[schedplugins.Policy] = None
    # topology flags of the reference's scheduler binary; the port runs
    # only the in-process, causal, single-device loop and refuses the rest
    solver_addr: str = ""
    pipeline: bool = False
    mesh: str = "auto"
    prewarm: bool = False


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
               mesh: str = "auto", prewarm: bool = False) -> SchedulerConfig:
        """ref: factory.go:77-172 CreateFromProvider/CreateFromConfig."""
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

        return SchedulerConfig(
            modeler=self.modeler,
            minion_lister=_StoreMinionLister(self.node_store),
            algorithm=None,
            binder=_Binder(self.client),
            next_pod=self._next_pod,
            error=self._make_error_func(),
            recorder=recorder,
            provider=provider,
            policy=policy,
            solver_addr=solver_addr,
            pipeline=pipeline,
            mesh=mesh,
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
        """ref: factory.go:164-168 — blocking FIFO pop."""
        return self.pod_queue.pop(timeout=timeout)

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
