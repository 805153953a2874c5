"""A cluster's objects behind a FakeClient, for driving the wave scheduler
without an apiserver.

``FakeCluster`` holds nodes, services and pods (bound and pending) and
answers the scheduler's requests through ``FakeClient`` handlers: ``list``
of pods by the factory's field selectors (``spec.host=`` /
``spec.host!=``), of nodes and of services; ``get`` of one pod (the error
handler's re-fetch); the batch ``bind_many`` and the one-pod binding
(``create`` of ``pods`` with ``subresource="binding"``), which mark each
pod bound (409 when it is bound already, 404 when it is gone) and deliver
the bound copy to the factory's assigned-pods store, as the assigned-pods
reflector would. A binding with victims is an atomic evict+bind, with the
reference apiserver's semantics (kubernetes_tpu/registry/resources.py
:166-210): every victim is deleted and the pod bound in one step, or the
item fails with 409 and nothing applies; a victim that is gone already
counts as evicted, one whose uid changed is a 409. ``bind_log`` keeps
every bound copy in bind order, ``evict_log`` every evicted pod, and
``victims_of`` the pods each preemptor's binding evicted, by its key. Churn
goes to the factory's stores the same way: ``add_pending`` to the FIFO,
``delete_bound`` (and every eviction) out of the assigned-pods store,
``add_node`` into the node store. Every delivery is synchronous, so a run
is deterministic.

The API types, the FakeClient class, the status-error module and the
copy function are parameters, so the same cluster drives the JAX
package's scheduler in the tests that hold the two against each other;
the defaults are the port's own.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

from kubernetes_tpu_torch.api import errors as port_errors
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.client.client import FakeClient
from kubernetes_tpu_torch.runtime.clone import deep_clone

__all__ = ["FakeCluster"]


def _key(pod) -> str:
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


class FakeCluster:
    def __init__(self, nodes, bound, pending, services, api=port_api,
                 client_cls=FakeClient, errors=port_errors, clone=deep_clone):
        self.api, self.errors, self.clone = api, errors, clone
        self._lock = threading.Lock()
        self.nodes = list(nodes)
        self.services = list(services)
        self.pods = {_key(p): p for p in list(bound) + list(pending)}
        self.factory = None
        self.bind_log = []      # every bound copy, in bind order
        self.victims_of = {}    # "ns/name" of a preemptor -> evicted pods
        c = self.client = client_cls()
        c.on("list", "pods", self._list_pods)
        c.on("list", "nodes",
             lambda **kw: api.NodeList(items=list(self.nodes)))
        c.on("list", "services",
             lambda **kw: api.ServiceList(items=list(self.services)))
        c.on("get", "pods", self._get_pod)
        c.on("create", "bindings", self._bind_many)
        c.on("create", "pods", self._bind_one)

    # -- handlers -----------------------------------------------------------
    def _list_pods(self, field_selector="", **kw):
        with self._lock:
            pods = list(self.pods.values())
        if field_selector == "spec.host=":
            pods = [p for p in pods if not p.spec.host]
        elif field_selector == "spec.host!=":
            pods = [p for p in pods if p.spec.host]
        return self.api.PodList(items=pods)

    def _get_pod(self, namespace="", name="", **kw):
        with self._lock:
            pod = self.pods.get(f"{namespace}/{name}")
        if pod is None:
            raise self.errors.new_not_found("pods", name)
        return pod

    def _bind_item(self, namespace, b, delivered, evicted):
        """Apply one binding under the lock -> (code, error): 0 and "" when
        it bound. A binding with victims evicts them in the same step."""
        key = f"{namespace}/{b.pod_name}"
        pod = self.pods.get(key)
        if pod is None:
            return 404, "not found"
        if pod.spec.host:
            return 409, f"pod {key} is already bound to {pod.spec.host}"
        gone = []
        for v in b.victims:
            vkey = f"{v.namespace or namespace}/{v.name}"
            cur = self.pods.get(vkey)
            if cur is None:
                continue            # already gone: the eviction's goal
            if v.uid and cur.metadata.uid != v.uid:
                return 409, (f"victim {vkey} uid changed (have "
                             f"{cur.metadata.uid!r}, want {v.uid!r})")
            gone.append(vkey)
        if b.victims:
            self.victims_of[key] = [self.pods.pop(vkey) for vkey in gone]
            evicted += self.victims_of[key]
        done = self.clone(pod)
        done.spec.host = b.host
        done.status.host = b.host
        self.pods[key] = done
        delivered.append(done)
        return 0, ""

    def _deliver(self, delivered, evicted) -> None:
        """Hand evictions and binds to the factory's assigned-pods store,
        as its reflector would deliver their watch events."""
        if self.factory is None:
            return
        for pod in evicted:
            self.factory.scheduled_pods.delete(pod)
        for pod in delivered:
            self.factory.scheduled_pods.add(pod)

    def _bind_many(self, namespace="", body=None, **kw):
        api = self.api
        results = []
        delivered, evicted = [], []
        with self._lock:
            for b in body.items:
                code, err = self._bind_item(namespace, b, delivered, evicted)
                results.append(api.BindingResult(pod_name=b.pod_name,
                                                 code=code, error=err))
            self.bind_log += delivered
        self._deliver(delivered, evicted)
        return api.BindingResultList(items=results)

    def _bind_one(self, namespace="", name="", subresource="", body=None,
                  **kw):
        """POST pods/{name}/binding: one pod, raising the status error."""
        if subresource != "binding":
            raise ValueError(f"FakeCluster creates no pods ({subresource!r})")
        delivered, evicted = [], []
        with self._lock:
            code, err = self._bind_item(namespace, body, delivered, evicted)
            self.bind_log += delivered
        if code == 404:
            raise self.errors.new_not_found("pods", name)
        if code:
            raise self.errors.new_conflict("pods", name, err)
        self._deliver(delivered, evicted)
        return body

    @property
    def evict_log(self) -> list:
        """Every evicted pod, in eviction order."""
        with self._lock:
            return [v for vs in self.victims_of.values() for v in vs]

    # -- wiring and churn ---------------------------------------------------
    def attach(self, factory) -> None:
        """Deliver binds and churn into ``factory``'s stores."""
        self.factory = factory

    def wait_synced(self, timeout: float = 60.0) -> None:
        """Wait (bounded) until the factory's reflectors and poller have
        listed every object; raises TimeoutError otherwise."""
        f = self.factory
        with self._lock:
            n_bound = sum(1 for p in self.pods.values() if p.spec.host)
            n_pending = len(self.pods) - n_bound
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (len(f.pod_queue) == n_pending
                    and len(f.scheduled_pods) == n_bound
                    and len(f.node_store) == len(self.nodes)
                    and len(f.service_store) == len(self.services)):
                return
            time.sleep(0.005)
        raise TimeoutError("the factory's stores did not sync")

    def bound(self) -> list:
        """The bound pods, as the cluster holds them now."""
        with self._lock:
            return [p for p in self.pods.values() if p.spec.host]

    def add_pending(self, pods: Iterable) -> None:
        for pod in pods:
            with self._lock:
                self.pods[_key(pod)] = pod
            self.factory.pod_queue.add(pod)

    def delete_bound(self, pods: Iterable) -> None:
        for pod in pods:
            with self._lock:
                cur = self.pods.pop(_key(pod))
            self.factory.scheduled_pods.delete(cur)

    def add_node(self, node) -> None:
        with self._lock:
            self.nodes.append(node)
        self.factory.node_store.add(node)
