"""A cluster's objects behind a FakeClient, for driving the wave scheduler
without an apiserver.

``FakeCluster`` holds nodes, services and pods (bound and pending) and
answers the scheduler's requests through ``FakeClient`` handlers: ``list``
of pods by the factory's field selectors (``spec.host=`` /
``spec.host!=``), of nodes and of services; ``get`` of one pod (the error
handler's re-fetch); and the batch ``bind_many``, which marks each pod
bound (a 409 result when it is bound already, a 404 when it is gone) and
delivers the bound copy to the factory's assigned-pods store, as the
assigned-pods reflector would; ``bind_log`` keeps every bound copy in
bind order. Churn goes to the factory's stores the same
way: ``add_pending`` to the FIFO, ``delete_bound`` out of the
assigned-pods store, ``add_node`` into the node store. Every delivery is
synchronous, so a run is deterministic.

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
        c = self.client = client_cls()
        c.on("list", "pods", self._list_pods)
        c.on("list", "nodes",
             lambda **kw: api.NodeList(items=list(self.nodes)))
        c.on("list", "services",
             lambda **kw: api.ServiceList(items=list(self.services)))
        c.on("get", "pods", self._get_pod)
        c.on("create", "bindings", self._bind_many)

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

    def _bind_many(self, namespace="", body=None, **kw):
        api = self.api
        results = []
        delivered = []
        with self._lock:
            for b in body.items:
                key = f"{namespace}/{b.pod_name}"
                pod = self.pods.get(key)
                if pod is None:
                    results.append(api.BindingResult(
                        pod_name=b.pod_name, error="not found", code=404))
                    continue
                if pod.spec.host:
                    results.append(api.BindingResult(
                        pod_name=b.pod_name, code=409,
                        error=f"pod {key} is already bound to "
                              f"{pod.spec.host}"))
                    continue
                done = self.clone(pod)
                done.spec.host = b.host
                done.status.host = b.host
                self.pods[key] = done
                delivered.append(done)
                results.append(api.BindingResult(pod_name=b.pod_name))
            self.bind_log += delivered
        if self.factory is not None:
            for pod in delivered:
                self.factory.scheduled_pods.add(pod)
        return api.BindingResultList(items=results)

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
