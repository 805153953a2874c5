"""Endpoints controller (ref: pkg/service/endpoints_controller.go).

Port of ``kubernetes_tpu/controllers/endpoints.py``.

``sync_service_endpoints`` (:46+): for every service carrying a selector,
list the matching pods, resolve each pod's target port, and write an
Endpoints object of the same name — create-or-update, skipping no-op writes.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["EndpointsController", "find_port"]


def find_port(pod: api.Pod, service: api.Service) -> Optional[int]:
    """Resolve the container port a service targets on a pod
    (ref: findPort in endpoints_controller.go — ContainerPort 0 means
    "the first declared port")."""
    def effective(p: api.ContainerPort) -> int:
        # on host-network pods traffic must target the host port
        return p.host_port if pod.spec.host_network and p.host_port \
            else p.container_port

    target = service.spec.container_port
    if target:
        for c in pod.spec.containers:
            for p in c.ports:
                if p.container_port == target:
                    return effective(p)
        # unresolvable named/mismatched target: still honor the literal value
        return target
    for c in pod.spec.containers:
        for p in c.ports:
            return effective(p)
    return None


class EndpointsController:
    """ref: NewEndpointController + SyncServiceEndpoints."""

    def __init__(self, client):
        self.client = client
        self._stop = threading.Event()

    def sync_service_endpoints(self) -> None:
        services = self.client.services(api.NamespaceAll).list()
        for svc in services.items:
            if not svc.spec.selector:
                continue  # headless/external services own their endpoints
            try:
                self._sync_one(svc)
            except Exception:
                continue  # crash-only; next tick retries

    def _sync_one(self, svc: api.Service) -> None:
        ns = svc.metadata.namespace or api.NamespaceDefault
        selector = labels_pkg.selector_from_set(svc.spec.selector)
        pods = self.client.pods(ns).list(label_selector=str(selector))

        eps: List[api.Endpoint] = []
        for pod in pods.items:
            if not pod.status.pod_ip or not api.is_pod_active(pod):
                continue
            port = find_port(pod, svc)
            if port is None:
                continue
            eps.append(api.Endpoint(
                ip=pod.status.pod_ip, port=port,
                target_ref=api.ObjectReference(
                    kind="Pod", namespace=pod.metadata.namespace,
                    name=pod.metadata.name, uid=pod.metadata.uid)))
        eps.sort(key=lambda e: (e.ip, e.port))

        ep_client = self.client.endpoints(ns)
        try:
            current = ep_client.get(svc.metadata.name)
        except errors.StatusError as e:
            if not errors.is_not_found(e):
                raise
            ep_client.create(api.Endpoints(
                metadata=api.ObjectMeta(name=svc.metadata.name, namespace=ns),
                protocol=svc.spec.protocol, endpoints=eps))
            return
        def fingerprint(protocol, endpoints):
            return (protocol, [(e.ip, e.port,
                                e.target_ref.uid if e.target_ref else "")
                               for e in endpoints])

        if fingerprint(current.protocol, current.endpoints) == \
                fingerprint(svc.spec.protocol, eps):
            return  # no-op write elision
        current.endpoints = eps
        current.protocol = svc.spec.protocol
        ep_client.update(current)

    def run(self, period: float = 5.0) -> "EndpointsController":
        run_periodic(self.sync_service_endpoints, period, "endpoints", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()
