"""Namespace lifecycle controller (ref: pkg/namespace/namespace_controller.go).

Port of ``kubernetes_tpu/controllers/namespace.py``.

Finalizer-driven termination: when a namespace goes Terminating (DELETE with
finalizers present only marks it), drain every namespaced resource, remove
the "kubernetes" finalizer via the finalize sub-resource, then delete the
now-finalizer-free namespace for real.
"""

from __future__ import annotations

import threading
from typing import List

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["NamespaceController"]


class NamespaceController:
    def __init__(self, client):
        self.client = client
        self._stop = threading.Event()

    def _content_lists(self, ns: str) -> List[tuple]:
        """(lister, deleter) pairs for every namespaced resource
        (ref: deleteAllContent in namespace_controller.go)."""
        c = self.client
        return [
            (c.pods(ns), "pods"),
            (c.replication_controllers(ns), "replicationcontrollers"),
            (c.services(ns), "services"),
            (c.endpoints(ns), "endpoints"),
            (c.secrets(ns), "secrets"),
            (c.limit_ranges(ns), "limitranges"),
            (c.resource_quotas(ns), "resourcequotas"),
            (c.events(ns), "events"),
        ]

    def sync_namespace(self, namespace: api.Namespace) -> None:
        """ref: syncNamespace — no-op unless Terminating."""
        if namespace.status.phase != api.NamespaceTerminating:
            return
        name = namespace.metadata.name
        remaining = 0
        for resource_client, _ in self._content_lists(name):
            lst = resource_client.list()
            for obj in lst.items:
                try:
                    resource_client.delete(obj.metadata.name)
                except errors.StatusError:
                    remaining += 1
        if remaining:
            return  # retry next tick
        # content drained: drop our finalizer (ref: finalize())
        if api.FinalizerKubernetes in namespace.spec.finalizers:
            namespace.spec.finalizers = [
                f for f in namespace.spec.finalizers if f != api.FinalizerKubernetes]
            namespace = self.client.namespaces().finalize(namespace)
        if not namespace.spec.finalizers:
            try:
                self.client.namespaces().delete(name)
            except errors.StatusError as e:
                if not errors.is_not_found(e):
                    raise

    def sync_all(self) -> None:
        for ns in self.client.namespaces().list().items:
            try:
                self.sync_namespace(ns)
            except Exception:
                continue

    def run(self, period: float = 2.0) -> "NamespaceController":
        run_periodic(self.sync_all, period, "namespace-controller", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()
