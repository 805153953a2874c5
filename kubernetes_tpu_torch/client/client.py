"""Typed API client (ref: pkg/client/client.go + per-resource files).

Port of ``kubernetes_tpu/client/client.py``. ``Client`` exposes
per-resource interfaces (pods/services/nodes/...) over a transport —
anything with ``request(verb, resource, **kw)``. Two transports exist:

- ``InProcessTransport`` — calls Master.dispatch directly but copies every
  object across the boundary, so callers and the server never share
  mutable state (the same guarantee an HTTP boundary gives).
- ``HTTPTransport`` (client/http.py) — real HTTP/JSON against the API
  server, same interface.

Also here: ``list_watch`` producing the cache package's ListWatch sources,
the pods client's batch ``bind_many`` the wave scheduler commits through,
and the Fake client that records every request (ref: pkg/client/fake.go).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.latest import scheme as default_scheme
from kubernetes_tpu_torch.client.cache import ListWatch
from kubernetes_tpu_torch.runtime.clone import deep_clone

__all__ = ["Client", "InProcessTransport", "FakeClient", "FakeAction"]


class InProcessTransport:
    """Master.dispatch behind a codec round-trip boundary."""

    def __init__(self, master, scheme=None):
        self.master = master
        self.scheme = scheme or default_scheme

    def _copy(self, obj):
        if obj is None:
            return None
        # isolation copy, not a codec exercise: deep_clone (runtime/clone)
        # is ~4x faster than copy.deepcopy on API trees and this is the
        # hot path for every in-process request (the HTTP transport still
        # round-trips through the real codec)
        return deep_clone(obj)

    def request(self, verb: str, resource: str, **kw) -> Any:
        body = kw.pop("body", None)
        if body is not None:
            body = self._copy(body)
        out = self.master.dispatch(verb, resource, body=body, **kw)
        if verb == "watch":
            return self._wrap_watch(out)
        return self._copy(out)

    def _wrap_watch(self, src: watchpkg.Watcher) -> watchpkg.Watcher:
        out = watchpkg.Watcher(on_stop=lambda _w: src.stop())

        def pump():
            for ev in src:
                obj = ev.object
                try:
                    obj = self._copy(obj)
                except Exception:
                    pass  # Status objects etc. copy fine; best-effort
                out.send(watchpkg.Event(ev.type, obj))
            out.close()

        threading.Thread(target=pump, daemon=True, name="client-watch").start()
        return out


class _ResourceClient:
    """Generic verbs for one resource in one namespace
    (ref: pkg/client/pods.go shape)."""

    def __init__(self, transport, resource: str, namespace: str = ""):
        self.t = transport
        self.resource = resource
        self.namespace = namespace

    def create(self, obj):
        return self.t.request("create", self.resource, namespace=self.namespace, body=obj)

    def get(self, name: str):
        return self.t.request("get", self.resource, namespace=self.namespace, name=name)

    def list(self, label_selector: str = "", field_selector: str = ""):
        return self.t.request("list", self.resource, namespace=self.namespace,
                              label_selector=label_selector, field_selector=field_selector)

    def update(self, obj):
        return self.t.request("update", self.resource, namespace=self.namespace, body=obj)

    def delete(self, name: str):
        return self.t.request("delete", self.resource, namespace=self.namespace, name=name)

    def watch(self, label_selector: str = "", field_selector: str = "",
              resource_version: str = "") -> watchpkg.Watcher:
        return self.t.request("watch", self.resource, namespace=self.namespace,
                              label_selector=label_selector, field_selector=field_selector,
                              resource_version=resource_version)

    def list_watch(self, label_selector: str = "", field_selector: str = "") -> ListWatch:
        """A cache.ListWatch over this resource (ref: listwatch.go)."""
        return ListWatch(
            list_fn=lambda: self.list(label_selector, field_selector),
            watch_fn=lambda rv: self.watch(label_selector, field_selector, rv),
        )


class _PodsClient(_ResourceClient):
    def bind(self, binding: api.Binding):
        """POST pods/{name}/binding (ref: factory.go binder:302-308)."""
        return self.t.request("create", self.resource, namespace=self.namespace,
                              name=binding.pod_name, subresource="binding", body=binding)

    def bind_many(self, bindings: api.BindingList) -> api.BindingResultList:
        """POST /bindings with a BindingList — one transactional store pass
        for a whole wave (see api.BindingList); per-item results."""
        return self.t.request("create", "bindings", namespace=self.namespace,
                              body=bindings)

    def update_status(self, pod: api.Pod):
        return self.t.request("update", self.resource, namespace=self.namespace,
                              name=pod.metadata.name, subresource="status", body=pod)


class _NamespacesClient(_ResourceClient):
    def finalize(self, ns: api.Namespace):
        return self.t.request("update", self.resource, name=ns.metadata.name,
                              subresource="finalize", body=ns)


class _ResourceQuotasClient(_ResourceClient):
    def update_status(self, quota: api.ResourceQuota):
        return self.t.request("update", self.resource, namespace=self.namespace,
                              name=quota.metadata.name, subresource="status", body=quota)


class Client:
    """Typed entry point: client.pods("ns").list() etc."""

    def __init__(self, transport):
        self.transport = transport

    def resource(self, resource: str, namespace: str = "") -> "_ResourceClient":
        """Generic accessor by resource name — the seam kubectl's
        Builder/Visitor pipeline uses (ref: pkg/kubectl/resource/helper.go)."""
        special = {"pods": _PodsClient, "namespaces": _NamespacesClient,
                   "resourcequotas": _ResourceQuotasClient}
        cls = special.get(resource, _ResourceClient)
        return cls(self.transport, resource, namespace)

    def pods(self, namespace: str = api.NamespaceDefault) -> _PodsClient:
        return _PodsClient(self.transport, "pods", namespace)

    def replication_controllers(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "replicationcontrollers", namespace)

    def services(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "services", namespace)

    def endpoints(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "endpoints", namespace)

    def nodes(self) -> _ResourceClient:
        return _ResourceClient(self.transport, "nodes", "")

    def events(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "events", namespace)

    def namespaces(self) -> _NamespacesClient:
        return _NamespacesClient(self.transport, "namespaces", "")

    def secrets(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "secrets", namespace)

    def limit_ranges(self, namespace: str = api.NamespaceDefault) -> _ResourceClient:
        return _ResourceClient(self.transport, "limitranges", namespace)

    def resource_quotas(self, namespace: str = api.NamespaceDefault) -> _ResourceQuotasClient:
        return _ResourceQuotasClient(self.transport, "resourcequotas", namespace)


# ---------------------------------------------------------------------------
# Fake client for unit tests (ref: pkg/client/fake.go — records actions)
# ---------------------------------------------------------------------------


class FakeAction:
    def __init__(self, verb: str, resource: str, **kw):
        self.verb = verb
        self.resource = resource
        self.kw = kw

    def __repr__(self):
        return f"FakeAction({self.verb} {self.resource} {self.kw})"


class _FakeTransport:
    def __init__(self, fake: "FakeClient"):
        self.fake = fake

    def request(self, verb: str, resource: str, **kw):
        self.fake.actions.append(FakeAction(verb, resource, **kw))
        key = (verb, resource)
        handler = self.fake.handlers.get(key)
        if handler is not None:
            return handler(**kw)
        if verb == "list":
            from kubernetes_tpu_torch.api.meta import default_rest_mapper
            lt = default_rest_mapper().list_type_for(resource)
            return lt() if lt else None
        if verb == "watch":
            return watchpkg.Watcher()
        return kw.get("body")


class FakeClient(Client):
    """Records every request; scriptable per-(verb,resource) handlers."""

    def __init__(self):
        self.actions: List[FakeAction] = []
        self.handlers: Dict[tuple, Callable] = {}
        super().__init__(_FakeTransport(self))

    def on(self, verb: str, resource: str, handler: Callable) -> None:
        self.handlers[(verb, resource)] = handler

    def actions_of(self, verb: str, resource: str = None) -> List[FakeAction]:
        return [a for a in self.actions
                if a.verb == verb and (resource is None or a.resource == resource)]
