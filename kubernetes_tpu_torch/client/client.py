"""Typed API client (ref: pkg/client/client.go + per-resource files).

Port of ``kubernetes_tpu/client/client.py``: ``Client`` exposes
per-resource interfaces (pods/services/nodes/events) over a transport —
anything with ``request(verb, resource, **kw)`` — and hands the cache
package its ListWatch sources; the pods client carries the batch
``bind_many`` the wave scheduler commits through, and the one-pod ``bind``
its per-pod fallback takes. ``FakeClient`` records every request and
answers from per-(verb, resource) handlers (ref: pkg/client/fake.go). The
HTTP transport is ``client/http.HTTPTransport``; the in-process transport
over the apiserver comes with the apiserver (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import ListWatch

__all__ = ["Client", "FakeClient", "FakeAction"]

# resource -> its list type (ref: api/meta.go RESTMapper list types)
_LIST_TYPES = {"pods": api.PodList, "nodes": api.NodeList,
               "services": api.ServiceList}


class _ResourceClient:
    """Generic verbs for one resource in one namespace
    (ref: pkg/client/pods.go shape)."""

    def __init__(self, transport, resource: str, namespace: str = ""):
        self.t = transport
        self.resource = resource
        self.namespace = namespace

    def create(self, obj):
        return self.t.request("create", self.resource,
                              namespace=self.namespace, body=obj)

    def get(self, name: str):
        return self.t.request("get", self.resource, namespace=self.namespace,
                              name=name)

    def list(self, label_selector: str = "", field_selector: str = ""):
        return self.t.request("list", self.resource, namespace=self.namespace,
                              label_selector=label_selector,
                              field_selector=field_selector)

    def update(self, obj):
        return self.t.request("update", self.resource,
                              namespace=self.namespace, body=obj)

    def watch(self, label_selector: str = "", field_selector: str = "",
              resource_version: str = "") -> watchpkg.Watcher:
        return self.t.request("watch", self.resource,
                              namespace=self.namespace,
                              label_selector=label_selector,
                              field_selector=field_selector,
                              resource_version=resource_version)

    def list_watch(self, label_selector: str = "",
                   field_selector: str = "") -> ListWatch:
        """A cache.ListWatch over this resource (ref: listwatch.go)."""
        return ListWatch(
            list_fn=lambda: self.list(label_selector, field_selector),
            watch_fn=lambda rv: self.watch(label_selector, field_selector,
                                           rv),
        )


class _PodsClient(_ResourceClient):
    def bind(self, binding: api.Binding):
        """POST pods/{name}/binding (ref: factory.go binder:302-308); a
        binding with victims evicts them and binds in one step."""
        return self.t.request("create", self.resource,
                              namespace=self.namespace,
                              name=binding.pod_name, subresource="binding",
                              body=binding)

    def bind_many(self, bindings: api.BindingList) -> api.BindingResultList:
        """POST /bindings with a BindingList — one transactional store pass
        for a whole wave; per-item results. An item with victims evicts
        them and binds in one step, or fails with 409 and applies
        nothing."""
        return self.t.request("create", "bindings", namespace=self.namespace,
                              body=bindings)


class Client:
    """Typed entry point: client.pods("ns").list() etc."""

    def __init__(self, transport):
        self.transport = transport

    def pods(self, namespace: str = api.NamespaceDefault) -> _PodsClient:
        return _PodsClient(self.transport, "pods", namespace)

    def services(self, namespace: str = api.NamespaceDefault
                 ) -> _ResourceClient:
        return _ResourceClient(self.transport, "services", namespace)

    def nodes(self) -> _ResourceClient:
        return _ResourceClient(self.transport, "nodes", "")

    def events(self, namespace: str = api.NamespaceDefault
               ) -> _ResourceClient:
        return _ResourceClient(self.transport, "events", namespace)


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
        handler = self.fake.handlers.get((verb, resource))
        if handler is not None:
            return handler(**kw)
        if verb == "list":
            lt = _LIST_TYPES.get(resource)
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
                if a.verb == verb and (resource is None
                                       or a.resource == resource)]
