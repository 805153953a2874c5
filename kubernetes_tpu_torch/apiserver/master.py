"""Master — constructs every registry and serves the verb dispatch.

Port of ``kubernetes_tpu/apiserver/master.py``.

Rebuild of ``pkg/master/master.go:350-490`` + the generic REST handlers
(``pkg/apiserver/resthandler.go``): one Config builds the store, the typed
helper, all per-resource registries and sub-resources, the admission chain,
and exposes ``dispatch`` — the single seam shared by the in-process client
and the HTTP layer, mirroring the reference invariant that every component
talks only through the API surface (DESIGN.md:40).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch import admission as admission_pkg
# ktpu-vet: ok unused — side-effect import: registers admission plugin factories
from kubernetes_tpu_torch.admission import plugins as admission_plugins  # noqa: F401
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.fields import parse_field_selector
from kubernetes_tpu_torch.api.labels import parse_selector
from kubernetes_tpu_torch.api.latest import scheme as default_scheme
from kubernetes_tpu_torch.api.meta import default_rest_mapper
from kubernetes_tpu_torch.registry import resources as reg
from kubernetes_tpu_torch.registry.generic import Context
from kubernetes_tpu_torch.storage.helper import StoreHelper
from kubernetes_tpu_torch.storage.memstore import MemStore

__all__ = ["Master", "MasterConfig"]

DEFAULT_ADMISSION = ("NamespaceAutoProvision", "NamespaceLifecycle",
                     "LimitRanger", "ResourceQuota", "PriorityDefault")


@dataclass
class MasterConfig:
    """ref: master.Config (master.go:112-160)."""

    store: Optional[MemStore] = None
    scheme: Any = None
    admission_control: tuple = DEFAULT_ADMISSION
    authorizer: Any = None          # .authorize(user, attrs) raising Forbidden
    portal_net: str = "10.0.0.0/24"
    event_ttl_seconds: float = 3600.0
    cloud: Any = None               # cloudprovider.Interface (ref: master.go Cloud)


class Master:
    def __init__(self, config: Optional[MasterConfig] = None):
        c = config or MasterConfig()
        self.store = c.store or MemStore()
        self.scheme = c.scheme or default_scheme
        self.helper = StoreHelper(self.store, self.scheme)
        self.mapper = default_rest_mapper()
        self.authorizer = c.authorizer

        # registries (ref: master.go:350-396 init)
        self.pods = reg.make_pod_registry(self.helper)
        self.controllers = reg.make_rc_registry(self.helper)
        self.nodes = reg.make_node_registry(self.helper)
        self.services = reg.make_service_registry(
            self.helper, reg.IPAllocator(c.portal_net), cloud=c.cloud,
            node_lister=lambda: [n.metadata.name for n in
                                 self.nodes.list(Context()).items])
        self.endpoints = reg.make_endpoints_registry(self.helper)
        self.events = reg.make_event_registry(self.helper, c.event_ttl_seconds)
        self.namespaces = reg.make_namespace_registry(self.helper)
        self.secrets = reg.make_secret_registry(self.helper)
        self.limitranges = reg.make_limitrange_registry(self.helper)
        self.resourcequotas = reg.make_resourcequota_registry(self.helper)
        self.priorityclasses = reg.make_priorityclass_registry(self.helper)

        # sub/special resources
        self.bindings = reg.BindingREST(self.pods)
        self.pod_status = reg.PodStatusREST(self.pods)
        self.ns_finalize = reg.NamespaceFinalizeREST(self.namespaces)
        self.quota_status = reg.ResourceQuotaStatusREST(self.resourcequotas)

        # the storage map (ref: master.go:350 "storage" map[string]RESTStorage)
        self.storage: Dict[str, Any] = {
            "pods": self.pods,
            "replicationcontrollers": self.controllers,
            "services": self.services,
            "endpoints": self.endpoints,
            "nodes": self.nodes,
            "bindings": self.bindings,
            "events": self.events,
            "namespaces": self.namespaces,
            "secrets": self.secrets,
            "limitranges": self.limitranges,
            "resourcequotas": self.resourcequotas,
            "priorityclasses": self.priorityclasses,
        }
        self.subresources: Dict[tuple, Any] = {
            ("pods", "binding"): self.bindings,
            ("pods", "status"): self.pod_status,
            ("namespaces", "finalize"): self.ns_finalize,
            ("resourcequotas", "status"): self.quota_status,
        }

        # decode-time selfLink stamping: with the store's shared-read
        # contract (storage/helper.py), cached objects must be born
        # complete — a post-read stamp would make watch frames and list
        # responses order-dependent on whether a GET ran first
        for res_name, registry in self.storage.items():
            prefix = getattr(registry, "prefix", None)
            if prefix is None:
                continue  # subresource REST (bindings): no storage of its own
            self.helper.register_linker(
                prefix, self._make_linker(res_name, registry))

        self.admission = admission_pkg.new_from_plugins(
            list(c.admission_control),
            namespaces=self.namespaces,
            limitranges=self.limitranges,
            resourcequotas=self.resourcequotas,
            priorityclasses=self.priorityclasses,
        )

        # bootstrap: the default namespace always exists (the reference
        # auto-provisions "default" via admission; we seed it eagerly too)
        try:
            self.namespaces.create(
                Context(), api.Namespace(metadata=api.ObjectMeta(name=api.NamespaceDefault)))
        except errors.StatusError as e:
            if not errors.is_already_exists(e):
                raise

    # ------------------------------------------------------------------
    def _make_linker(self, resource: str, registry):
        def link(obj) -> None:
            m = getattr(obj, "metadata", None)
            if isinstance(m, api.ObjectMeta):
                m.self_link = self._self_link(resource, obj)
        return link

    def _self_link(self, resource: str, obj) -> str:
        """ref: resthandler.go setSelfLink — /api/<v>/namespaces/<ns>/<res>/<name>
        for namespaced resources, /api/<v>/<res>/<name> cluster-scoped."""
        m = getattr(obj, "metadata", None)
        if m is None:
            return ""
        version = getattr(self.scheme, "version", "v1")
        if self.mapper.is_namespaced(resource) and m.namespace:
            return f"/api/{version}/namespaces/{m.namespace}/{resource}/{m.name}"
        return f"/api/{version}/{resource}/{m.name}"

    def _stamp_self_links(self, resource: str, obj, namespace: str = ""):
        if obj is None:
            return obj
        items = getattr(obj, "items", None)
        if items is not None:
            for item in items:
                # result kinds (e.g. BindingResult) carry no ObjectMeta;
                # storage reads arrive pre-stamped by the decode-time
                # linker — never re-write a shared cached object here
                m = getattr(item, "metadata", None)
                if isinstance(m, api.ObjectMeta) and not m.self_link:
                    m.self_link = self._self_link(resource, item)
            version = getattr(self.scheme, "version", "v1")
            if self.mapper.is_namespaced(resource) and namespace:
                obj.metadata.self_link = \
                    f"/api/{version}/namespaces/{namespace}/{resource}"
            else:
                obj.metadata.self_link = f"/api/{version}/{resource}"
        elif hasattr(obj, "metadata") and isinstance(obj.metadata, api.ObjectMeta):
            if not obj.metadata.self_link:
                obj.metadata.self_link = self._self_link(resource, obj)
        return obj

    def _registry(self, resource: str):
        resource = self.mapper.resource_for(self.mapper.kind_for(resource)) \
            if self.mapper.has_resource(resource) else resource
        r = self.storage.get(resource)
        if r is None:
            raise errors.new_not_found("resource", resource)
        return resource, r

    def _authorize(self, user, attrs: admission_pkg.Attributes) -> None:
        if self.authorizer is not None:
            self.authorizer.authorize(user, attrs)

    def bind_batch(self, namespace: str, bindings: api.BindingList,
                   user: Any = None,
                   on_bound: Optional[Any] = None) -> api.BindingResultList:
        """POST /api/{v}/ns/{ns}/bindings:batch — one wave of CAS binds in
        one request. Authorization and admission run ONCE against the
        request namespace (the same checks the per-pod bind path runs per
        binding — every item is namespace-pinned to the request by
        BindingREST.create_many, so nothing escapes the single check);
        per-item CAS semantics and partial success are preserved by
        create_many/atomic_update_many."""
        ctx = Context(namespace=namespace, user=user)
        attrs = admission_pkg.Attributes(
            operation=admission_pkg.CREATE, resource="bindings",
            namespace=namespace, obj=bindings, user=user)
        self._authorize(user, attrs)
        self.admission.admit(attrs)
        self._authorize_victims(user, namespace, bindings.items)
        return self.bindings.create_many(ctx, bindings, on_bound=on_bound)

    def _authorize_victims(self, user, namespace: str, bindings) -> None:
        """kube-preempt: an evict+bind item deletes pods, so EVERY
        distinct victim namespace (the request's own included — binding
        create rights are not pod delete rights) gets its own DELETE
        authorization + admission pass. Shared by bind_batch and the
        per-pod binding subresource, so neither form widens what the
        plain delete verb allows."""
        victim_ns = {v.namespace or namespace
                     for b in bindings for v in getattr(b, "victims", ())}
        for ns in sorted(victim_ns):
            vattrs = admission_pkg.Attributes(
                operation=admission_pkg.DELETE, resource="pods",
                namespace=ns, user=user)
            self._authorize(user, vattrs)
            self.admission.admit(vattrs)

    def dispatch(self, verb: str, resource: str, *, namespace: str = "",
                 name: str = "", body: Any = None, subresource: str = "",
                 label_selector: str = "", field_selector: str = "",
                 resource_version: str = "", user: Any = None,
                 lag_limit: Optional[int] = None) -> Any:
        """The generic REST entry (ref: resthandler.go Get/List/Create/Update/
        Delete/Watch Resource). Verbs: get, list, create, update, delete,
        watch. Returns API objects, or a watch.Watcher for watch."""
        canonical, registry = self._registry(resource)
        ctx = Context(namespace=namespace, user=user)
        attrs = admission_pkg.Attributes(
            operation="", resource=canonical, namespace=namespace, name=name,
            obj=body, user=user, subresource=subresource)

        if subresource:
            sub = self.subresources.get((canonical, subresource))
            if sub is None:
                raise errors.new_not_found("resource", f"{canonical}/{subresource}")
            if verb == "create":
                attrs.operation = admission_pkg.CREATE
                self._authorize(user, attrs)
                self.admission.admit(attrs)
                if canonical == "pods" and subresource == "binding":
                    # a single evict+bind binding deletes pods too: same
                    # per-victim-namespace DELETE authz as bind_batch
                    items = list(getattr(body, "items", None) or [body])
                    if any(getattr(b, "victims", None) for b in items):
                        self._authorize_victims(user, namespace, items)
                return sub.create(ctx, body)
            if verb == "update":
                attrs.operation = admission_pkg.UPDATE
                self._authorize(user, attrs)
                self.admission.admit(attrs)
                return sub.update(ctx, body)
            raise errors.new_method_not_supported(canonical, verb)

        if verb == "get":
            self._authorize(user, attrs)
            return self._stamp_self_links(canonical, registry.get(ctx, name))
        if verb == "list":
            self._authorize(user, attrs)
            return self._stamp_self_links(
                canonical, registry.list(ctx, parse_selector(label_selector),
                                         parse_field_selector(field_selector)),
                namespace=namespace)
        if verb == "watch":
            self._authorize(user, attrs)
            return registry.watch(ctx, parse_selector(label_selector),
                                  parse_field_selector(field_selector),
                                  resource_version=resource_version)
        if verb == "watch_raw":
            # the HTTP fan-out path (apiserver/http._stream_watch): raw
            # store events + a translate callable, driven by the
            # connection's own thread — see GenericRegistry.watch_raw
            self._authorize(user, attrs)
            raw_fn = getattr(registry, "watch_raw", None)
            if raw_fn is None:
                # non-generic storage (e.g. bindings): the plain watch verb
                # carries the 405/behavior contract; identity-translate
                w = registry.watch(ctx, parse_selector(label_selector),
                                   parse_field_selector(field_selector),
                                   resource_version=resource_version)
                return w, (lambda ev: ev)
            return raw_fn(ctx, parse_selector(label_selector),
                          parse_field_selector(field_selector),
                          resource_version=resource_version,
                          lag_limit=lag_limit)
        if verb == "create":
            attrs.operation = admission_pkg.CREATE
            attrs.name = getattr(getattr(body, "metadata", None), "name", name)
            self._authorize(user, attrs)
            self.admission.admit(attrs)
            return self._stamp_self_links(canonical, registry.create(ctx, body))
        if verb == "update":
            attrs.operation = admission_pkg.UPDATE
            self._authorize(user, attrs)
            self.admission.admit(attrs)
            return self._stamp_self_links(canonical, registry.update(ctx, body))
        if verb == "delete":
            attrs.operation = admission_pkg.DELETE
            self._authorize(user, attrs)
            self.admission.admit(attrs)
            return registry.delete(ctx, name)
        raise errors.new_method_not_supported(canonical, verb)
