"""Generic object metadata access + kind<->resource mapping.

Port of ``kubernetes_tpu/api/meta.py``.

ref: pkg/api/meta/ — ``Accessor`` for generic ObjectMeta access and
``RESTMapper`` mapping kind <-> resource name <-> scope.
"""

from __future__ import annotations

from typing import Any, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["accessor", "RESTMapper", "default_rest_mapper"]


class _Accessor:
    """Uniform access to metadata on any API object (ref: meta.Accessor)."""

    def metadata(self, obj: Any) -> api.ObjectMeta:
        m = getattr(obj, "metadata", None)
        if not isinstance(m, api.ObjectMeta):
            raise TypeError(f"object of type {type(obj).__name__} has no ObjectMeta")
        return m

    def name(self, obj: Any) -> str:
        return self.metadata(obj).name

    def namespace(self, obj: Any) -> str:
        return self.metadata(obj).namespace

    def uid(self, obj: Any) -> str:
        return self.metadata(obj).uid

    def resource_version(self, obj: Any) -> str:
        m = getattr(obj, "metadata", None)
        return getattr(m, "resource_version", "") or ""

    def set_resource_version(self, obj: Any, rv: str) -> None:
        m = getattr(obj, "metadata", None)
        if m is not None:
            m.resource_version = rv

    def labels(self, obj: Any) -> dict:
        return self.metadata(obj).labels or {}

    def kind(self, obj: Any) -> str:
        return getattr(obj, "kind", "") or type(obj).__name__


accessor = _Accessor()


class RESTMapper:
    """kind <-> resource-name <-> scope mapping (ref: pkg/api/meta/restmapper.go)."""

    def __init__(self):
        # resource -> (kind name, type, namespaced)
        self._by_resource = {}
        self._by_kind = {}

    def add(self, resource: str, kind: str, obj_type: type, namespaced: bool = True,
            list_type: Optional[type] = None, aliases: tuple = ()):
        entry = (resource, kind, obj_type, namespaced, list_type)
        self._by_resource[resource] = entry
        self._by_kind[kind] = entry
        for a in aliases:
            self._by_resource[a] = entry

    def resource_for(self, kind: str) -> str:
        return self._by_kind[kind][0]

    def kind_for(self, resource: str) -> str:
        return self._by_resource[resource.lower()][1]

    def type_for(self, resource: str) -> type:
        return self._by_resource[resource.lower()][2]

    def list_type_for(self, resource: str) -> Optional[type]:
        return self._by_resource[resource.lower()][4]

    def is_namespaced(self, resource: str) -> bool:
        return self._by_resource[resource.lower()][3]

    def resources(self):
        return sorted({e[0] for e in self._by_resource.values()})

    def has_resource(self, resource: str) -> bool:
        return resource.lower() in self._by_resource


def default_rest_mapper() -> RESTMapper:
    m = RESTMapper()
    m.add("pods", "Pod", api.Pod, True, api.PodList, aliases=("pod", "po"))
    m.add("replicationcontrollers", "ReplicationController", api.ReplicationController, True,
          api.ReplicationControllerList, aliases=("replicationcontroller", "rc"))
    m.add("services", "Service", api.Service, True, api.ServiceList, aliases=("service", "svc"))
    m.add("endpoints", "Endpoints", api.Endpoints, True, api.EndpointsList)
    m.add("nodes", "Node", api.Node, False, api.NodeList, aliases=("node", "minions", "minion"))
    m.add("namespaces", "Namespace", api.Namespace, False, api.NamespaceList,
          aliases=("namespace", "ns"))
    m.add("bindings", "Binding", api.Binding, True, api.BindingList)
    m.add("events", "Event", api.Event, True, api.EventList, aliases=("event", "ev"))
    m.add("secrets", "Secret", api.Secret, True, api.SecretList, aliases=("secret",))
    m.add("limitranges", "LimitRange", api.LimitRange, True, api.LimitRangeList,
          aliases=("limitrange", "limits"))
    m.add("resourcequotas", "ResourceQuota", api.ResourceQuota, True, api.ResourceQuotaList,
          aliases=("resourcequota", "quota"))
    m.add("priorityclasses", "PriorityClass", api.PriorityClass, False,
          api.PriorityClassList, aliases=("priorityclass", "pc"))
    m.add("bindings", "Binding", api.Binding, True, None)
    return m
