"""Scheduler lister seams (ref: pkg/scheduler/listers.go).

Port of ``kubernetes_tpu/scheduler/listers.py``.

MinionLister/PodLister/ServiceLister + NodeInfo are the only inputs the pure
scheduling algorithm sees; fakes here are the test doubles
(ref: listers.go:32,46 FakeMinionLister/FakePodLister).
"""

from __future__ import annotations

from typing import List, Optional

from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api

__all__ = ["FakeMinionLister", "FakePodLister", "FakeServiceLister", "FakeNodeInfo"]


class FakeMinionLister:
    """Wraps a NodeList (ref: listers.go FakeMinionLister)."""

    def __init__(self, nodes: api.NodeList):
        self.nodes = nodes

    def list(self) -> api.NodeList:
        return self.nodes


class FakePodLister:
    def __init__(self, pods: List[api.Pod]):
        self.pods = pods

    def list(self, selector: Optional[labels_pkg.Selector] = None) -> List[api.Pod]:
        if selector is None or selector.empty():
            return list(self.pods)
        return [p for p in self.pods if selector.matches(p.metadata.labels)]


class FakeServiceLister:
    def __init__(self, services: List[api.Service]):
        self.services = services

    def get_pod_services(self, pod: api.Pod) -> List[api.Service]:
        out = []
        for svc in self.services:
            if svc.metadata.namespace and svc.metadata.namespace != pod.metadata.namespace:
                continue
            if not svc.spec.selector:
                continue
            if labels_pkg.selector_from_set(svc.spec.selector).matches(pod.metadata.labels):
                out.append(svc)
        return out


class FakeNodeInfo:
    """name -> Node lookup (ref: predicates.go NodeInfo / FakeNodeInfo)."""

    def __init__(self, nodes: api.NodeList):
        self._by_name = {n.metadata.name: n for n in nodes.items}

    def get_node_info(self, name: str) -> api.Node:
        node = self._by_name.get(name)
        if node is None:
            raise KeyError(f"unknown node {name!r}")
        return node
