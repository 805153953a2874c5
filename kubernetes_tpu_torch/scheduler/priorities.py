"""Priority functions — the Score phase.

Port of ``kubernetes_tpu/scheduler/priorities.py`` (ref:
``pkg/scheduler/priorities.go`` and ``spreading.go``). A priority
function returns a list of (host, score) with integer scores 0..10; weighted
sums combine them (ref: generic_scheduler.go:136-165). Scores here mirror the
reference's integer/float32 truncation semantics exactly — the batch solve and
the commit_solve kernel reproduce them bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import struct

from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.scheduler import predicates
from kubernetes_tpu_torch.scheduler.predicates import map_pods_to_machines

__all__ = [
    "HostPriority", "PriorityFunction", "PriorityConfig", "calculate_score",
    "least_requested_priority", "NodeLabelPrioritizer", "equal_priority",
    "ServiceSpread", "ServiceAntiAffinity", "f32_trunc",
]


@dataclass
class HostPriority:
    """ref: types.go HostPriority {host, score}."""

    host: str
    score: int


PriorityFunction = Callable[..., List[HostPriority]]


@dataclass
class PriorityConfig:
    """ref: types.go PriorityConfig {Function, Weight}."""

    function: PriorityFunction
    weight: int = 1


def f32_trunc(x: float) -> int:
    """int(float32(x)) — reproduce Go's float32 truncation for spread scores
    (spreading.go:79 ``int(fScore)`` where fScore is float32)."""
    return int(struct.unpack("f", struct.pack("f", x))[0])


def spread_score_f32(total: int, count: int) -> int:
    """``int(10 * (float32(total-count) / float32(total)))`` with every
    operation performed in float32, exactly as Go evaluates it
    (spreading.go:78-79, :154-156) and exactly as the commit_solve kernel
    computes it — keeping all three implementations bit-identical."""
    import numpy as np

    div = np.float32(total - count) / np.float32(total)
    return int(np.float32(10) * div)


def calculate_score(requested: int, capacity: int, node: str) -> int:
    """ref: priorities.go:27-37 calculateScore — Go integer division."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * 10) // capacity


def _calculate_occupancy(pod: api.Pod, node: api.Node, pods: List[api.Pod],
                         universe: List[str]) -> HostPriority:
    """ref: priorities.go:41-75 calculateOccupancy, generalized to the
    wave's R resource dimensions: the per-dimension integer scores are
    averaged over the whole universe (``sum // R``), which reduces to the
    reference's ``(cpu_score + memory_score) / 2`` when the cluster
    advertises only cpu+memory."""
    totals = {k: 0 for k in universe}
    for existing in pods:
        for c in existing.spec.containers:
            for name, q in c.resources.limits.items():
                if name in totals:
                    totals[name] += predicates.resource_value(name, q)
    # add the pod being scheduled (differentiates empty minions by size)
    for c in pod.spec.containers:
        for name, q in c.resources.limits.items():
            if name in totals:
                totals[name] += predicates.resource_value(name, q)

    caps = predicates.capacity_values(node.spec.capacity)
    score = sum(calculate_score(totals[k], caps.get(k, 0), node.metadata.name)
                for k in universe) // len(universe)
    return HostPriority(host=node.metadata.name, score=score)


def least_requested_priority(pod: api.Pod, pod_lister, minion_lister) -> List[HostPriority]:
    """ref: priorities.go:79-95 LeastRequestedPriority."""
    nodes = minion_lister.list()
    universe = predicates.resource_universe(nodes.items)
    pods_to_machines = map_pods_to_machines(pod_lister)
    return [_calculate_occupancy(pod, node,
                                 pods_to_machines.get(node.metadata.name, []),
                                 universe)
            for node in nodes.items]


class NodeLabelPrioritizer:
    """ref: priorities.go:98-134 CalculateNodeLabelPriority (policy-only)."""

    def __init__(self, label: str, presence: bool):
        self.label = label
        self.presence = presence

    def calculate_node_label_priority(self, pod: api.Pod, pod_lister,
                                      minion_lister) -> List[HostPriority]:
        minions = minion_lister.list()
        result = []
        for minion in minions.items:
            exists = self.label in (minion.metadata.labels or {})
            success = (exists and self.presence) or (not exists and not self.presence)
            result.append(HostPriority(host=minion.metadata.name,
                                       score=10 if success else 0))
        return result


def equal_priority(pod: api.Pod, pod_lister, minion_lister) -> List[HostPriority]:
    """ref: generic_scheduler.go:180-195 EqualPriority — constant 1."""
    nodes = minion_lister.list()
    return [HostPriority(host=m.metadata.name, score=1) for m in nodes.items]


def _ns_service_pods(pod: api.Pod, pod_lister, service_lister) -> List[api.Pod]:
    """Shared lookup: peers of the pod's first matching service in the same
    namespace (ref: spreading.go:40-57)."""
    services = service_lister.get_pod_services(pod)
    if not services:
        return []
    selector = labels_pkg.selector_from_set(services[0].spec.selector)
    pods = pod_lister.list(selector)
    return [p for p in pods if p.metadata.namespace == pod.metadata.namespace]


class ServiceSpread:
    """ref: spreading.go:26-86 CalculateSpreadPriority — minimize same-service
    pods per node (ancestor of topology spread)."""

    def __init__(self, service_lister):
        self.service_lister = service_lister

    def calculate_spread_priority(self, pod: api.Pod, pod_lister,
                                  minion_lister) -> List[HostPriority]:
        ns_service_pods = _ns_service_pods(pod, pod_lister, self.service_lister)
        minions = minion_lister.list()

        counts: dict = {}
        max_count = 0
        for p in ns_service_pods:
            counts[p.status.host] = counts.get(p.status.host, 0) + 1
            if counts[p.status.host] > max_count:
                max_count = counts[p.status.host]

        result = []
        for minion in minions.items:
            score = 10
            if max_count > 0:
                score = spread_score_f32(max_count, counts.get(minion.metadata.name, 0))
            result.append(HostPriority(host=minion.metadata.name, score=score))
        return result


class ServiceAntiAffinity:
    """ref: spreading.go:88-168 CalculateAntiAffinityPriority (policy-only) —
    spread service pods across values of a node label (zone spreading)."""

    def __init__(self, service_lister, label: str):
        self.service_lister = service_lister
        self.label = label

    def calculate_anti_affinity_priority(self, pod: api.Pod, pod_lister,
                                         minion_lister) -> List[HostPriority]:
        ns_service_pods = _ns_service_pods(pod, pod_lister, self.service_lister)
        minions = minion_lister.list()

        other_minions: List[str] = []
        labeled_minions: dict = {}
        for minion in minions.items:
            lbls = minion.metadata.labels or {}
            if self.label in lbls:
                labeled_minions[minion.metadata.name] = lbls[self.label]
            else:
                other_minions.append(minion.metadata.name)

        pod_counts: dict = {}
        for p in ns_service_pods:
            label = labeled_minions.get(p.status.host)
            if label is None:
                continue
            pod_counts[label] = pod_counts.get(label, 0) + 1

        num_service_pods = len(ns_service_pods)
        result = []
        for minion in labeled_minions:
            score = 10
            if num_service_pods > 0:
                score = spread_score_f32(num_service_pods,
                                         pod_counts.get(labeled_minions[minion], 0))
            result.append(HostPriority(host=minion, score=score))
        for minion in other_minions:
            result.append(HostPriority(host=minion, score=0))
        return result
