"""The generic scheduler — Filter then Score then select.

Port of ``kubernetes_tpu/scheduler/generic.py`` (ref:
``pkg/scheduler/generic_scheduler.go:54-195``). One deliberate,
documented divergence: ``select_host`` replaces the reference's
``rand.Int() % len(bestHosts)`` (generic_scheduler.go:84-96) with a
deterministic FNV-1a hash of the pod's identity modulo the best-host count,
over best hosts in node-list order. This keeps the "spread ties randomly"
behavior across pods while making the serial path a reproducible oracle that
the batch solver (models/batch_solver.py) matches bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.scheduler.listers import FakeMinionLister
from kubernetes_tpu_torch.scheduler.predicates import (FitPredicate,
                                                       map_pods_to_machines)
from kubernetes_tpu_torch.scheduler.priorities import (
    HostPriority,
    PriorityConfig,
    equal_priority,
)

__all__ = ["FNV64_OFFSET", "FNV64_PRIME", "FitError", "GenericScheduler",
           "fnv1a64", "pod_tie_break_key", "select_host_deterministic"]

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3


def fnv1a64(data: str) -> int:
    h = FNV64_OFFSET
    for b in data.encode("utf-8"):
        h ^= b
        h = (h * FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def pod_tie_break_key(pod: api.Pod) -> str:
    return pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"


class FitError(Exception):
    """ref: generic_scheduler.go:31-44 FitError."""

    def __init__(self, pod: api.Pod, failed_predicates: Dict[str, Set[str]]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        detail = "".join(
            f" Node {node}: {','.join(sorted(names))}."
            for node, names in sorted(failed_predicates.items()))
        super().__init__(
            f"failed to find fit for pod {pod.metadata.namespace}/{pod.metadata.name}:{detail}")


def select_host_deterministic(priority_list: List[HostPriority], tie_break_key: str) -> str:
    """ref: generic_scheduler.go:84-96 selectHost + getBestHosts, with the
    deterministic hash choice documented above. ``priority_list`` order is the
    node-list order (stable)."""
    if not priority_list:
        raise ValueError("empty priorityList")
    top = max(hp.score for hp in priority_list)
    best = [hp.host for hp in priority_list if hp.score == top]
    ix = fnv1a64(tie_break_key) % len(best)
    return best[ix]


class GenericScheduler:
    """ref: generic_scheduler.go genericScheduler."""

    def __init__(self, predicates: Dict[str, FitPredicate],
                 prioritizers: List[PriorityConfig], pod_lister):
        self.predicates = dict(predicates)
        self.prioritizers = list(prioritizers)
        self.pod_lister = pod_lister

    def schedule(self, pod: api.Pod, minion_lister) -> str:
        """ref: generic_scheduler.go:54-80 Schedule."""
        minions = minion_lister.list()
        if not minions.items:
            raise FitError(pod, {})
        filtered, failed = self.find_nodes_that_fit(pod, minions)
        priority_list = self.prioritize_nodes(pod, FakeMinionLister(filtered))
        if not priority_list:
            raise FitError(pod, failed)
        return select_host_deterministic(priority_list, pod_tie_break_key(pod))

    def find_nodes_that_fit(self, pod: api.Pod, nodes: api.NodeList
                            ) -> Tuple[api.NodeList, Dict[str, Set[str]]]:
        """ref: generic_scheduler.go:100-128 — THE serial hot loop the
        batch solve replaces: nodes x predicates with short-circuit."""
        filtered: List[api.Node] = []
        machine_to_pods = map_pods_to_machines(self.pod_lister)
        failed: Dict[str, Set[str]] = {}
        for node in nodes.items:
            name = node.metadata.name
            fits = True
            for pred_name, predicate in self.predicates.items():
                if not predicate(pod, machine_to_pods.get(name, []), name):
                    fits = False
                    failed.setdefault(name, set()).add(pred_name)
                    break
            if fits:
                filtered.append(node)
        return api.NodeList(items=filtered), failed

    def prioritize_nodes(self, pod: api.Pod, minion_lister) -> List[HostPriority]:
        """ref: generic_scheduler.go:136-165 prioritizeNodes — weighted sum.

        The result is emitted in node-list order regardless of the order each
        priority function produced entries (ServiceAntiAffinity, for one,
        emits labeled nodes first) — the deterministic tie-break contract
        requires a canonical order shared with the batch solver."""
        if not self.prioritizers:
            return equal_priority(pod, self.pod_lister, minion_lister)
        combined: Dict[str, int] = {}
        for config in self.prioritizers:
            if config.weight == 0:
                continue
            for entry in config.function(pod, self.pod_lister, minion_lister):
                combined[entry.host] = combined.get(entry.host, 0) + entry.score * config.weight
        node_order = [n.metadata.name for n in minion_lister.list().items]
        return [HostPriority(host=h, score=combined[h])
                for h in node_order if h in combined]
