"""Fit predicates — pure functions, the Filter phase.

Port of ``kubernetes_tpu/scheduler/predicates.py`` (ref:
``pkg/scheduler/predicates.go``), whole: the serial scheduler's filters,
and the resource accounting the snapshot encoder shares with them. Signature mirrors the reference's
``FitPredicate`` (types.go:24): ``predicate(pod, existing_pods, node_name) ->
bool``. Semantics are mirrored exactly — these are the serial semantics the
batch solve (models/batch_solver.py, the commit_solve kernel) must agree
with bit for bit:

- PodFitsResources (:127-152): zero-request pods always fit; greedy
  sequential capacity accounting via check_pods_exceeding_capacity (:104-124)
  where a zero capacity dimension means "unlimited".
- PodFitsPorts (:326-350): HostPort conflicts, port 0 ignored.
- NoDiskConflict (:68-83): exclusive GCE PD mounts.
- MatchNodeSelector (:161-179), HostName (:181-186).
- CheckNodeLabelPresence (:194-229) and CheckServiceAffinity (:238-324),
  the policy-configured predicates.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api

__all__ = [
    "FitPredicate", "get_resource_request", "check_pods_exceeding_capacity",
    "resource_value", "capacity_values", "resource_universe", "dim_fits",
    "ResourceFit", "NodeSelector", "pod_fits_host", "NodeLabelChecker",
    "ServiceAffinity", "pod_fits_ports", "get_used_ports", "no_disk_conflict",
    "map_pods_to_machines",
]

FitPredicate = Callable[[api.Pod, List[api.Pod], str], bool]


def resource_value(name: str, q) -> int:
    """Canonical integer for one resource dimension: CPU counts milli-units
    (predicates.go:96 ``MilliValue``), everything else whole units."""
    return q.milli_value() if name == api.ResourceCPU else q.int_value()


def get_resource_request(pod: api.Pod) -> Dict[str, int]:
    """ref: predicates.go:93-101 getResourceRequest — container limits,
    generalized from the reference's hard-coded cpu+memory pair to every
    resource dimension the pod names (the R-dimensional model the BASELINE
    3-resource bin-packing config exercises). Returns {resource: amount}
    with CPU in milli-units."""
    r: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, q in c.resources.limits.items():
            r[name] = r.get(name, 0) + resource_value(name, q)
    return r


def capacity_values(capacity: Optional[dict]) -> Dict[str, int]:
    """Canonical integer capacity per advertised dimension."""
    return {name: resource_value(name, q)
            for name, q in (capacity or {}).items()}


def resource_universe(nodes) -> List[str]:
    """The wave's *scored* resource dimensions: cpu and memory always
    (reference parity — predicates.go/priorities.go hard-code them), plus
    every other resource any node advertises, sorted. LeastRequested
    averages its per-dimension scores over exactly this set, so it is
    derivable from the node list alone and stable across a wave. Dimensions
    only *requested* but advertised nowhere still constrain (see
    ``dim_fits``) but score zero everywhere, so they are excluded here.
    Shared by the serial path and the snapshot encoder — both must agree
    for the bit-identical contract."""
    extras = set()
    for n in nodes:
        for name in (n.spec.capacity or {}):
            if name not in (api.ResourceCPU, api.ResourceMemory):
                extras.add(name)
    return [api.ResourceCPU, api.ResourceMemory] + sorted(extras)


def dim_fits(name: str, cap: int, free: int, req: int) -> bool:
    """Per-dimension fit rule. cpu/memory: zero capacity never constrains
    (predicates.go:117-118 — reference parity). Every other dimension is an
    extended resource: absent/zero capacity cannot satisfy a nonzero
    request (a GPU pod must not land on a GPU-less node)."""
    if name in (api.ResourceCPU, api.ResourceMemory) and cap == 0:
        return True
    return free >= req


def check_pods_exceeding_capacity(pods: List[api.Pod], capacity: dict
                                  ) -> Tuple[List[api.Pod], List[api.Pod]]:
    """ref: predicates.go:104-124 CheckPodsExceedingCapacity.

    Greedy in-order accounting over every requested dimension (cpu+memory
    exactly as the reference; extended resources per ``dim_fits``).
    Returns (fitting, not_fitting).
    """
    caps = capacity_values(capacity)
    used: Dict[str, int] = {}
    fitting: List[api.Pod] = []
    not_fitting: List[api.Pod] = []
    for p in pods:
        req = get_resource_request(p)
        fits = all(
            dim_fits(k, caps.get(k, 0), caps.get(k, 0) - used.get(k, 0), v)
            for k, v in req.items())
        if not fits:
            not_fitting.append(p)
            continue
        for k, v in req.items():
            used[k] = used.get(k, 0) + v
        fitting.append(p)
    return fitting, not_fitting


class ResourceFit:
    """ref: predicates.go:127-152 ResourceFit.PodFitsResources.

    The zero-request fast path (:129 "no resources requested always fits")
    generalizes to: a pod requesting a zero amount of every dimension it
    names fits unconditionally — identical to the reference for cpu+memory
    pods, and exactly the batch solver's ``zero_req`` test."""

    def __init__(self, node_info):
        self.info = node_info

    def pod_fits_resources(self, pod: api.Pod, existing_pods: List[api.Pod],
                           node: str) -> bool:
        req = get_resource_request(pod)
        if not any(req.values()):
            return True  # no resources requested always fits (:129)
        info = self.info.get_node_info(node)
        pods = list(existing_pods) + [pod]
        _, exceeding = check_pods_exceeding_capacity(pods, info.spec.capacity)
        return len(exceeding) == 0


def pod_matches_node_labels(pod: api.Pod, node: api.Node) -> bool:
    """ref: predicates.go:161-168 PodMatchesNodeLabels."""
    if not pod.spec.node_selector:
        return True
    sel = labels_pkg.selector_from_set(pod.spec.node_selector)
    return sel.matches(node.metadata.labels)


class NodeSelector:
    """ref: predicates.go:170-179 NodeSelector.PodSelectorMatches."""

    def __init__(self, node_info):
        self.info = node_info

    def pod_selector_matches(self, pod: api.Pod, existing_pods: List[api.Pod],
                             node: str) -> bool:
        return pod_matches_node_labels(pod, self.info.get_node_info(node))


def pod_fits_host(pod: api.Pod, existing_pods: List[api.Pod], node: str) -> bool:
    """ref: predicates.go:181-186 PodFitsHost."""
    if not pod.spec.host:
        return True
    return pod.spec.host == node


class Schedulable:
    """kubectl cordon's scheduler-side half: a node with
    ``spec.unschedulable`` set admits no new pods (ref: 1.1-era
    factory.go pollMinions skipping Spec.Unschedulable). Structural, not
    policy vocabulary — the dense path folds the same gate into
    ``node_extra_ok`` unconditionally, so plugins.predicates_from_policy
    always includes this predicate regardless of the policy file."""

    def __init__(self, node_info):
        self.info = node_info

    def pod_is_schedulable(self, pod: api.Pod, existing_pods: List[api.Pod],
                           node: str) -> bool:
        return not self.info.get_node_info(node).spec.unschedulable


class NodeLabelChecker:
    """ref: predicates.go:194-229 CheckNodeLabelPresence (policy-only)."""

    def __init__(self, node_info, labels: List[str], presence: bool):
        self.info = node_info
        self.labels = labels
        self.presence = presence

    def check_node_label_presence(self, pod: api.Pod, existing_pods: List[api.Pod],
                                  node: str) -> bool:
        minion = self.info.get_node_info(node)
        minion_labels = minion.metadata.labels or {}
        for label in self.labels:
            exists = label in minion_labels
            if (exists and not self.presence) or (not exists and self.presence):
                return False
        return True


class ServiceAffinity:
    """ref: predicates.go:238-324 CheckServiceAffinity (policy-only) —
    co-locate service peers on nodes sharing label values (the ancestor of
    inter-pod affinity)."""

    def __init__(self, pod_lister, service_lister, node_info, labels: List[str]):
        self.pod_lister = pod_lister
        self.service_lister = service_lister
        self.node_info = node_info
        self.labels = labels

    def check_service_affinity(self, pod: api.Pod, existing_pods: List[api.Pod],
                               node: str) -> bool:
        affinity_labels: Dict[str, str] = {}
        node_selector = pod.spec.node_selector or {}
        labels_exist = True
        for l in self.labels:
            if l in node_selector:
                affinity_labels[l] = node_selector[l]
            else:
                labels_exist = False
        if not labels_exist:
            services = self.service_lister.get_pod_services(pod)
            if services:
                sel = labels_pkg.selector_from_set(services[0].spec.selector)
                service_pods = self.pod_lister.list(sel)
                ns_service_pods = [p for p in service_pods
                                   if p.metadata.namespace == pod.metadata.namespace]
                if ns_service_pods:
                    other = self.node_info.get_node_info(ns_service_pods[0].status.host)
                    other_labels = other.metadata.labels or {}
                    for l in self.labels:
                        if l in affinity_labels:
                            continue
                        if l in other_labels:
                            affinity_labels[l] = other_labels[l]
        if not affinity_labels:
            affinity_selector = labels_pkg.everything()
        else:
            affinity_selector = labels_pkg.selector_from_set(affinity_labels)
        minion = self.node_info.get_node_info(node)
        return affinity_selector.matches(minion.metadata.labels)


def get_used_ports(*pods: api.Pod) -> set:
    """ref: predicates.go:340-350 getUsedPorts — keyed on HostPort only."""
    ports = set()
    for pod in pods:
        for c in pod.spec.containers:
            for p in c.ports:
                ports.add(p.host_port)
    return ports


def pod_fits_ports(pod: api.Pod, existing_pods: List[api.Pod], node: str) -> bool:
    """ref: predicates.go:326-338 PodFitsPorts."""
    existing_ports = get_used_ports(*existing_pods)
    want_ports = get_used_ports(pod)
    for wport in want_ports:
        if wport == 0:
            continue
        if wport in existing_ports:
            return False
    return True


def _is_volume_conflict(volume: api.Volume, pod: api.Pod) -> bool:
    """ref: predicates.go:40-66 isVolumeConflict — GCE PD exclusivity."""
    gce = volume.source.gce_persistent_disk
    if gce is None:
        return False
    for v in pod.spec.volumes:
        other = v.source.gce_persistent_disk
        if other is not None and other.pd_name == gce.pd_name:
            return True
    return False


def no_disk_conflict(pod: api.Pod, existing_pods: List[api.Pod], node: str) -> bool:
    """ref: predicates.go:68-83 NoDiskConflict."""
    for volume in pod.spec.volumes:
        for existing in existing_pods:
            if _is_volume_conflict(volume, existing):
                return False
    return True


def map_pods_to_machines(pod_lister) -> Dict[str, List[api.Pod]]:
    """ref: predicates.go:354-375 MapPodsToMachines — pivots ALL pods into a
    host -> pods map using status.host, rebuilt per scheduling cycle. This is
    the quadratic-ish cost the snapshot encoder replaces."""
    machine_to_pods: Dict[str, List[api.Pod]] = {}
    for pod in pod_lister.list(labels_pkg.everything()):
        machine_to_pods.setdefault(pod.status.host, []).append(pod)
    return machine_to_pods
