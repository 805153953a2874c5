"""API objects the scheduler reads.

Port of ``kubernetes_tpu/api/types.py`` (ref: pkg/api/types.go) trimmed to
the fields the wave scheduler touches: object and list metadata;
Node/NodeSpec/NodeStatus (the conditions the node poller filters on);
Pod/PodSpec/PodStatus with containers, host ports, resource limits and GCE
PD volumes; Service/ServiceSpec; the typed lists; Binding and its batch
form with per-pod results; Event and Status. Field names match the
reference, so one fixture function can construct a cluster through either
package.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.quantity import Quantity

NamespaceDefault = "default"
NamespaceAll = ""

ConditionTrue = "True"

# NodeConditionType (ref: types.go NodeReady/NodeReachable/NodeSchedulable)
NodeReady = "Ready"
NodeReachable = "Reachable"
NodeSchedulable = "Schedulable"

StatusFailure = "Failure"
ReasonNotFound = "NotFound"
ReasonExpired = "Expired"
ReasonConflict = "Conflict"

ResourceCPU = "cpu"
ResourceMemory = "memory"

# PreemptionPolicy: whether a pod may claim a node by evicting
# strictly-lower-priority pods.
PreemptNever = "Never"
DefaultPodPriority = 0

ResourceList = Dict[str, Quantity]  # resource name -> Quantity


@dataclass
class ObjectMeta:
    """ref: types.go ObjectMeta (:83-141)."""

    name: str = ""
    generate_name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    creation_timestamp: Optional[datetime.datetime] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


@dataclass
class ListMeta:
    resource_version: str = ""


@dataclass
class ObjectReference:
    """ref: types.go ObjectReference (:1330-1360)."""

    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    resource_version: str = ""


@dataclass
class GCEPersistentDiskVolumeSource:
    pd_name: str = ""


@dataclass
class VolumeSource:
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None


@dataclass
class Volume:
    name: str = ""
    source: VolumeSource = field(default_factory=VolumeSource)


@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0


@dataclass
class ResourceRequirements:
    limits: ResourceList = field(default_factory=dict)


@dataclass
class Container:
    name: str = ""
    image: str = ""
    ports: List[ContainerPort] = field(default_factory=list)
    resources: ResourceRequirements = field(
        default_factory=ResourceRequirements)


@dataclass
class PodSpec:
    """ref: types.go PodSpec (:695-719), plus the admission-resolved
    priority fields the preemption emit gate reads."""

    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    host: str = ""
    priority: Optional[int] = None
    preemption_policy: str = ""


@dataclass
class PodStatus:
    host: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class PodList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Pod] = field(default_factory=list)


@dataclass
class ServiceSpec:
    port: int = 0
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class ServiceList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Service] = field(default_factory=list)


@dataclass
class NodeSpec:
    capacity: ResourceList = field(default_factory=dict)
    unschedulable: bool = False


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""


@dataclass
class NodeStatus:
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class NodeList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Node] = field(default_factory=list)


@dataclass
class Binding:
    """ref: types.go Binding — POST pods/{name}/binding. ``victims`` makes
    it an atomic evict+bind: every victim is deleted and the pod bound in
    one step, or nothing applies (a preempting placement fills it)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_name: str = ""
    host: str = ""
    victims: List[ObjectReference] = field(default_factory=list)


@dataclass
class BindingList:
    """A wave's bindings, committed in one transactional store pass; each
    item keeps the per-pod CAS semantics, results come back positionally."""

    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Binding] = field(default_factory=list)


@dataclass
class BindingResult:
    pod_name: str = ""
    error: str = ""      # empty = bound; else the per-pod failure message
    code: int = 0        # HTTP-ish status code for the failure


@dataclass
class BindingResultList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[BindingResult] = field(default_factory=list)


@dataclass
class StatusDetails:
    name: str = ""
    kind: str = ""


@dataclass
class Status:
    status: str = ""
    message: str = ""
    reason: str = ""
    details: Optional[StatusDetails] = None
    code: int = 0


@dataclass
class EventSource:
    component: str = ""
    host: str = ""


@dataclass
class Event:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    source: EventSource = field(default_factory=EventSource)
    first_timestamp: Optional[datetime.datetime] = None
    last_timestamp: Optional[datetime.datetime] = None
    count: int = 0


def pod_priority(pod: Pod) -> int:
    """The scheduler-effective priority: the resolved spec.priority, 0
    when unresolved."""
    p = pod.spec.priority
    return DefaultPodPriority if p is None else int(p)


def pod_can_preempt(pod: Pod) -> bool:
    """The resolved spec.preemption_policy, defaulting to
    PreemptLowerPriority like the upstream API."""
    return pod.spec.preemption_policy != PreemptNever
