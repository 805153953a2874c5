"""API objects the scheduler reads.

Port of ``kubernetes_tpu/api/types.py`` (ref: pkg/api/types.go) trimmed to
the fields the wave encoder touches: object metadata; Node/NodeSpec;
Pod/PodSpec/PodStatus with containers, host ports, resource limits and GCE
PD volumes; Service/ServiceSpec. Field names match the reference, so one
builder can construct a cluster through either package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.quantity import Quantity

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
    namespace: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


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
class ServiceSpec:
    port: int = 0
    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class NodeSpec:
    capacity: ResourceList = field(default_factory=dict)
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)


def pod_priority(pod: Pod) -> int:
    """The scheduler-effective priority: the resolved spec.priority, 0
    when unresolved."""
    p = pod.spec.priority
    return DefaultPodPriority if p is None else int(p)


def pod_can_preempt(pod: Pod) -> bool:
    """The resolved spec.preemption_policy, defaulting to
    PreemptLowerPriority like the upstream API."""
    return pod.spec.preemption_policy != PreemptNever
