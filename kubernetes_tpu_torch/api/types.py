"""API objects the scheduler lists, watches, posts or gets back as errors.

Port of ``kubernetes_tpu/api/types.py`` (ref: pkg/api/types.go) with the
full field set of every kind the scheduler binary exchanges with an
apiserver: Pod/PodList (containers, probes, volumes, statuses), Node/
NodeList (capacity, conditions, addresses, system info), Service/
ServiceList, Binding (with its evict+bind ``victims``) and its batch form
with per-pod results, Event/EventList and Status. A decoded object
therefore carries every wire field the reference encodes, and writing it
back drops nothing. Field names, defaults and declared ``kind``\\s match
the reference, so one fixture function can construct a cluster through
either package. The kinds the scheduler never touches (controllers,
namespaces, secrets, quotas, priority classes) are not ported.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.quantity import Quantity

NamespaceDefault = "default"
NamespaceAll = ""

# PodPhase (ref: types.go:550-570)
PodPending = "Pending"
PodRunning = "Running"
PodSucceeded = "Succeeded"
PodFailed = "Failed"

# ConditionStatus (ref: types.go:608-618)
ConditionTrue = "True"
ConditionFalse = "False"
ConditionUnknown = "Unknown"

RestartPolicyAlways = "Always"
DNSClusterFirst = "ClusterFirst"
ProtocolTCP = "TCP"
AffinityNone = "None"

# NodeConditionType (ref: types.go NodeReady/NodeReachable/NodeSchedulable)
NodeReady = "Ready"
NodeReachable = "Reachable"
NodeSchedulable = "Schedulable"

StatusSuccess = "Success"
StatusFailure = "Failure"
ReasonNotFound = "NotFound"
ReasonAlreadyExists = "AlreadyExists"
ReasonConflict = "Conflict"
ReasonExpired = "Expired"

ResourceCPU = "cpu"
ResourceMemory = "memory"

# PreemptionPolicy: whether a pod may claim a node by evicting
# strictly-lower-priority pods.
PreemptNever = "Never"
DefaultPodPriority = 0

# the component name the scheduler's events carry
DefaultSchedulerName = "scheduler"

ResourceList = Dict[str, Quantity]  # resource name -> Quantity


# -- metadata -----------------------------------------------------------------

@dataclass
class ObjectMeta:
    """ref: types.go ObjectMeta (:83-141)."""

    name: str = ""
    generate_name: str = ""
    namespace: str = ""
    self_link: str = ""
    uid: str = ""
    resource_version: str = ""
    creation_timestamp: Optional[datetime.datetime] = None
    deletion_timestamp: Optional[datetime.datetime] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


@dataclass
class ListMeta:
    self_link: str = ""
    resource_version: str = ""


@dataclass
class ObjectReference:
    """ref: types.go ObjectReference (:1330-1360)."""

    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    resource_version: str = ""
    field_path: str = ""


# -- volumes (ref: types.go:147-330) ------------------------------------------

@dataclass
class EmptyDirVolumeSource:
    medium: str = ""


@dataclass
class HostPathVolumeSource:
    path: str = ""


@dataclass
class GCEPersistentDiskVolumeSource:
    pd_name: str = ""
    fs_type: str = ""
    partition: int = 0
    read_only: bool = False


@dataclass
class GitRepoVolumeSource:
    repository: str = ""
    revision: str = ""


@dataclass
class SecretVolumeSource:
    secret_name: str = ""


@dataclass
class NFSVolumeSource:
    server: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class VolumeSource:
    empty_dir: Optional[EmptyDirVolumeSource] = None
    host_path: Optional[HostPathVolumeSource] = None
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    git_repo: Optional[GitRepoVolumeSource] = None
    secret: Optional[SecretVolumeSource] = None
    nfs: Optional[NFSVolumeSource] = None


@dataclass
class Volume:
    name: str = ""
    source: VolumeSource = field(default_factory=VolumeSource)


@dataclass
class VolumeMount:
    name: str = ""
    read_only: bool = False
    mount_path: str = ""


# -- containers and probes (ref: types.go:330-550) ----------------------------

@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = ProtocolTCP
    host_ip: str = ""


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""


@dataclass
class ExecAction:
    command: List[str] = field(default_factory=list)


@dataclass
class HTTPGetAction:
    path: str = ""
    port: int = 0
    host: str = ""


@dataclass
class TCPSocketAction:
    port: int = 0


@dataclass
class Handler:
    exec: Optional[ExecAction] = None
    http_get: Optional[HTTPGetAction] = None
    tcp_socket: Optional[TCPSocketAction] = None


@dataclass
class Probe:
    exec: Optional[ExecAction] = None
    http_get: Optional[HTTPGetAction] = None
    tcp_socket: Optional[TCPSocketAction] = None
    initial_delay_seconds: int = 0
    timeout_seconds: int = 1


@dataclass
class Lifecycle:
    post_start: Optional[Handler] = None
    pre_stop: Optional[Handler] = None


@dataclass
class ResourceRequirements:
    limits: ResourceList = field(default_factory=dict)
    requests: ResourceList = field(default_factory=dict)


@dataclass
class Container:
    """ref: types.go Container (:420-470)."""

    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    working_dir: str = ""
    ports: List[ContainerPort] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: ResourceRequirements = field(
        default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    lifecycle: Optional[Lifecycle] = None
    termination_message_path: str = "/dev/termination-log"
    privileged: bool = False
    image_pull_policy: str = ""


@dataclass
class ContainerStateWaiting:
    reason: str = ""


@dataclass
class ContainerStateRunning:
    started_at: Optional[datetime.datetime] = None


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    signal: int = 0
    reason: str = ""
    message: str = ""
    started_at: Optional[datetime.datetime] = None
    finished_at: Optional[datetime.datetime] = None


@dataclass
class ContainerState:
    waiting: Optional[ContainerStateWaiting] = None
    running: Optional[ContainerStateRunning] = None
    termination: Optional[ContainerStateTerminated] = None


@dataclass
class ContainerStatus:
    """ref: types.go ContainerStatus (:583-607)."""

    name: str = ""
    state: ContainerState = field(default_factory=ContainerState)
    last_termination_state: ContainerState = field(
        default_factory=ContainerState)
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    image_id: str = ""
    container_id: str = ""


# -- pods (ref: types.go:620-815) ---------------------------------------------

@dataclass
class PodCondition:
    type: str = ""
    status: str = ""


@dataclass
class PodSpec:
    """ref: types.go PodSpec (:695-720), plus the admission-resolved
    priority fields the preemption emit gate reads (``priority`` None =
    unresolved, treated as 0)."""

    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = RestartPolicyAlways
    termination_grace_period_seconds: Optional[int] = None
    dns_policy: str = DNSClusterFirst
    node_selector: Dict[str, str] = field(default_factory=dict)
    host: str = ""
    host_network: bool = False
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: str = ""


@dataclass
class PodStatus:
    """ref: types.go PodStatus (:721-745)."""

    phase: str = ""
    conditions: List[PodCondition] = field(default_factory=list)
    message: str = ""
    host: str = ""
    host_ip: str = ""
    pod_ip: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"


@dataclass
class PodList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Pod] = field(default_factory=list)
    kind: str = "PodList"


# -- services (ref: types.go:881-952) -----------------------------------------

@dataclass
class ServiceSpec:
    """ref: types.go ServiceSpec (:908-940)."""

    port: int = 0
    protocol: str = ProtocolTCP
    selector: Dict[str, str] = field(default_factory=dict)
    portal_ip: str = ""
    create_external_load_balancer: bool = False
    public_ips: List[str] = field(default_factory=list)
    container_port: int = 0  # target port on the pod
    session_affinity: str = AffinityNone


@dataclass
class ServiceStatus:
    pass


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: ServiceStatus = field(default_factory=ServiceStatus)
    kind: str = "Service"


@dataclass
class ServiceList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Service] = field(default_factory=list)
    kind: str = "ServiceList"


# -- nodes (ref: types.go:953-1124) -------------------------------------------

@dataclass
class NodeSpec:
    """ref: types.go NodeSpec — capacity lives on the spec in this era and
    is what the scheduler reads (ref: pkg/scheduler/predicates.go:137)."""

    capacity: ResourceList = field(default_factory=dict)
    pod_cidr: str = ""
    external_id: str = ""
    unschedulable: bool = False


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""
    last_probe_time: Optional[datetime.datetime] = None
    last_transition_time: Optional[datetime.datetime] = None
    reason: str = ""
    message: str = ""


@dataclass
class NodeAddress:
    type: str = ""
    address: str = ""


@dataclass
class NodeSystemInfo:
    machine_id: str = ""
    system_uuid: str = ""
    boot_id: str = ""
    kernel_version: str = ""
    os_image: str = ""
    container_runtime_version: str = ""
    kubelet_version: str = ""


@dataclass
class NodeStatus:
    phase: str = ""
    conditions: List[NodeCondition] = field(default_factory=list)
    addresses: List[NodeAddress] = field(default_factory=list)
    node_info: NodeSystemInfo = field(default_factory=NodeSystemInfo)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"


@dataclass
class NodeList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Node] = field(default_factory=list)
    kind: str = "NodeList"


# -- binding (ref: types.go:1145-1155) ----------------------------------------

@dataclass
class Binding:
    """ref: types.go Binding — POST pods/{name}/binding. ``victims`` makes
    it an atomic evict+bind: every victim is deleted and the pod bound in
    one step, or nothing applies (a preempting placement fills it).
    ``from_host``/``pod_uid`` mark a migration bind, which the scheduler
    never sets."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_name: str = ""
    host: str = ""
    victims: List[ObjectReference] = field(default_factory=list)
    from_host: str = ""
    pod_uid: str = ""
    kind: str = "Binding"


@dataclass
class BindingList:
    """A wave's bindings, committed in one transactional store pass; each
    item keeps the per-pod CAS semantics, results come back positionally."""

    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Binding] = field(default_factory=list)
    kind: str = "BindingList"


@dataclass
class BindingResult:
    pod_name: str = ""
    error: str = ""      # empty = bound; else the per-pod failure message
    code: int = 0        # HTTP-ish status code for the failure


@dataclass
class BindingResultList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[BindingResult] = field(default_factory=list)
    kind: str = "BindingResultList"


# -- status (ref: types.go:1167-1330) -----------------------------------------

@dataclass
class StatusCause:
    reason: str = ""
    message: str = ""
    field_path: str = ""


@dataclass
class StatusDetails:
    name: str = ""
    kind: str = ""
    causes: List[StatusCause] = field(default_factory=list)
    retry_after_seconds: int = 0


@dataclass
class Status:
    metadata: ListMeta = field(default_factory=ListMeta)
    status: str = ""
    message: str = ""
    reason: str = ""
    details: Optional[StatusDetails] = None
    code: int = 0
    kind: str = "Status"


# -- events (ref: types.go:1383-1420) -----------------------------------------

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
    kind: str = "Event"


@dataclass
class EventList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Event] = field(default_factory=list)
    kind: str = "EventList"


def pod_priority(pod: Pod) -> int:
    """The scheduler-effective priority: the resolved spec.priority, 0
    when unresolved."""
    p = pod.spec.priority
    return DefaultPodPriority if p is None else int(p)


def pod_can_preempt(pod: Pod) -> bool:
    """The resolved spec.preemption_policy, defaulting to
    PreemptLowerPriority like the upstream API."""
    return pod.spec.preemption_policy != PreemptNever
