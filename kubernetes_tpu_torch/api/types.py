"""Internal API object model.

Port of ``kubernetes_tpu/api/types.py``.

Rebuild of the reference's internal types (ref: pkg/api/types.go:1-1623):
Pod/PodSpec/PodStatus (:695-758), ReplicationController (:816), Service
(:908), Endpoints (:921), Node/NodeSpec/NodeStatus (:953-1087), Namespace
(:1125), Binding (:1145), Event (:1383), Status (:1167), plus the container,
volume, probe, and condition substructures they reference.

These are plain dataclasses; wire encoding/decoding and versioning live in
kubernetes_tpu_torch.runtime (scheme + serialize), keeping the internal model
version-free exactly like the reference's ``pkg/api`` package.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.quantity import Quantity

# ---------------------------------------------------------------------------
# Constants / enums (string enums, like the reference)
# ---------------------------------------------------------------------------

NamespaceDefault = "default"
NamespaceAll = ""
NamespaceNone = ""

# PodPhase (ref: types.go:550-570)
PodPending = "Pending"
PodRunning = "Running"
PodSucceeded = "Succeeded"
PodFailed = "Failed"
PodUnknown = "Unknown"

# ConditionStatus (ref: types.go:608-618)
ConditionTrue = "True"
ConditionFalse = "False"
ConditionUnknown = "Unknown"

# PodConditionType
PodReady = "Ready"

# RestartPolicy
RestartPolicyAlways = "Always"
RestartPolicyOnFailure = "OnFailure"
RestartPolicyNever = "Never"

# DNSPolicy
DNSClusterFirst = "ClusterFirst"
DNSDefault = "Default"

# Protocols
ProtocolTCP = "TCP"
ProtocolUDP = "UDP"

# PullPolicy (ref: types.go PullAlways/PullNever/PullIfNotPresent)
PullAlways = "Always"
PullNever = "Never"
PullIfNotPresent = "IfNotPresent"

# Resource names (ref: types.go ResourceCPU/ResourceMemory + quota names)
ResourceCPU = "cpu"
ResourceMemory = "memory"
ResourcePods = "pods"
ResourceServices = "services"
ResourceReplicationControllers = "replicationcontrollers"
ResourceQuotas = "resourcequotas"
ResourceSecrets = "secrets"

# NodeConditionType (ref: types.go NodeReady/NodeReachable/NodeSchedulable)
NodeReady = "Ready"
NodeReachable = "Reachable"
NodeSchedulable = "Schedulable"

# NodePhase
NodePending = "Pending"
NodeRunning = "Running"
NodeTerminated = "Terminated"

# NodeAddressType
NodeInternalIP = "InternalIP"
NodeExternalIP = "ExternalIP"
NodeHostName = "Hostname"

# NamespacePhase (ref: types.go NamespaceActive/NamespaceTerminating)
NamespaceActive = "Active"
NamespaceTerminating = "Terminating"
FinalizerKubernetes = "kubernetes"

# Status values (ref: types.go:1167-1260)
StatusSuccess = "Success"
StatusFailure = "Failure"

# StatusReason (ref: types.go:1203-1260)
ReasonNotFound = "NotFound"
ReasonAlreadyExists = "AlreadyExists"
ReasonConflict = "Conflict"
ReasonInvalid = "Invalid"
ReasonBadRequest = "BadRequest"
ReasonForbidden = "Forbidden"
ReasonUnauthorized = "Unauthorized"
ReasonMethodNotAllowed = "MethodNotAllowed"
ReasonInternalError = "InternalError"
ReasonExpired = "Expired"
ReasonTooManyRequests = "TooManyRequests"

# Session affinity
AffinityNone = "None"
AffinityClientIP = "ClientIP"

# PreemptionPolicy (PriorityClass / PodSpec): whether a pod of this
# priority may claim a node by evicting strictly-lower-priority pods.
PreemptLowerPriority = "PreemptLowerPriority"
PreemptNever = "Never"

# Priority values: user classes must stay below the system band, like the
# upstream HighestUserDefinablePriority / system-cluster-critical split.
HighestUserDefinablePriority = 1_000_000_000
DefaultPodPriority = 0

# Event source components
DefaultSchedulerName = "scheduler"

ResourceList = Dict[str, Quantity]  # resource name -> Quantity


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Volumes (ref: types.go:147-330; plugin impls pkg/volume/)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Containers & probes (ref: types.go:330-550)
# ---------------------------------------------------------------------------


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
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
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
    last_termination_state: ContainerState = field(default_factory=ContainerState)
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    image_id: str = ""
    container_id: str = ""


# ---------------------------------------------------------------------------
# Pod (ref: types.go:620-815)
# ---------------------------------------------------------------------------


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""


@dataclass
class PodSpec:
    """ref: types.go PodSpec (:695-720)."""

    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = RestartPolicyAlways
    termination_grace_period_seconds: Optional[int] = None
    dns_policy: str = DNSClusterFirst
    node_selector: Dict[str, str] = field(default_factory=dict)
    host: str = ""
    host_network: bool = False
    # kube-preempt: the resolved integer priority (admission fills it from
    # priority_class_name; None = unresolved, treated as 0) and the
    # effective preemption policy ("" inherits the class's, defaulting to
    # PreemptLowerPriority). The scheduler reads ONLY the resolved fields.
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


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


# ---------------------------------------------------------------------------
# ReplicationController (ref: types.go:816-880)
# ---------------------------------------------------------------------------


@dataclass
class ReplicationControllerSpec:
    replicas: int = 0
    selector: Dict[str, str] = field(default_factory=dict)
    template: Optional[PodTemplateSpec] = None


@dataclass
class ReplicationControllerStatus:
    replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicationControllerSpec = field(default_factory=ReplicationControllerSpec)
    status: ReplicationControllerStatus = field(default_factory=ReplicationControllerStatus)
    kind: str = "ReplicationController"


@dataclass
class ReplicationControllerList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[ReplicationController] = field(default_factory=list)
    kind: str = "ReplicationControllerList"


# ---------------------------------------------------------------------------
# Service & Endpoints (ref: types.go:881-952)
# ---------------------------------------------------------------------------


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


@dataclass
class Endpoint:
    ip: str = ""
    port: int = 0
    target_ref: Optional[ObjectReference] = None


@dataclass
class Endpoints:
    """ref: types.go Endpoints (:921). The reference stores "ip:port" strings;
    structured Endpoint records carry the same information plus a target ref."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    protocol: str = ProtocolTCP
    endpoints: List[Endpoint] = field(default_factory=list)
    kind: str = "Endpoints"


@dataclass
class EndpointsList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Endpoints] = field(default_factory=list)
    kind: str = "EndpointsList"


# ---------------------------------------------------------------------------
# Node (ref: types.go:953-1124; called "Minion" in the reference wire API)
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    """ref: types.go NodeSpec — capacity lives on the spec in this era and is
    what the scheduler reads (ref: pkg/scheduler/predicates.go:137)."""

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


# ---------------------------------------------------------------------------
# Namespace (ref: types.go:1125-1165)
# ---------------------------------------------------------------------------


@dataclass
class NamespaceSpec:
    finalizers: List[str] = field(default_factory=lambda: [FinalizerKubernetes])


@dataclass
class NamespaceStatus:
    phase: str = NamespaceActive


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NamespaceSpec = field(default_factory=NamespaceSpec)
    status: NamespaceStatus = field(default_factory=NamespaceStatus)
    kind: str = "Namespace"


@dataclass
class NamespaceList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Namespace] = field(default_factory=list)
    kind: str = "NamespaceList"


# ---------------------------------------------------------------------------
# PriorityClass (kube-preempt: the scheduling.k8s.io/v1 shape on the
# era-appropriate surface — cluster-scoped, int32 value, optional
# preemption policy, at most one globalDefault)
# ---------------------------------------------------------------------------


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    description: str = ""
    preemption_policy: str = PreemptLowerPriority
    kind: str = "PriorityClass"


@dataclass
class PriorityClassList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[PriorityClass] = field(default_factory=list)
    kind: str = "PriorityClassList"


# ---------------------------------------------------------------------------
# Binding (ref: types.go:1145-1155; write path pkg/registry/pod/etcd/etcd.go:98)
# ---------------------------------------------------------------------------


@dataclass
class Binding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_name: str = ""
    host: str = ""
    # kube-preempt: pods the server must evict (delete) atomically with
    # this bind — either every victim is deleted AND the pod binds, or the
    # item fails 409 and nothing is applied. Each ref names a pod in the
    # binding's namespace; uid guards against name reuse.
    victims: List[ObjectReference] = field(default_factory=list)
    # kube-defrag: when set, this is a MIGRATION bind — the pod is
    # expected to be bound to from_host already and is atomically moved
    # (evict-here + bind-there) to ``host``. pod_uid guards against the
    # pod being deleted/recreated between the descheduler's proposal and
    # the commit; any mismatch fails the item 409 with nothing applied.
    # The scheduler never sets these, so the hot bind path is untouched.
    from_host: str = ""
    pod_uid: str = ""
    kind: str = "Binding"


@dataclass
class BindingList:
    """A wave's bindings, committed in one transactional store pass — the
    batch extension SURVEY §7 hard part (e) calls for (10k binds landing in
    one wave must not pay 10k apiserver round-trips). Each item keeps the
    reference's per-pod CAS semantics; results come back positionally."""

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


# ---------------------------------------------------------------------------
# Status & options (ref: types.go:1167-1330)
# ---------------------------------------------------------------------------


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


@dataclass
class DeleteOptions:
    grace_period_seconds: Optional[int] = None
    kind: str = "DeleteOptions"


@dataclass
class ListOptions:
    label_selector: str = ""
    field_selector: str = ""
    watch: bool = False
    resource_version: str = ""


# ---------------------------------------------------------------------------
# Events (ref: types.go:1383-1420; recorder pkg/client/record/event.go)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Secrets, LimitRange, ResourceQuota (ref: types.go:1430-1623)
# ---------------------------------------------------------------------------


@dataclass
class Secret:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)  # base64-encoded values
    type: str = "Opaque"
    kind: str = "Secret"


@dataclass
class SecretList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[Secret] = field(default_factory=list)
    kind: str = "SecretList"


@dataclass
class LimitRangeItem:
    type: str = ""  # "Pod" or "Container"
    max: ResourceList = field(default_factory=dict)
    min: ResourceList = field(default_factory=dict)
    default: ResourceList = field(default_factory=dict)


@dataclass
class LimitRangeSpec:
    limits: List[LimitRangeItem] = field(default_factory=list)


@dataclass
class LimitRange:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)
    kind: str = "LimitRange"


@dataclass
class LimitRangeList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[LimitRange] = field(default_factory=list)
    kind: str = "LimitRangeList"


@dataclass
class ResourceQuotaSpec:
    hard: ResourceList = field(default_factory=dict)


@dataclass
class ResourceQuotaStatus:
    hard: ResourceList = field(default_factory=dict)
    used: ResourceList = field(default_factory=dict)


@dataclass
class ResourceQuota:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)
    kind: str = "ResourceQuota"


@dataclass
class ResourceQuotaList:
    metadata: ListMeta = field(default_factory=ListMeta)
    items: List[ResourceQuota] = field(default_factory=list)
    kind: str = "ResourceQuotaList"


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

LIST_KINDS = {
    "PodList": PodList,
    "ReplicationControllerList": ReplicationControllerList,
    "ServiceList": ServiceList,
    "EndpointsList": EndpointsList,
    "NodeList": NodeList,
    "NamespaceList": NamespaceList,
    "EventList": EventList,
    "SecretList": SecretList,
    "LimitRangeList": LimitRangeList,
    "ResourceQuotaList": ResourceQuotaList,
    "PriorityClassList": PriorityClassList,
}


def pod_priority(pod: Pod) -> int:
    """The scheduler-effective priority of a pod: the admission-resolved
    spec.priority, 0 (DefaultPodPriority) when unresolved."""
    p = pod.spec.priority
    return DefaultPodPriority if p is None else int(p)


def pod_can_preempt(pod: Pod) -> bool:
    """Whether this pod may claim a node by evicting lower-priority pods:
    the resolved spec.preemption_policy, defaulting to
    PreemptLowerPriority exactly like the upstream API."""
    return pod.spec.preemption_policy != PreemptNever


def is_pod_active(pod: Pod) -> bool:
    """ref: pkg/controller/replication_controller.go FilterActivePods (:182)."""
    return pod.status.phase not in (PodSucceeded, PodFailed)


def pod_requests(pod: Pod) -> Dict[str, int]:
    """Sum container resource requests; cpu in millicores, memory in bytes.

    Mirrors the capacity math in ref: pkg/scheduler/predicates.go:86-101
    (getResourceRequest): limits in this era double as requests.
    """
    cpu = 0
    mem = 0
    for c in pod.spec.containers:
        req = c.resources.requests or c.resources.limits
        q = req.get(ResourceCPU)
        if q is not None:
            cpu += q.milli_value()
        q = req.get(ResourceMemory)
        if q is not None:
            mem += q.int_value()
    return {ResourceCPU: cpu, ResourceMemory: mem}
