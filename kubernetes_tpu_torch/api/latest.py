"""Default scheme wiring — the v1 wire kinds and their decode defaults.

Port of ``kubernetes_tpu/api/latest.py`` (ref: pkg/api/latest/latest.go)
registering every kind the apiserver's registries serve, and the era
defaults v1 applies on decode (ref: v1beta3/defaults.go; the reference
registers them from ``api/v1beta1.py``'s DEFAULTERS). v1 needs no
field-label conversion: its labels are the internal ones. The legacy
``v1beta1``/``v1beta2`` wire, which serves old clients of the apiserver,
is not ported (ROADMAP Queue 1 item 13): ``require_version`` refuses any
version but v1, and the apiserver serves v1 alone.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.runtime.scheme import Scheme

__all__ = ["scheme", "VERSIONS", "LATEST_VERSION", "new_scheme",
           "require_version"]

LATEST_VERSION = "v1"
VERSIONS = (LATEST_VERSION,)

_ALL_KINDS = (
    api.Pod, api.PodList,
    api.ReplicationController, api.ReplicationControllerList,
    api.Service, api.ServiceList,
    api.Endpoints, api.EndpointsList,
    api.Node, api.NodeList,
    api.Namespace, api.NamespaceList,
    api.Binding, api.BindingList, api.BindingResultList,
    api.Event, api.EventList,
    api.Secret, api.SecretList,
    api.LimitRange, api.LimitRangeList,
    api.ResourceQuota, api.ResourceQuotaList,
    api.PriorityClass, api.PriorityClassList,
    api.Status,
    api.DeleteOptions,
)


def require_version(version: str) -> str:
    """The wire version a client may speak: v1 only."""
    if version and version != LATEST_VERSION:
        raise NotImplementedError(
            f"API version {version!r}: the legacy v1beta1/v1beta2 wire is "
            f"not ported yet (ROADMAP Queue 1 item 13); "
            f"the port speaks {LATEST_VERSION}")
    return LATEST_VERSION


def _default_pod(pod: api.Pod) -> None:
    if not pod.spec.restart_policy:
        pod.spec.restart_policy = api.RestartPolicyAlways
    if not pod.spec.dns_policy:
        pod.spec.dns_policy = api.DNSClusterFirst
    for c in pod.spec.containers:
        for p in c.ports:
            if not p.protocol:
                p.protocol = api.ProtocolTCP
            # with host networking, unset host ports default to the
            # container port (ref: v1beta1/defaults.go:112-121)
            if pod.spec.host_network and not p.host_port:
                p.host_port = p.container_port


def _default_service(svc: api.Service) -> None:
    if not svc.spec.protocol:
        svc.spec.protocol = api.ProtocolTCP
    if not svc.spec.session_affinity:
        svc.spec.session_affinity = api.AffinityNone


def _default_endpoints(eps: api.Endpoints) -> None:
    if not eps.protocol:
        eps.protocol = api.ProtocolTCP


def new_scheme() -> Scheme:
    s = Scheme(default_version=LATEST_VERSION)
    s.add_known_types(LATEST_VERSION, *_ALL_KINDS)
    s.add_defaulter(LATEST_VERSION, "Pod", _default_pod)
    s.add_defaulter(LATEST_VERSION, "Service", _default_service)
    s.add_defaulter(LATEST_VERSION, "Endpoints", _default_endpoints)
    return s


# The shared default scheme (ref: api.Scheme package variable).
scheme = new_scheme()
