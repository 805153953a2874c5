"""Service discovery environment variables.

ref: pkg/kubelet/envvars/envvars.go FromServices — every container is
started with `{SVC}_SERVICE_HOST` / `{SVC}_SERVICE_PORT` for each
service visible to its pod, plus the docker-links-compatible
`{SVC}_PORT*` family, so applications written against either convention
find their backends without DNS. The kubelet composes the visible set
per namespace (kubelet.go:857-893 getServiceEnvVarMap): the pod's own
namespace wins; the master services ("kubernetes", "kubernetes-ro")
from the master namespace are added when not shadowed.

Port of ``kubernetes_tpu/kubelet/envvars.py``.
"""

from __future__ import annotations

from typing import Dict, List

from kubernetes_tpu_torch.api import types as api

# ref: cmd/kubelet masterServiceNamespace default + kubelet.go:846
MASTER_SERVICES = ("kubernetes", "kubernetes-ro")


def _var_name(service_name: str) -> str:
    # ref: envvars.go makeEnvVariableName
    return service_name.upper().replace("-", "_")


def from_services(services: List[api.Service]) -> List[api.EnvVar]:
    """ref: envvars.go FromServices — skips services without a portal IP
    (they have nothing routable to advertise)."""
    out: List[api.EnvVar] = []
    for svc in services:
        portal_ip = svc.spec.portal_ip
        if not portal_ip or portal_ip == "None":
            continue
        prefix = _var_name(svc.metadata.name)
        port = svc.spec.port
        proto = (svc.spec.protocol or api.ProtocolTCP).lower()
        url = f"{proto}://{portal_ip}:{port}"
        port_prefix = f"{prefix}_PORT_{port}_{proto.upper()}"
        out.extend([
            api.EnvVar(name=f"{prefix}_SERVICE_HOST", value=portal_ip),
            api.EnvVar(name=f"{prefix}_SERVICE_PORT", value=str(port)),
            # docker-compatible link variables (envvars.go makeLinkVariables)
            api.EnvVar(name=f"{prefix}_PORT", value=url),
            api.EnvVar(name=port_prefix, value=url),
            api.EnvVar(name=f"{port_prefix}_PROTO", value=proto),
            api.EnvVar(name=f"{port_prefix}_PORT", value=str(port)),
            api.EnvVar(name=f"{port_prefix}_ADDR", value=portal_ip),
        ])
    return out


def visible_services(all_services: List[api.Service], namespace: str,
                     master_ns: str = "default") -> List[api.Service]:
    """The services a pod in `namespace` should see (ref:
    kubelet.go:857-893): every service in its own namespace, plus the
    master services from master_ns unless shadowed by a same-named
    local service."""
    by_name: Dict[str, api.Service] = {}
    for svc in all_services:
        ns = svc.metadata.namespace
        name = svc.metadata.name
        if ns == namespace:
            by_name[name] = svc
        elif ns == master_ns and name in MASTER_SERVICES:
            by_name.setdefault(name, svc)
    return list(by_name.values())
