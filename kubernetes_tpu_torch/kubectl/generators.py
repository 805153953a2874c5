"""Object generators for imperative commands.

Port of ``kubernetes_tpu/kubectl/generators.py``.

ref: pkg/kubectl/run.go (BasicReplicationController generator used by
``kubectl run``) and pkg/kubectl/service.go (service generator used by
``kubectl expose``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["generate_rc", "generate_service"]


def parse_labels(spec: str) -> Dict[str, str]:
    """"a=b,c=d" -> dict (ref: kubectl.go ParseLabels)."""
    out: Dict[str, str] = {}
    if not spec:
        return out
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"invalid label {part!r}: expected key=value")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def generate_rc(name: str, image: str, replicas: int = 1,
                labels: Optional[Dict[str, str]] = None,
                port: int = 0) -> api.ReplicationController:
    """ref: run.go BasicReplicationController.Generate — labels default to
    {"run": name} so the selector always matches the template."""
    labels = dict(labels) if labels else {"run": name}
    container = api.Container(name=name, image=image)
    if port > 0:
        container.ports = [api.ContainerPort(container_port=port)]
    return api.ReplicationController(
        metadata=api.ObjectMeta(name=name, labels=dict(labels)),
        spec=api.ReplicationControllerSpec(
            replicas=replicas,
            selector=dict(labels),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels=dict(labels)),
                spec=api.PodSpec(containers=[container]))))


def generate_service(name: str, selector: Dict[str, str], port: int,
                     container_port: int = 0, protocol: str = api.ProtocolTCP,
                     labels: Optional[Dict[str, str]] = None,
                     create_external_load_balancer: bool = False,
                     public_ips: Optional[List[str]] = None) -> api.Service:
    """ref: service.go ServiceGenerator.Generate."""
    if not selector:
        raise ValueError("a selector is required to expose a service")
    if port <= 0:
        raise ValueError("a positive --port is required")
    return api.Service(
        metadata=api.ObjectMeta(name=name, labels=dict(labels or {})),
        spec=api.ServiceSpec(
            port=port,
            protocol=protocol,
            selector=dict(selector),
            container_port=container_port or port,
            create_external_load_balancer=create_external_load_balancer,
            public_ips=list(public_ips or [])))
