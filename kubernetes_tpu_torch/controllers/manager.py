"""Controller manager — hosts every control loop in one process
(ref: cmd/kube-controller-manager/app/controllermanager.go:138-187).

Port of ``kubernetes_tpu/controllers/manager.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.namespace import NamespaceController
from kubernetes_tpu_torch.controllers.node import NodeController
from kubernetes_tpu_torch.controllers.replication import ReplicationManager
from kubernetes_tpu_torch.controllers.resourcequota import ResourceQuotaController

__all__ = ["ControllerManager", "ControllerManagerConfig"]


@dataclass
class ControllerManagerConfig:
    """Flag surface of the reference binary (subset that matters here)."""

    rc_sync_period: float = 5.0
    endpoints_sync_period: float = 5.0
    node_sync_period: float = 5.0
    namespace_sync_period: float = 2.0
    quota_sync_period: float = 10.0
    pod_eviction_timeout: float = 30.0
    static_nodes: List[api.Node] = field(default_factory=list)
    node_prober: Optional[Callable[[api.Node], bool]] = None
    cloud: object = None            # cloudprovider.Interface
    match_re: str = ".*"            # cloud instance filter (ref: --minion_regexp)


class ControllerManager:
    def __init__(self, client, config: Optional[ControllerManagerConfig] = None):
        self.config = config or ControllerManagerConfig()
        c = self.config
        self.replication = ReplicationManager(client)
        self.endpoints = EndpointsController(client)
        self.nodes = NodeController(
            client, static_nodes=c.static_nodes, node_prober=c.node_prober,
            pod_eviction_timeout=c.pod_eviction_timeout,
            cloud=c.cloud, match_re=c.match_re)
        self.namespaces = NamespaceController(client)
        self.quotas = ResourceQuotaController(client)

    def run(self) -> "ControllerManager":
        c = self.config
        self.replication.run(c.rc_sync_period)
        self.endpoints.run(c.endpoints_sync_period)
        self.nodes.run(c.node_sync_period)
        self.namespaces.run(c.namespace_sync_period)
        self.quotas.run(c.quota_sync_period)
        return self

    def stop(self) -> None:
        for ctl in (self.replication, self.endpoints, self.nodes,
                    self.namespaces, self.quotas):
            ctl.stop()
