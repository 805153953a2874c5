"""Control loops (ref: pkg/controller/, pkg/service/, pkg/namespace/,
pkg/resourcequota/, pkg/cloudprovider/controller/).

Port of ``kubernetes_tpu/controllers/__init__.py``.

Every controller is a level-triggered reconciliation loop over the shared
watchable store, talking only through the typed client — the reference's core
architectural invariant (DESIGN.md:40).
"""

from kubernetes_tpu_torch.controllers.replication import ReplicationManager, PodControl
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.node import NodeController
from kubernetes_tpu_torch.controllers.namespace import NamespaceController
from kubernetes_tpu_torch.controllers.resourcequota import ResourceQuotaController
from kubernetes_tpu_torch.controllers.manager import ControllerManager

__all__ = [
    "ReplicationManager", "PodControl", "EndpointsController",
    "NodeController", "NamespaceController", "ResourceQuotaController",
    "ControllerManager",
]
