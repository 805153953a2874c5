"""Node agent (ref: pkg/kubelet/).

The kubelet-equivalent: consumes desired pod state from merged config
sources (file / apiserver watch), reconciles the node's container runtime to
match via per-pod workers, probes container health, and pushes PodStatus
back to the API server.

The container runtime sits behind the ``ContainerRuntime`` seam
(ref: dockertools.DockerInterface); ``FakeRuntime`` is the test double
(ref: FakeDockerClient) and ``ProcessRuntime`` runs pods as real local
process groups with the native pause binary as each pod's sandbox.

Port of ``kubernetes_tpu/kubelet/__init__.py``.
"""

from kubernetes_tpu_torch.kubelet.runtime import (
    ContainerRecord,
    ContainerRuntime,
    FakeRuntime,
    INFRA_CONTAINER_NAME,
)
from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet
from kubernetes_tpu_torch.kubelet.config import PodConfig, ApiserverSource, FileSource
from kubernetes_tpu_torch.kubelet.pod_workers import PodWorkers
from kubernetes_tpu_torch.kubelet.status import StatusManager

__all__ = [
    "ContainerRecord", "ContainerRuntime", "FakeRuntime", "ProcessRuntime",
    "INFRA_CONTAINER_NAME", "Kubelet", "PodConfig", "ApiserverSource",
    "FileSource", "PodWorkers", "StatusManager",
]
