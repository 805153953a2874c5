"""Container runtime seam (ref: pkg/kubelet/dockertools/).

``ContainerRuntime`` is the interface the kubelet drives
(ref: dockertools.DockerInterface — ListContainers/CreateContainer/
StartContainer/StopContainer/InspectContainer/PullImage). ``FakeRuntime``
is the in-memory double (ref: FakeDockerClient,
pkg/kubelet/dockertools/fake_docker_client.go) that also serves as the
"machine" in the multi-node integration harness: it allocates pod IPs and
tracks container lifecycles, and its ``call_log`` records every operation
for assertions.

Containers are named by the reference's convention
``k8s_<container>_<podname>_<namespace>_<uid>_<rand>``
(ref: dockertools/docker.go BuildDockerName/ParseDockerName) so that pod
membership is recoverable from the runtime alone after a kubelet restart.

Port of ``kubernetes_tpu/kubelet/runtime.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as api

__all__ = ["ContainerRecord", "ContainerRuntime", "FakeRuntime",
           "INFRA_CONTAINER_NAME", "INFRA_IMAGE", "build_container_name",
           "parse_container_name", "pod_full_name"]

# ref: kubelet.go:1020-1030 — the infra ("pause") container that holds the
# pod sandbox. networkContainerName = "POD"; our native equivalent binary
# lives in native/pause.cc.
INFRA_CONTAINER_NAME = "POD"
INFRA_IMAGE = "kubernetes/pause:latest"

_PREFIX = "k8s"


def pod_full_name(pod: api.Pod) -> str:
    """<name>_<namespace> (ref: GetPodFullName, kubelet.go:214)."""
    return f"{pod.metadata.name}_{pod.metadata.namespace or api.NamespaceDefault}"


def build_container_name(pod: api.Pod, container_name: str, attempt: int) -> str:
    """ref: BuildDockerName — rand suffix doubles as the restart counter."""
    return "_".join([_PREFIX, container_name, pod.metadata.name,
                     pod.metadata.namespace or api.NamespaceDefault,
                     pod.metadata.uid, str(attempt)])


def parse_container_name(name: str) -> Optional[Tuple[str, str, str, str, int]]:
    """-> (container_name, pod_name, namespace, pod_uid, attempt) or None."""
    parts = name.split("_")
    if len(parts) != 6 or parts[0] != _PREFIX:
        return None
    try:
        attempt = int(parts[5])
    except ValueError:
        return None
    return parts[1], parts[2], parts[3], parts[4], attempt


@dataclass
class ContainerRecord:
    """What the runtime knows about one container (ref: docker.APIContainers
    + InspectContainer fields the kubelet reads)."""

    id: str = ""
    name: str = ""              # encoded k8s_... name
    image: str = ""
    running: bool = False
    exit_code: int = 0
    created_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    ip: str = ""                # infra containers carry the pod IP

    @property
    def parsed(self):
        return parse_container_name(self.name)


class ContainerRuntime:
    """The kubelet-facing interface; implementations must be thread-safe."""

    def list_containers(self, include_dead: bool = False) -> List[ContainerRecord]:
        raise NotImplementedError

    def create_container(self, pod: api.Pod, container: api.Container,
                         attempt: int) -> str:
        raise NotImplementedError

    def create_infra_container(self, pod: api.Pod) -> str:
        raise NotImplementedError

    def start_container(self, container_id: str) -> None:
        raise NotImplementedError

    def stop_container(self, container_id: str) -> None:
        raise NotImplementedError

    def remove_container(self, container_id: str) -> None:
        raise NotImplementedError

    def inspect_container(self, container_id: str) -> Optional[ContainerRecord]:
        raise NotImplementedError

    def pull_image(self, image: str) -> None:
        raise NotImplementedError

    def list_images(self) -> List[str]:
        raise NotImplementedError

    def remove_image(self, image: str) -> None:
        raise NotImplementedError

    def exec_in_container(self, container_id: str, cmd: List[str]) -> Tuple[int, str]:
        raise NotImplementedError

    def exec_stream_in_container(self, container_id: str, cmd: List[str]):
        """Yield output chunks (bytes) as the command produces them, then
        the final exit code (int) as the last item — the streaming seam the
        WebSocket exec upgrade serves. Default: wrap the blocking exec
        (one chunk); ProcessRuntime streams live."""
        code, output = self.exec_in_container(container_id, cmd)
        if output:
            yield output.encode("utf-8", "replace")
        yield code

    def container_logs(self, container_id: str, tail: int = 0) -> str:
        """ref: dockertools GetKubeletDockerContainerLogs."""
        raise NotImplementedError


class FakeRuntime(ContainerRuntime):
    """In-memory runtime double (ref: FakeDockerClient).

    - ``call_log`` records (op, detail) tuples, like FakeDockerClient.called.
    - ``errors[op]`` injects an exception for the next call of that op
      (ref: FakeDockerClient.Errors map).
    - ``exec_results[(container_name, tuple(cmd))]`` scripts exec probes.
    - pod IPs are allocated from ``ip_base`` per infra container.
    """

    def __init__(self, ip_base: str = "10.88.0."):
        self._lock = threading.RLock()
        self._containers: Dict[str, ContainerRecord] = {}
        self._images: set = set()
        self._id_counter = itertools.count(1)
        self._ip_counter = itertools.count(1)
        self.ip_base = ip_base
        self.call_log: List[tuple] = []
        self.errors: Dict[str, Exception] = {}
        self.exec_results: Dict[tuple, Tuple[int, str]] = {}
        self.logs: Dict[str, str] = {}  # container id -> accumulated output

    # -- helpers ------------------------------------------------------------
    def _called(self, op: str, detail: str = "") -> None:
        self.call_log.append((op, detail))
        err = self.errors.pop(op, None)
        if err is not None:
            raise err

    def containers_for_pod(self, pod_uid: str,
                           include_dead: bool = False) -> List[ContainerRecord]:
        with self._lock:
            out = []
            for c in self._containers.values():
                p = c.parsed
                if p and p[3] == pod_uid and (include_dead or c.running):
                    out.append(c)
            return out

    # -- ContainerRuntime ----------------------------------------------------
    def list_containers(self, include_dead: bool = False) -> List[ContainerRecord]:
        with self._lock:
            self._called("list")
            return [ContainerRecord(**vars(c)) for c in self._containers.values()
                    if include_dead or c.running]

    def create_container(self, pod: api.Pod, container: api.Container,
                         attempt: int) -> str:
        with self._lock:
            self._called("create", container.name)
            if container.image not in self._images:
                raise RuntimeError(f"image not present: {container.image}")
            cid = f"c{next(self._id_counter)}"
            self._containers[cid] = ContainerRecord(
                id=cid, name=build_container_name(pod, container.name, attempt),
                image=container.image, created_at=time.time())
            return cid

    def create_infra_container(self, pod: api.Pod) -> str:
        with self._lock:
            self._called("create_infra", pod_full_name(pod))
            cid = f"c{next(self._id_counter)}"
            self._containers[cid] = ContainerRecord(
                id=cid, name=build_container_name(pod, INFRA_CONTAINER_NAME, 0),
                image=INFRA_IMAGE, created_at=time.time(),
                ip=f"{self.ip_base}{next(self._ip_counter)}")
            return cid

    def start_container(self, container_id: str) -> None:
        with self._lock:
            self._called("start", container_id)
            c = self._containers[container_id]
            c.running = True
            c.started_at = time.time()

    def stop_container(self, container_id: str) -> None:
        with self._lock:
            self._called("stop", container_id)
            c = self._containers.get(container_id)
            if c is not None and c.running:
                c.running = False
                c.finished_at = time.time()

    def remove_container(self, container_id: str) -> None:
        with self._lock:
            self._called("remove", container_id)
            self._containers.pop(container_id, None)

    def inspect_container(self, container_id: str) -> Optional[ContainerRecord]:
        with self._lock:
            c = self._containers.get(container_id)
            return ContainerRecord(**vars(c)) if c else None

    def pull_image(self, image: str) -> None:
        with self._lock:
            self._called("pull", image)
            self._images.add(image)

    def list_images(self) -> List[str]:
        with self._lock:
            return sorted(self._images)

    def remove_image(self, image: str) -> None:
        with self._lock:
            self._called("remove_image", image)
            self._images.discard(image)

    def exec_in_container(self, container_id: str, cmd: List[str]) -> Tuple[int, str]:
        with self._lock:
            self._called("exec", container_id)
            c = self._containers.get(container_id)
            if c is None or not c.running:
                return 1, "container not running"
            p = c.parsed
            key = (p[0] if p else c.name, tuple(cmd))
            return self.exec_results.get(key, (0, ""))

    def container_logs(self, container_id: str, tail: int = 0) -> str:
        with self._lock:
            self._called("logs", container_id)
            text = self.logs.get(container_id, "")
            if tail > 0:
                lines = text.splitlines(keepends=True)
                text = "".join(lines[-tail:])
            return text

    def append_log(self, container_id: str, text: str) -> None:
        """Test convenience: accumulate synthetic container output."""
        with self._lock:
            self.logs[container_id] = self.logs.get(container_id, "") + text

    # -- test conveniences ---------------------------------------------------
    def kill_container_of(self, pod_uid: str, container_name: str,
                          exit_code: int = 137) -> bool:
        """Simulate a container dying out from under the kubelet."""
        with self._lock:
            for c in self._containers.values():
                p = c.parsed
                if p and p[3] == pod_uid and p[0] == container_name and c.running:
                    c.running = False
                    c.exit_code = exit_code
                    c.finished_at = time.time()
                    return True
            return False
