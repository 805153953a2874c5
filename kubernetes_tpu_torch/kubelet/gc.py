"""Container & image garbage collection
(ref: pkg/kubelet/container_gc.go + image_manager.go).

``ContainerGC`` evicts dead containers by the reference's realContainerGC
policy: keep at most ``max_per_pod_container`` dead instances per
(pod, container) pair, never remove containers younger than ``min_age``,
and cap total dead containers at ``max_containers`` (oldest evicted first).

``ImageManager`` deletes unused images when the disk-usage callable reports
utilization above ``high_threshold_percent``, oldest-unused first, until
below ``low_threshold_percent`` (ref: image_manager.go GarbageCollect).

Port of ``kubernetes_tpu/kubelet/gc.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime

__all__ = ["GCPolicy", "ContainerGC", "ImageGCPolicy", "ImageManager"]


@dataclass
class GCPolicy:
    """ref: ContainerGCPolicy (container_gc.go:28-38)."""

    min_age: float = 0.0
    max_per_pod_container: int = 2
    max_containers: int = 100


class ContainerGC:
    def __init__(self, runtime: ContainerRuntime, policy: GCPolicy):
        self.runtime = runtime
        self.policy = policy

    def collect(self, live_uids: Optional[set] = None) -> int:
        """Returns the number of containers removed."""
        now = time.time()
        dead = [r for r in self.runtime.list_containers(include_dead=True)
                if not r.running and r.parsed is not None
                and now - (r.finished_at or r.created_at) >= self.policy.min_age]
        removed = 0
        # group dead containers by (pod uid, container name); newest kept
        groups: Dict[tuple, List] = {}
        for r in dead:
            p = r.parsed
            groups.setdefault((p[3], p[0]), []).append(r)
        survivors = []
        for (uid, cname), records in groups.items():
            records.sort(key=lambda r: r.finished_at or r.created_at, reverse=True)
            keep = self.policy.max_per_pod_container
            if live_uids is not None and uid not in live_uids:
                keep = 0  # pod is gone: its corpses hold no restart history
            for r in records[keep:]:
                self.runtime.remove_container(r.id)
                removed += 1
            survivors.extend(records[:keep])
        # global cap, oldest first (ref: enforceMaxContainers)
        if len(survivors) > self.policy.max_containers:
            survivors.sort(key=lambda r: r.finished_at or r.created_at)
            excess = len(survivors) - self.policy.max_containers
            for r in survivors[:excess]:
                self.runtime.remove_container(r.id)
                removed += 1
        return removed


@dataclass
class ImageGCPolicy:
    """ref: ImageGCPolicy (image_manager.go:28-40)."""

    high_threshold_percent: int = 90
    low_threshold_percent: int = 80


class ImageManager:
    """``disk_usage_percent`` is the cadvisor seam: a callable returning the
    image filesystem utilization (ref: image_manager.go uses cadvisor's
    DockerImagesFsInfo)."""

    def __init__(self, runtime: ContainerRuntime, policy: ImageGCPolicy,
                 disk_usage_percent: Callable[[], float],
                 image_size: Callable[[str], int] = lambda image: 1):
        self.runtime = runtime
        self.policy = policy
        self.disk_usage_percent = disk_usage_percent
        self.image_size = image_size

    def images_in_use(self) -> set:
        used = set()
        for r in self.runtime.list_containers(include_dead=True):
            used.add(r.image)
        return used

    def garbage_collect(self) -> List[str]:
        """Returns the images removed."""
        usage = self.disk_usage_percent()
        if usage < self.policy.high_threshold_percent:
            return []
        used = self.images_in_use()
        candidates = [i for i in self.runtime.list_images() if i not in used]
        removed = []
        for image in candidates:
            if self.disk_usage_percent() <= self.policy.low_threshold_percent:
                break
            self.runtime.remove_image(image)
            removed.append(image)
        return removed
