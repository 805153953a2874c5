"""Status manager (ref: pkg/kubelet/status_manager.go).

Deduplicates and pushes PodStatus to the API server: SetPodStatus records
the computed status and syncs it only when it differs from the last pushed
version, so a steady-state node generates no API writes.

Port of ``kubernetes_tpu/kubelet/status.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["StatusManager"]


def _status_equal(a: api.PodStatus, b: api.PodStatus) -> bool:
    return a == b  # dataclass equality covers nested container statuses


class StatusManager:
    def __init__(self, client):
        self.client = client
        self._lock = threading.Lock()
        self._statuses: Dict[str, api.PodStatus] = {}  # pod key -> last pushed

    def set_pod_status(self, pod: api.Pod, status: api.PodStatus) -> None:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._lock:
            old = self._statuses.get(key)
            if old is not None and _status_equal(old, status):
                return
            self._statuses[key] = status
        if self.client is None:
            return
        try:
            fresh = api.Pod(metadata=pod.metadata, spec=pod.spec, status=status)
            self.client.pods(pod.metadata.namespace).update_status(fresh)
        except Exception:
            # drop the cache entry so the next sync retries the push
            with self._lock:
                self._statuses.pop(key, None)

    def get_pod_status(self, pod: api.Pod) -> Optional[api.PodStatus]:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._lock:
            return self._statuses.get(key)

    def delete_pod_status(self, pod_key: str) -> None:
        with self._lock:
            self._statuses.pop(pod_key, None)
