"""Per-pod sync workers (ref: pkg/kubelet/pod_workers.go).

One worker thread per pod UID; updates arriving while a sync is in flight
are coalesced to the latest (ref: podWorkers:34-58 — a buffered channel of
size 1 per pod; managePodLoop:83-112 drains to the freshest update).

Port of ``kubernetes_tpu/kubelet/pod_workers.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["PodWorkers"]


class _Worker:
    def __init__(self, sync_fn: Callable[[api.Pod], None], name: str):
        self.sync_fn = sync_fn
        self._cond = threading.Condition()
        self._pending: Optional[api.Pod] = None
        self._closed = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    def update(self, pod: api.Pod) -> None:
        with self._cond:
            self._pending = pod  # coalesce: latest wins
            self._idle.clear()   # busy from the caller's perspective now
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._idle.set()
                    self._cond.wait()
                if self._closed and self._pending is None:
                    self._idle.set()
                    return
                pod, self._pending = self._pending, None
                self._idle.clear()
            try:
                self.sync_fn(pod)
            except Exception:
                pass  # crash-only (ref: util.HandleCrash in managePodLoop)

    def wait_idle(self, timeout: float) -> bool:
        return self._idle.wait(timeout)


class PodWorkers:
    """ref: podWorkers — UpdatePod dispatches to the pod's worker,
    ForgetNonExistingPodWorkers reaps workers for deleted pods."""

    def __init__(self, sync_fn: Callable[[api.Pod], None]):
        self.sync_fn = sync_fn
        self._lock = threading.Lock()
        self._workers: Dict[str, _Worker] = {}

    def update_pod(self, pod: api.Pod) -> None:
        uid = pod.metadata.uid or pod.metadata.name
        with self._lock:
            w = self._workers.get(uid)
            if w is None:
                w = _Worker(self.sync_fn, name=f"pod-worker-{pod.metadata.name}")
                self._workers[uid] = w
        w.update(pod)

    def forget_non_existing(self, live_uids: set) -> None:
        with self._lock:
            dead = [uid for uid in self._workers if uid not in live_uids]
            for uid in dead:
                self._workers.pop(uid).close()

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Block until every worker has drained (test/integration helper)."""
        with self._lock:
            workers = list(self._workers.values())
        ok = True
        for w in workers:
            ok = w.wait_idle(timeout) and ok
        return ok

    def stop(self) -> None:
        with self._lock:
            for w in self._workers.values():
                w.close()
            self._workers.clear()
