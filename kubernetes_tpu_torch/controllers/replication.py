"""Replication manager (ref: pkg/controller/replication_controller.go).

Port of ``kubernetes_tpu/controllers/replication.py``.

Watches ReplicationControllers (plus a periodic full resync) and reconciles
the set of active pods matching each RC's selector against spec.replicas:
create the shortfall / delete the surplus in parallel, then write back
status.replicas (ref: syncReplicationController :193-234).

``PodControlInterface`` (:48-53) is the create/delete seam the tests mock.
"""

from __future__ import annotations

import copy
import datetime
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["ReplicationManager", "PodControl"]

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


class PodControl:
    """ref: RealPodControl (:56-101) — creates/deletes pods via the client."""

    def __init__(self, client):
        self.client = client

    def create_replica(self, namespace: str, rc: api.ReplicationController) -> None:
        """ref: createReplica (:63-89) — pod stamped from the RC template."""
        tmpl = rc.spec.template
        pod = api.Pod(
            metadata=api.ObjectMeta(
                namespace=namespace,
                generate_name=f"{rc.metadata.name}-",
                labels=dict(tmpl.metadata.labels),
                annotations=dict(tmpl.metadata.annotations),
            ),
            spec=copy.deepcopy(tmpl.spec),
        )
        if not pod.metadata.labels:
            raise ValueError(
                f"unable to create pod replica, no labels on template {rc.metadata.name}")
        self.client.pods(namespace).create(pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        self.client.pods(namespace).delete(name)


class ReplicationManager:
    """ref: ReplicationManager (:34-46) + Run/watchControllers/synchronize."""

    def __init__(self, client, pod_control: Optional[PodControl] = None,
                 burst_replicas: int = 64):
        self.client = client
        self.pod_control = pod_control or PodControl(client)
        self.burst_replicas = burst_replicas
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- the core sync (ref: syncReplicationController :193-234) -----------
    def sync(self, rc: api.ReplicationController) -> int:
        """Reconcile one RC; returns the post-sync active-pod count."""
        ns = rc.metadata.namespace or api.NamespaceDefault
        selector = labels_pkg.selector_from_set(rc.spec.selector)
        pod_list = self.client.pods(ns).list(label_selector=str(selector))
        active = [p for p in pod_list.items if api.is_pod_active(p)]
        diff = len(active) - rc.spec.replicas

        if diff < 0:
            # scale up: parallel creates (ref: :204-215 wait.Group of createReplica)
            want = min(-diff, self.burst_replicas)
            with ThreadPoolExecutor(max_workers=min(want, 16)) as ex:
                list(ex.map(lambda _: self.pod_control.create_replica(ns, rc),
                            range(want)))
            count = len(active) + want
        elif diff > 0:
            # scale down: prefer unassigned pods, then newest — deterministic
            # under test (the reference deletes an arbitrary prefix, :216-225)
            want = min(diff, self.burst_replicas)
            active.sort(key=lambda p: (p.metadata.creation_timestamp or _EPOCH,
                                       p.metadata.name), reverse=True)
            active.sort(key=lambda p: bool(p.spec.host))  # stable: unbound first
            victims = active[:want]
            with ThreadPoolExecutor(max_workers=min(want, 16)) as ex:
                list(ex.map(lambda p: self.pod_control.delete_pod(
                    ns, p.metadata.name), victims))
            count = len(active) - want
        else:
            count = len(active)

        # write back observed count (ref: :226-233)
        if rc.status.replicas != count:
            fresh = self.client.replication_controllers(ns).get(rc.metadata.name)
            fresh.status.replicas = count
            self.client.replication_controllers(ns).update(fresh)
        return count

    def synchronize(self) -> None:
        """Full resync of every RC (ref: synchronize :236-255)."""
        rcs = self.client.replication_controllers(api.NamespaceAll).list()
        if not rcs.items:
            return
        with ThreadPoolExecutor(max_workers=min(len(rcs.items), 16)) as ex:
            list(ex.map(self._safe_sync, rcs.items))

    def _safe_sync(self, rc):
        try:
            self.sync(rc)
        except Exception:
            pass  # crash-only: the next resync retries (ref: util.HandleCrash)

    # -- the loop (ref: Run :116-120 + watchControllers :123-179) -----------
    def run(self, period: float = 5.0) -> "ReplicationManager":
        t = threading.Thread(target=self._watch_loop, daemon=True, name="rc-watch")
        t.start()
        self._threads.append(t)
        # initial synchronize covers RCs that predate the watch (from-now)
        self._threads.append(
            run_periodic(self.synchronize, period, "rc-resync", self._stop))
        return self

    def stop(self) -> None:
        self._stop.set()

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                w = self.client.replication_controllers(api.NamespaceAll).watch()
            except Exception:
                time.sleep(0.1)
                continue
            try:
                while not self._stop.is_set():
                    try:
                        ev = w.next_event(timeout=0.2)
                    except queue.Empty:
                        continue
                    if ev is None or ev.type == watchpkg.ERROR:
                        break  # channel closed: re-watch (ref: :139-152)
                    if ev.type in (watchpkg.ADDED, watchpkg.MODIFIED) and \
                            isinstance(ev.object, api.ReplicationController):
                        self._safe_sync(ev.object)
            except Exception:
                pass
            finally:
                w.stop()
