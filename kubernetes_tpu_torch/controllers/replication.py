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
import http.client
import queue
import random
import string
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import labels as labels_pkg
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["ReplicationManager", "PodControl"]

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


class PodControl:
    """ref: RealPodControl (:56-101) — creates/deletes pods via the client."""

    def __init__(self, client):
        self.client = client

    def create_replica(self, namespace: str, rc: api.ReplicationController,
                       name: str = "") -> None:
        """ref: createReplica (:63-89) — pod stamped from the RC template,
        named ``name`` when given (else the apiserver generates one)."""
        tmpl = rc.spec.template
        pod = api.Pod(
            metadata=api.ObjectMeta(
                namespace=namespace, name=name,
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
        self._sync_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._sync_locks_lock = threading.Lock()
        # (namespace, RC) -> names of creates whose outcome is unknown (the
        # request went out, no answer came back): the apiserver may still
        # commit them after a later sync listed the RC's pods
        self._unsure: Dict[Tuple[str, str], List[str]] = {}

    def _sync_lock(self, ns: str, name: str) -> threading.Lock:
        with self._sync_locks_lock:
            return self._sync_locks.setdefault((ns, name), threading.Lock())

    # -- the core sync (ref: syncReplicationController :193-234) -----------
    def sync(self, rc: api.ReplicationController) -> int:
        """Reconcile one RC; returns the post-sync active-pod count.

        At most one sync of an RC runs at a time: the watch thread and
        the periodic resync each list the RC's active pods and then
        create the shortfall, so two syncs at once would both create
        it. The second waits, and its list then sees the first's pods.
        Under the lock the sync reads the RC as it stands, so a resync
        that listed it before a resize does not restore the old count;
        an RC deleted meanwhile is left alone."""
        ns = rc.metadata.namespace or api.NamespaceDefault
        with self._sync_lock(ns, rc.metadata.name):
            try:
                rc = self.client.replication_controllers(ns).get(
                    rc.metadata.name)
            except errors.StatusError as e:
                if errors.is_not_found(e):
                    return 0
                raise
            return self._sync(rc, ns)

    def _sync(self, rc: api.ReplicationController, ns: str) -> int:
        selector = labels_pkg.selector_from_set(rc.spec.selector)
        pod_list = self.client.pods(ns).list(label_selector=str(selector))
        active = [p for p in pod_list.items if api.is_pod_active(p)]
        diff = len(active) - rc.spec.replicas

        key = (ns, rc.metadata.name)
        listed = {p.metadata.name for p in pod_list.items}
        unsure = [n for n in self._unsure.get(key, ()) if n not in listed]
        self._unsure[key] = unsure
        if diff < 0:
            # scale up: parallel creates (ref: :204-215 wait.Group of
            # createReplica). The pods are named here, and a create whose
            # outcome is unknown is sent again under its name by the next
            # sync that needs a pod: if the first one landed meanwhile, the
            # second is refused as a duplicate, so a late commit cannot
            # make a replica beyond the count (the reference names pods on
            # the apiserver and creates again)
            want = min(-diff, self.burst_replicas)
            names = (unsure + [self._pod_name(rc) for _ in range(want)])[:want]
            self._unsure[key] = unsure[want:]
            with ThreadPoolExecutor(max_workers=min(want, 16)) as ex:
                list(ex.map(lambda n: self._create(ns, rc, n,
                                                   resend=n in unsure),
                            names))
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

    @staticmethod
    def _pod_name(rc: api.ReplicationController) -> str:
        """A replica's name: the RC's, then 5 random characters, as the
        apiserver generates from ``generateName``."""
        return rc.metadata.name + "-" + "".join(random.choices(
            string.ascii_lowercase + string.digits, k=5))

    def _create(self, ns: str, rc: api.ReplicationController, name: str,
                resend: bool) -> None:
        try:
            self.pod_control.create_replica(ns, rc, name)
        except errors.StatusError as e:
            if resend and errors.is_already_exists(e):
                return  # the earlier create landed
            if e.code >= 500:
                self._note_unsure(ns, rc, name)
            raise
        except (OSError, http.client.HTTPException):
            self._note_unsure(ns, rc, name)
            raise

    def _note_unsure(self, ns: str, rc, name: str) -> None:
        with self._sync_locks_lock:
            self._unsure.setdefault((ns, rc.metadata.name), []).append(name)

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
