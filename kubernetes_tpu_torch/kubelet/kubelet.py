"""Kubelet core (ref: pkg/kubelet/kubelet.go).

``run`` consumes the merged PodConfig channel in a select-style loop with a
resync tick (ref: syncLoop:1779-1808). ``sync_pods`` (ref: SyncPods:1566-1680)
re-admits pods against node capacity/ports (ref: handleNotFittingPods:1750-1772,
reusing the scheduler's predicate functions :1717-1746), dispatches per-pod
workers, kills containers of unwanted pods, and garbage-collects. ``sync_pod``
(ref: syncPod:1375+) drives one pod to its desired state: infra ("pause")
container first (ref: createPodInfraContainer:1025), then per-container
create/restart decisions (ref: computePodContainerChanges:1252), liveness
probes, and a status push.

Port of ``kubernetes_tpu/kubelet/kubelet.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch import capabilities
from kubernetes_tpu_torch import probe as probe_pkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.kubelet import envvars
from kubernetes_tpu_torch.kubelet.config import ConfigSourceAnnotation, PodConfig
from kubernetes_tpu_torch.kubelet.gc import ContainerGC, GCPolicy
from kubernetes_tpu_torch.kubelet.pod_workers import PodWorkers
from kubernetes_tpu_torch.kubelet.runtime import (
    INFRA_CONTAINER_NAME,
    ContainerRecord,
    ContainerRuntime,
)
from kubernetes_tpu_torch.kubelet.status import StatusManager
from kubernetes_tpu_torch.scheduler import predicates as sched_predicates

__all__ = ["Kubelet"]

ConfigMirrorAnnotation = "kubernetes.io/config.mirror"


def _ts(t: float) -> Optional[datetime.datetime]:
    if not t:
        return None
    return datetime.datetime.fromtimestamp(t, datetime.timezone.utc)


class Kubelet:
    def __init__(self, hostname: str, runtime: ContainerRuntime,
                 client=None, recorder=None,
                 resync_period: float = 2.0,
                 gc_policy: Optional[GCPolicy] = None,
                 volume_mgr=None, service_lister=None,
                 master_service_namespace: str = "default"):
        self.hostname = hostname
        self.runtime = runtime
        self.client = client
        self.recorder = recorder
        self.resync_period = resync_period
        # service discovery env vars (ref: kubelet.go makeEnvironmentVariables
        # + pkg/kubelet/envvars): a callable returning every Service, fed by
        # a reflector cache; None disables injection (pure-fake tests)
        self.service_lister = service_lister
        self.master_service_namespace = master_service_namespace
        self.status_manager = StatusManager(client)
        self.pod_workers = PodWorkers(self.sync_pod)
        self.container_gc = ContainerGC(runtime, gc_policy or GCPolicy())
        # volume plugin manager (ref: kubelet.go volumePluginMgr); None
        # means this kubelet runs without a volumes dir (pure-fake tests)
        self.volume_mgr = volume_mgr
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._desired: Dict[str, api.Pod] = {}   # uid -> pod
        self._probe_failures: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    # the outer loop (ref: syncLoop:1779-1808)
    # ------------------------------------------------------------------
    def run(self, pod_config: PodConfig) -> "Kubelet":
        def loop():
            pods: List[api.Pod] = []
            while not self._stop.is_set():
                try:
                    update = pod_config.updates.get(timeout=self.resync_period)
                    pods = update.pods
                except queue.Empty:
                    pass  # resync tick re-runs the last snapshot
                try:
                    self.sync_pods(pods)
                except Exception:
                    pass
        threading.Thread(target=loop, daemon=True,
                         name=f"kubelet-{self.hostname}").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.pod_workers.stop()

    # ------------------------------------------------------------------
    # node-side admission (ref: handleNotFittingPods:1750-1772)
    # ------------------------------------------------------------------
    def _filter_fitting(self, pods: List[api.Pod]) -> List[api.Pod]:
        fitting: List[api.Pod] = []
        node = self._get_node()
        for pod in pods:
            # port conflicts against pods already admitted this pass
            # (ref: checkHostPortConflicts:1717 reusing scheduler predicates)
            if not sched_predicates.pod_fits_ports(pod, fitting, self.hostname):
                self._reject(pod, "HostPortConflict",
                             "Pod cannot be started due to host port conflict")
                continue
            if node is not None and not sched_predicates.pod_matches_node_labels(pod, node):
                self._reject(pod, "NodeSelectorMismatching",
                             "Pod cannot be started due to node selector mismatch")
                continue
            if node is not None and node.spec.capacity:
                _, exceeding = sched_predicates.check_pods_exceeding_capacity(
                    fitting + [pod], node.spec.capacity)
                if pod in exceeding:
                    self._reject(pod, "ExceededCapacity",
                                 "Pod cannot be started due to exceeded capacity")
                    continue
            fitting.append(pod)
        return fitting

    def _get_node(self) -> Optional[api.Node]:
        if self.client is None:
            return None
        try:
            return self.client.nodes().get(self.hostname)
        except Exception:
            return None

    def _reject(self, pod: api.Pod, reason: str, message: str) -> None:
        if self.recorder is not None:
            self.recorder.eventf(pod, reason, message)
        self.status_manager.set_pod_status(pod, api.PodStatus(
            phase=api.PodFailed, host=self.hostname, message=message))

    # ------------------------------------------------------------------
    # SyncPods (ref: kubelet.go:1566-1680)
    # ------------------------------------------------------------------
    def sync_pods(self, pods: List[api.Pod]) -> None:
        fitting = self._filter_fitting(pods)
        desired = {p.metadata.uid or p.metadata.name: p for p in fitting}
        with self._lock:
            self._desired = desired

        for pod in fitting:
            self._ensure_mirror_pod(pod)
            self.pod_workers.update_pod(pod)

        # kill containers of pods no longer desired (ref: :1631-1660)
        for record in self.runtime.list_containers():
            parsed = record.parsed
            if parsed is None:
                continue
            if parsed[3] not in desired:
                try:
                    self.runtime.stop_container(record.id)
                except Exception:
                    pass
        self.pod_workers.forget_non_existing(set(desired))
        self.container_gc.collect(live_uids=set(desired))
        # tear down volumes of departed pods (ref: cleanupOrphanedVolumes
        # :1523-1556)
        if self.volume_mgr is not None:
            try:
                self.volume_mgr.cleanup_orphaned_volumes(list(desired))
            except Exception:
                pass  # crash-only: volume gc must not break the sync loop

    # ------------------------------------------------------------------
    # mirror pods for static (file-source) pods (ref: pod_manager.go,
    # mirror_client.go)
    # ------------------------------------------------------------------
    def _ensure_mirror_pod(self, pod: api.Pod) -> None:
        if self.client is None:
            return
        if pod.metadata.annotations.get(ConfigSourceAnnotation) \
                not in ("file", "http"):
            return  # only static pods get mirrors (ref: pod_manager.go)
        ns = pod.metadata.namespace or api.NamespaceDefault
        try:
            self.client.pods(ns).get(pod.metadata.name)
            return
        except errors.StatusError as e:
            if not errors.is_not_found(e):
                return
        mirror = api.Pod(
            metadata=api.ObjectMeta(
                name=pod.metadata.name, namespace=ns,
                labels=dict(pod.metadata.labels),
                annotations={**pod.metadata.annotations,
                             ConfigMirrorAnnotation: "true"}),
            spec=pod.spec)
        try:
            self.client.pods(ns).create(mirror)
            created = self.client.pods(ns).get(pod.metadata.name)
            if not created.spec.host:
                self.client.pods(ns).bind(api.Binding(
                    metadata=api.ObjectMeta(name=pod.metadata.name, namespace=ns),
                    pod_name=pod.metadata.name, host=self.hostname))
        except errors.StatusError:
            pass

    # ------------------------------------------------------------------
    # syncPod (ref: kubelet.go:1375+)
    # ------------------------------------------------------------------
    def sync_pod(self, pod: api.Pod) -> None:
        uid = pod.metadata.uid or pod.metadata.name
        with self._lock:
            if uid not in self._desired:
                return  # deleted while queued
        records = self._pod_records(uid)

        # 1. the infra ("pause") container holds the sandbox (ref: :1025)
        infra = next((r for r in records
                      if r.parsed and r.parsed[0] == INFRA_CONTAINER_NAME
                      and r.running), None)
        if infra is None:
            cid = self.runtime.create_infra_container(pod)
            self.runtime.start_container(cid)
            infra = self.runtime.inspect_container(cid)
            records = self._pod_records(uid)

        # 1.5 mount external volumes before any container starts
        # (ref: kubelet.go mountExternalVolumes call in syncPod :1440)
        if self.volume_mgr is not None and pod.spec.volumes:
            try:
                self.volume_mgr.mount_volumes(pod)
            except Exception as e:
                self._reject(pod, "FailedMount",
                             f"Unable to mount volumes for pod: {e}")
                return

        # 2. per-container reconcile (ref: computePodContainerChanges:1252)
        for container in pod.spec.containers:
            self._sync_container(pod, container, records)

        # 3. status push
        self.status_manager.set_pod_status(pod, self.generate_pod_status(pod))

    def _pod_records(self, uid: str) -> List[ContainerRecord]:
        out = []
        for r in self.runtime.list_containers(include_dead=True):
            p = r.parsed
            if p and p[3] == uid:
                out.append(r)
        return out

    def _sync_container(self, pod: api.Pod, container: api.Container,
                        records: List[ContainerRecord]) -> None:
        mine = [r for r in records
                if r.parsed and r.parsed[0] == container.name]
        running = [r for r in mine if r.running]
        if running:
            record = running[0]
            if self._liveness_failed(pod, container, record):
                # unhealthy: kill; restart policy decides resurrection below
                self.runtime.stop_container(record.id)
                if self.recorder is not None:
                    self.recorder.eventf(pod, "Unhealthy",
                                         "Liveness probe failed for %s",
                                         container.name)
                running = []
            else:
                return  # healthy and running: nothing to do
        # dead or never started: consult restart policy (ref: :1158)
        attempts = max((r.parsed[4] for r in mine), default=-1)
        if mine and not self._should_restart(pod, mine):
            return
        self._start_container(pod, container, attempt=attempts + 1)

    def _should_restart(self, pod: api.Pod, dead: List[ContainerRecord]) -> bool:
        policy = pod.spec.restart_policy
        if policy == api.RestartPolicyAlways:
            return True
        if policy == api.RestartPolicyOnFailure:
            last = max(dead, key=lambda r: r.finished_at)
            return last.exit_code != 0
        return False

    def _start_container(self, pod: api.Pod, container: api.Container,
                         attempt: int) -> None:
        if container.privileged and not capabilities.get().allow_privileged:
            # ref: kubelet.go:797-802 — belt-and-braces behind validation:
            # the node refuses even if an unvalidated source asked. Checked
            # BEFORE the pull so a forbidden pod doesn't re-pull its image
            # on every resync.
            self._reject(pod, "PrivilegedDisallowed",
                         "container requested privileged mode, "
                         "but it is disallowed globally")
            return
        # pull policy (ref: :1101-1120): PullAlways, or IfNotPresent+missing
        policy = container.image_pull_policy or (
            api.PullAlways if container.image.endswith(":latest")
            else api.PullIfNotPresent)
        present = container.image in self.runtime.list_images()
        if policy == api.PullAlways or (
                policy == api.PullIfNotPresent and not present):
            self.runtime.pull_image(container.image)
        elif policy == api.PullNever and not present:
            self._reject(pod, "ErrImageNeverPull",
                         f"image {container.image} not present with PullNever")
            return
        container = self._with_service_env(pod, container)
        cid = self.runtime.create_container(pod, container, attempt)
        self.runtime.start_container(cid)
        if self.recorder is not None:
            self.recorder.eventf(pod, "Started", "Started container %s",
                                 container.name)

    def _with_service_env(self, pod: api.Pod,
                          container: api.Container) -> api.Container:
        """Prepend service-discovery env vars (ref: kubelet.go:896-920
        makeEnvironmentVariables) — the container's own declared env wins
        on name collision, which the runtimes guarantee by applying env
        in order (later entries overwrite)."""
        if self.service_lister is None:
            return container
        try:
            all_svcs = self.service_lister()
        except Exception:
            return container  # discovery must never block a pod start
        visible = envvars.visible_services(
            all_svcs, pod.metadata.namespace or "default",
            master_ns=self.master_service_namespace)
        svc_env = envvars.from_services(visible)
        if not svc_env:
            return container
        return dataclasses.replace(
            container, env=svc_env + list(container.env))

    # ------------------------------------------------------------------
    # probes (ref: probe.go + pkg/probe/)
    # ------------------------------------------------------------------
    def _run_probe(self, p: api.Probe, pod: api.Pod,
                   record: ContainerRecord, pod_ip: str) -> str:
        if p.exec is not None:
            result, _ = probe_pkg.probe_exec(self.runtime, record.id,
                                             p.exec.command)
        elif p.http_get is not None:
            result, _ = probe_pkg.probe_http(
                p.http_get.host or pod_ip or "127.0.0.1", p.http_get.port,
                p.http_get.path, timeout=p.timeout_seconds)
        elif p.tcp_socket is not None:
            result, _ = probe_pkg.probe_tcp(pod_ip or "127.0.0.1",
                                            p.tcp_socket.port,
                                            timeout=p.timeout_seconds)
        else:
            result = probe_pkg.SUCCESS
        return result

    def _liveness_failed(self, pod: api.Pod, container: api.Container,
                         record: ContainerRecord) -> bool:
        p = container.liveness_probe
        if p is None:
            return False
        if time.time() - record.started_at < p.initial_delay_seconds:
            return False
        result = self._run_probe(p, pod, record, self._pod_ip(pod))
        return result == probe_pkg.FAILURE

    def _readiness(self, pod: api.Pod, container: api.Container,
                   record: ContainerRecord) -> bool:
        p = container.readiness_probe
        if p is None:
            return True
        if time.time() - record.started_at < p.initial_delay_seconds:
            return False
        return self._run_probe(p, pod, record, self._pod_ip(pod)) == probe_pkg.SUCCESS

    def _pod_ip(self, pod: api.Pod) -> str:
        uid = pod.metadata.uid or pod.metadata.name
        for r in self._pod_records(uid):
            if r.parsed and r.parsed[0] == INFRA_CONTAINER_NAME and r.running:
                return r.ip
        return ""

    # ------------------------------------------------------------------
    # status generation (ref: GeneratePodStatus + getPodStatus :1300-1370)
    # ------------------------------------------------------------------
    def generate_pod_status(self, pod: api.Pod) -> api.PodStatus:
        uid = pod.metadata.uid or pod.metadata.name
        records = self._pod_records(uid)
        statuses: List[api.ContainerStatus] = []
        all_ready = True
        n_running = n_succeeded = n_failed = 0
        for container in pod.spec.containers:
            mine = sorted((r for r in records
                           if r.parsed and r.parsed[0] == container.name),
                          key=lambda r: r.parsed[4])
            cs = api.ContainerStatus(name=container.name, image=container.image,
                                     restart_count=max(len(mine) - 1, 0))
            if not mine:
                cs.state.waiting = api.ContainerStateWaiting(reason="ContainerCreating")
                all_ready = False
            else:
                latest = mine[-1]
                cs.container_id = latest.id
                if latest.running:
                    cs.state.running = api.ContainerStateRunning(
                        started_at=_ts(latest.started_at))
                    cs.ready = self._readiness(pod, container, latest)
                    all_ready = all_ready and cs.ready
                    n_running += 1
                else:
                    cs.state.termination = api.ContainerStateTerminated(
                        exit_code=latest.exit_code,
                        started_at=_ts(latest.started_at),
                        finished_at=_ts(latest.finished_at))
                    all_ready = False
                    if latest.exit_code == 0:
                        n_succeeded += 1
                    else:
                        n_failed += 1
                if len(mine) > 1:
                    prev = mine[-2]
                    cs.last_termination_state.termination = \
                        api.ContainerStateTerminated(
                            exit_code=prev.exit_code,
                            started_at=_ts(prev.started_at),
                            finished_at=_ts(prev.finished_at))
            statuses.append(cs)

        total = len(pod.spec.containers)
        # phase (ref: getPhase :1310-1360)
        if total == 0 or n_running == total:
            phase = api.PodRunning
        elif n_succeeded == total and \
                pod.spec.restart_policy == api.RestartPolicyNever:
            phase = api.PodSucceeded
        elif n_failed + n_succeeded == total and \
                pod.spec.restart_policy == api.RestartPolicyNever:
            phase = api.PodFailed
        elif n_running + n_succeeded + n_failed == 0:
            phase = api.PodPending
        else:
            phase = api.PodRunning if n_running else api.PodPending

        conditions = []
        if phase == api.PodRunning and all_ready:
            conditions.append(api.PodCondition(type=api.PodReady,
                                               status=api.ConditionTrue))
        else:
            conditions.append(api.PodCondition(type=api.PodReady,
                                               status=api.ConditionFalse))
        return api.PodStatus(
            phase=phase, conditions=conditions, host=self.hostname,
            pod_ip=self._pod_ip(pod), container_statuses=statuses)
