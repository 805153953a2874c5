"""Node lifecycle controller (ref: pkg/cloudprovider/controller/nodecontroller.go).

Port of ``kubernetes_tpu/controllers/node.py``.

Responsibilities, mirroring the reference:

- ``register_nodes`` (:174-208): create the static node set with retries.
- ``sync_node_status`` (:281-310 + DoCheck :312-397): probe each node's
  kubelet health endpoint and set the NodeReady / NodeReachable /
  NodeSchedulable conditions with probe + transition timestamps.
- ``monitor_node_status`` / eviction (:440, deletePods :570): a node whose
  Ready condition has been false/unknown past the grace period has its pods
  deleted so the replication manager can reschedule them elsewhere.

The kubelet probe is the ``node_prober`` seam: any callable
``(node) -> bool`` — the real one hits the kubelet health port, tests and
the integration harness script it.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["NodeController"]


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)


class NodeController:
    def __init__(self, client, static_nodes: Optional[List[api.Node]] = None,
                 node_prober: Optional[Callable[[api.Node], bool]] = None,
                 pod_eviction_timeout: float = 30.0,
                 register_retry_count: int = 10,
                 cloud=None, match_re: str = ".*",
                 default_capacity: Optional[dict] = None):
        self.client = client
        self.static_nodes = static_nodes or []
        self.node_prober = node_prober or (lambda node: True)
        self.pod_eviction_timeout = pod_eviction_timeout
        self.register_retry_count = register_retry_count
        # cloud provider (ref: nodecontroller.go cloud + matchRE flags);
        # with a cloud and no static nodes, the instance list is authoritative
        self.cloud = cloud
        self.match_re = match_re
        self.default_capacity = default_capacity or {}
        self._stop = threading.Event()
        # name -> monotonic time the node was first seen not-ready
        self._not_ready_since: Dict[str, float] = {}

    # -- registration (ref: RegisterNodes :174-208) -------------------------
    def register_nodes(self) -> None:
        for node in self.static_nodes:
            for attempt in range(self.register_retry_count):
                try:
                    self.client.nodes().create(node)
                    break
                except errors.StatusError as e:
                    if errors.is_already_exists(e):
                        break
                    if attempt == self.register_retry_count - 1:
                        raise
                    time.sleep(0.05)

    # -- cloud node discovery (ref: SyncCloud :208 + CloudNodes :248) -------
    def cloud_nodes(self) -> List[api.Node]:
        """Build Node objects from the cloud instance list."""
        instances = self.cloud.instances() if self.cloud else None
        if instances is None:
            return []
        out = []
        for name in instances.list_instances(self.match_re):
            spec = instances.get_node_resources(name)
            node = api.Node(metadata=api.ObjectMeta(name=name),
                            spec=spec or api.NodeSpec(
                                capacity=dict(self.default_capacity)))
            addrs = instances.node_addresses(name)
            if addrs:
                node.status.addresses = [
                    api.NodeAddress(type="LegacyHostIP", address=addrs[0])]
            out.append(node)
        return out

    def sync_cloud_nodes(self) -> None:
        """Reconcile registered nodes against the cloud's instance set
        (ref: nodecontroller.go SyncCloud: create new, delete departed +
        their pods)."""
        if self.cloud is None:
            return
        if self.static_nodes:
            # static list and cloud discovery are mutually exclusive — the
            # cloud set would otherwise "reconcile away" the static nodes
            # every tick (ref: nodecontroller.go Run chooses one mode)
            return
        matches = {n.metadata.name: n for n in self.cloud_nodes()}
        registered = self.client.nodes().list().items
        known = {n.metadata.name for n in registered}
        for name, node in matches.items():
            if name not in known:
                try:
                    self.client.nodes().create(node)
                except errors.StatusError:
                    pass
        for node in registered:
            name = node.metadata.name
            if name not in matches:
                try:
                    self.client.nodes().delete(name)
                except errors.StatusError as e:
                    if not errors.is_not_found(e):
                        continue  # transient failure: node still registered,
                        # do NOT orphan-delete its pods
                self.delete_pods(name)

    # -- health sync (ref: SyncNodeStatus + DoCheck :312-397) ---------------
    def sync_node_status(self) -> None:
        nodes = self.client.nodes().list()
        for node in nodes.items:
            try:
                self._check_one(node)
            except errors.StatusError:
                continue  # node deleted/raced; next tick reconciles
        # pods bound to a node that no longer exists are orphaned — evict
        # them immediately so controllers can replace them (ref: the cloud
        # node-set sync deletes pods of removed nodes, nodecontroller.go:208)
        live = {n.metadata.name for n in nodes.items}
        try:
            bound = self.client.pods(api.NamespaceAll).list(
                field_selector="spec.host!=")
            orphans = [p for p in bound.items if p.spec.host not in live]
            if orphans:
                # a node created while the checks above ran is not in the
                # first list, nor are the pods bound to it orphans: ask
                # again, after the pods were listed
                fresh = {n.metadata.name
                         for n in self.client.nodes().list().items}
                orphans = [p for p in orphans if p.spec.host not in fresh]
            for pod in orphans:
                try:
                    self.client.pods(pod.metadata.namespace).delete(
                        pod.metadata.name)
                except errors.StatusError:
                    continue
        except errors.StatusError:
            pass
        # forget eviction timers of nodes that no longer exist, so a
        # re-registered node with the same name starts a fresh grace period
        for name in [n for n in self._not_ready_since if n not in live]:
            del self._not_ready_since[name]

    def _check_one(self, node: api.Node) -> None:
        healthy = False
        try:
            healthy = bool(self.node_prober(node))
        except Exception:
            healthy = False
        now = _now()
        status = api.ConditionTrue if healthy else api.ConditionFalse
        desired = {
            api.NodeReady: (status,
                            "kubelet healthy" if healthy else "kubelet unhealthy"),
            api.NodeReachable: (status,
                                "node reachable" if healthy else "node unreachable"),
            api.NodeSchedulable: (
                api.ConditionFalse if node.spec.unschedulable else api.ConditionTrue,
                "marked unschedulable" if node.spec.unschedulable else "schedulable"),
        }
        conds = {c.type: c for c in node.status.conditions}
        changed = False
        for ctype, (cstatus, msg) in desired.items():
            cur = conds.get(ctype)
            if cur is None:
                conds[ctype] = api.NodeCondition(
                    type=ctype, status=cstatus, reason=msg, message=msg,
                    last_probe_time=now, last_transition_time=now)
                changed = True
            else:
                if cur.status != cstatus:
                    cur.last_transition_time = now
                    changed = True
                cur.status = cstatus
                cur.reason = msg
                cur.message = msg
                cur.last_probe_time = now
        node.status.conditions = sorted(conds.values(), key=lambda c: c.type)
        # probe timestamps move every cycle; write only on a status change to
        # avoid a constant update storm (the reference writes every cycle —
        # one of its known scaling problems; SURVEY.md §5 failure detection)
        if changed:
            self.client.nodes().update(node)
        self._track_readiness(node, healthy)

    def _track_readiness(self, node: api.Node, healthy: bool) -> None:
        name = node.metadata.name
        if healthy:
            self._not_ready_since.pop(name, None)
            return
        first = self._not_ready_since.setdefault(name, time.monotonic())
        if time.monotonic() - first >= self.pod_eviction_timeout:
            self.delete_pods(name)
            self._not_ready_since[name] = time.monotonic()  # re-arm

    # -- eviction (ref: deletePods :570-590) --------------------------------
    def delete_pods(self, node_name: str) -> int:
        """Delete every pod bound to a dead node; returns the count."""
        pods = self.client.pods(api.NamespaceAll).list(
            field_selector=f"spec.host={node_name}")
        n = 0
        for pod in pods.items:
            try:
                self.client.pods(pod.metadata.namespace).delete(pod.metadata.name)
                n += 1
            except errors.StatusError:
                continue
        return n

    # -- loop (ref: Run :123-172) -------------------------------------------
    def run(self, period: float = 5.0) -> "NodeController":
        try:
            self.register_nodes()
        except Exception:
            pass  # registration retries exhausted; health loop still runs

        def tick():
            self.sync_cloud_nodes()
            self.sync_node_status()
        run_periodic(tick, period, "node-controller", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()
