"""ResourceQuota usage controller (ref: pkg/resourcequota/resource_quota_controller.go).

Port of ``kubernetes_tpu/controllers/resourcequota.py``.

Periodically recomputes observed usage for every ResourceQuota and writes
``status.hard``/``status.used`` through the status sub-resource when they
drift (ref: syncResourceQuota :108-168). The admission plugin does the live
CAS decrement on create; this loop is the level-triggered ground truth that
heals any drift.
"""

from __future__ import annotations

import threading
from typing import Dict

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.controllers.util import run_periodic

__all__ = ["ResourceQuotaController"]


class ResourceQuotaController:
    def __init__(self, client):
        self.client = client
        self._stop = threading.Event()

    def compute_usage(self, quota: api.ResourceQuota) -> Dict[str, Quantity]:
        """Observed usage for the quota's namespace, restricted to the
        resources named in spec.hard (ref: syncResourceQuota :120-160)."""
        ns = quota.metadata.namespace or api.NamespaceDefault
        used: Dict[str, Quantity] = {}
        hard = quota.spec.hard
        if api.ResourcePods in hard or api.ResourceCPU in hard or \
                api.ResourceMemory in hard:
            pods = self.client.pods(ns).list()
            active = [p for p in pods.items if api.is_pod_active(p)]
            if api.ResourcePods in hard:
                used[api.ResourcePods] = Quantity(str(len(active)))
            cpu = 0
            mem = 0
            for p in active:
                req = api.pod_requests(p)
                cpu += req.get(api.ResourceCPU, 0)
                mem += req.get(api.ResourceMemory, 0)
            if api.ResourceCPU in hard:
                used[api.ResourceCPU] = Quantity(f"{cpu}m")
            if api.ResourceMemory in hard:
                used[api.ResourceMemory] = Quantity(str(mem))
        simple = {
            api.ResourceServices: lambda: self.client.services(ns),
            api.ResourceReplicationControllers:
                lambda: self.client.replication_controllers(ns),
            api.ResourceQuotas: lambda: self.client.resource_quotas(ns),
            api.ResourceSecrets: lambda: self.client.secrets(ns),
        }
        for name, getter in simple.items():
            if name in hard:
                used[name] = Quantity(str(len(getter().list().items)))
        return used

    def sync_quota(self, quota: api.ResourceQuota) -> None:
        used = self.compute_usage(quota)
        dirty = (
            {k: str(v) for k, v in quota.status.hard.items()} !=
            {k: str(v) for k, v in quota.spec.hard.items()} or
            {k: str(v) for k, v in quota.status.used.items()} !=
            {k: str(v) for k, v in used.items()}
        )
        if not dirty:
            return
        quota.status.hard = dict(quota.spec.hard)
        quota.status.used = used
        self.client.resource_quotas(quota.metadata.namespace).update_status(quota)

    def sync_all(self) -> None:
        for quota in self.client.resource_quotas(api.NamespaceAll).list().items:
            try:
                self.sync_quota(quota)
            except Exception:
                continue

    def run(self, period: float = 10.0) -> "ResourceQuotaController":
        run_periodic(self.sync_all, period, "quota-controller", self._stop)
        return self

    def stop(self) -> None:
        self._stop.set()
