"""Inventory-file cloud provider.

Port of ``kubernetes_tpu/cloudprovider/inventory.py``.

The reference's simplest real providers are config-driven instance
inventories: vagrant polls salt's REST endpoint for minion machines
(ref: pkg/cloudprovider/vagrant/vagrant.go:60-120), ovirt reads a config
file pointing at a VM-list API and filters it (ref:
pkg/cloudprovider/ovirt/ovirt.go:84-180). This provider is that pattern
without the long-dead backends: a JSON inventory file declares the
instances (name, addresses, optional per-node resources) and the zone;
the file is re-read when its mtime changes, so an external process (or a
human) updating the inventory is the "cloud API". The node controller's
cloud-sync loop (controllers/node.py) then registers/deregisters nodes
exactly as it would against a live cloud.

Failure discipline: one sync tick must see ONE consistent snapshot
(``instances()`` binds a view to the snapshot current at call time), a
torn or momentarily missing file must never look like an empty cloud
(that would mass-deregister nodes and evict their pods — the previous
snapshot is kept), and a provider that has NEVER successfully loaded
raises instead of answering empty for the same reason.

Inventory format:

    {
      "zone": {"failure_domain": "a", "region": "local"},
      "instances": [
        {"name": "worker-1", "addresses": ["10.0.0.11"],
         "cpu": "8", "memory": "16Gi"},
        {"name": "worker-2", "addresses": ["10.0.0.12"]}
      ]
    }
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.cloudprovider.cloud import (
    Instances,
    Interface,
    Zone,
    Zones,
    register_provider,
)

__all__ = ["InventoryCloud", "InventoryError"]


class InventoryError(RuntimeError):
    """The inventory has never been readable — callers must not treat
    this as an empty cloud."""


class _Snapshot(Instances, Zones):
    """One consistent view of the inventory; every accessor a sync tick
    performs after ``instances()`` reads this same snapshot."""

    def __init__(self, zone: Zone, instances: Dict[str, dict]):
        self.zone = zone
        self._instances = instances

    def list_instances(self, name_filter: str = ".*") -> List[str]:
        rx = re.compile(name_filter)
        return sorted(n for n in self._instances if rx.match(n))

    def node_addresses(self, name: str) -> List[str]:
        inst = self._instances.get(name)
        if inst is None:
            raise KeyError(f"instance {name!r} not in inventory")
        return list(inst.get("addresses", []))

    def external_id(self, name: str) -> str:
        inst = self._instances.get(name)
        if inst is None:
            raise KeyError(f"instance {name!r} not in inventory")
        return inst.get("external_id", name)

    def get_node_resources(self, name: str) -> Optional[api.NodeSpec]:
        inst = self._instances.get(name)
        if inst is None or ("cpu" not in inst and "memory" not in inst):
            return None
        capacity = {}
        if "cpu" in inst:
            capacity["cpu"] = Quantity(inst["cpu"])
        if "memory" in inst:
            capacity["memory"] = Quantity(inst["memory"])
        return api.NodeSpec(capacity=capacity)

    def get_zone(self) -> Zone:
        return self.zone


class InventoryCloud(Interface):
    """Instances + Zones backed by a JSON inventory file."""

    def __init__(self, path: str):
        self.path = path
        self._mtime = -1.0
        self._snapshot: Optional[_Snapshot] = None
        self._load()

    # -- file handling ------------------------------------------------------
    def _load(self) -> None:
        """Refresh the snapshot if the file changed. On ANY failure —
        missing file (non-atomic replace window), torn write, malformed
        JSON — keep the previous snapshot and reset the mtime so the
        repaired file reloads even with an unchanged timestamp."""
        try:
            mtime = os.stat(self.path).st_mtime
            if mtime == self._mtime:
                return
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            self._mtime = -1.0
            return
        zone = data.get("zone") or {}
        self._snapshot = _Snapshot(
            Zone(failure_domain=zone.get("failure_domain", ""),
                 region=zone.get("region", "")),
            {inst["name"]: inst for inst in data.get("instances", [])})
        self._mtime = mtime

    def _current(self) -> _Snapshot:
        self._load()
        if self._snapshot is None:
            raise InventoryError(
                f"inventory {self.path!r} has never been readable")
        return self._snapshot

    # -- Interface ----------------------------------------------------------
    def instances(self) -> Optional[Instances]:
        return self._current()

    def zones(self) -> Optional[Zones]:
        return self._current()


register_provider(
    "inventory",
    lambda: InventoryCloud(os.environ.get("KTPU_CLOUD_INVENTORY",
                                          "cloud-inventory.json")))
