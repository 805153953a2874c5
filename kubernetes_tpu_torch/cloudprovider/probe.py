"""ProbeCloud — a discovery-command-backed cloud provider.

Port of ``kubernetes_tpu/cloudprovider/probe.py``.

Second real provider proving the cloudprovider seam from a different
angle than InventoryCloud's static file: the reference's providers query
LIVE external systems — GCE reads the metadata service, vagrant shells
out to discover minions, ovirt polls its API (ref:
pkg/cloudprovider/cloud.go:26-80 and the per-provider packages). Here
the external system is abstracted as a *probe command*: any executable
that prints the inventory JSON schema on stdout. The provider runs it
with a timeout, caches the parsed snapshot for a TTL, and on ANY
failure (nonzero exit, timeout, torn output) keeps serving the previous
snapshot — a flapping discovery backend must degrade to stale, never to
"empty cloud" (which would make the node controller delete every node).

Beyond Instances/Zones it implements the Clusters facet the inventory
provider leaves unsupported (ref: cloud.go Clusters — ListClusters/
Master), fed by an optional ``clusters`` section:

    {"zone": {"failure_domain": "z1", "region": "r1"},
     "instances": [{"name": "...", "addresses": [...], "cpu": "4", ...}],
     "clusters": {"names": ["alpha"], "masters": {"alpha": "10.0.0.2"}}}
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.cloudprovider.cloud import (Clusters, Instances,
                                                Interface, Zone, Zones,
                                                register_provider)
from kubernetes_tpu_torch.cloudprovider.inventory import InventoryError, _Snapshot

__all__ = ["ProbeCloud", "ProbeError"]


class ProbeError(InventoryError):
    """The probe command has never produced a readable inventory."""


class _ClustersView(Clusters):
    def __init__(self, names: List[str], masters: Dict[str, str]):
        self._names = names
        self._masters = masters

    def list_clusters(self) -> List[str]:
        return sorted(self._names)

    def master(self, cluster_name: str) -> str:
        try:
            return self._masters[cluster_name]
        except KeyError:
            raise KeyError(f"cluster {cluster_name!r} has no known master")


class ProbeCloud(Interface):
    """Instances + Zones + Clusters discovered by running a command."""

    def __init__(self, command: List[str], ttl_s: float = 10.0,
                 timeout_s: float = 5.0, clock=time.monotonic):
        self.command = list(command)
        self.ttl_s = ttl_s
        self.timeout_s = timeout_s
        self._clock = clock
        self._snapshot: Optional[_Snapshot] = None
        self._clusters: Optional[_ClustersView] = None
        self._fetched_at: float = -1.0
        self._refresh_lock = threading.Lock()
        self._refresh()

    # -- probing -----------------------------------------------------------
    def _refresh(self) -> None:
        with self._refresh_lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        now = self._clock()
        if self._fetched_at >= 0 and now - self._fetched_at < self.ttl_s:
            return
        try:
            p = subprocess.run(self.command, capture_output=True,
                               timeout=self.timeout_s)
            if p.returncode != 0:
                raise ValueError(f"probe exited {p.returncode}")
            data = json.loads(p.stdout.decode("utf-8", "replace"))
            if not isinstance(data, dict):
                raise ValueError("probe output is not a JSON object")
            # parse the WHOLE schema before touching any state: a
            # structurally-malformed inventory (instance without "name",
            # zone as a string, ...) must degrade to the stale snapshot
            # like any other torn output, never crash a sync tick or
            # leave snapshot/clusters half-replaced
            zone = data.get("zone") or {}
            snapshot = _Snapshot(
                Zone(failure_domain=zone.get("failure_domain", ""),
                     region=zone.get("region", "")),
                {inst["name"]: inst for inst in data.get("instances", [])})
            clusters = data.get("clusters") or {}
            clusters_view = _ClustersView(
                list(clusters.get("names", [])),
                dict(clusters.get("masters", {})))
        except (OSError, subprocess.SubprocessError, ValueError, KeyError,
                AttributeError, TypeError):
            # keep the previous snapshot; retry on the next access past TTL.
            # Record the attempt time even before any success so a dead probe
            # command costs one subprocess per TTL window, not per call.
            self._fetched_at = now
            return
        self._snapshot = snapshot
        self._clusters = clusters_view
        self._fetched_at = now

    def _current(self) -> _Snapshot:
        self._refresh()
        if self._snapshot is None:
            raise ProbeError(
                f"probe {self.command!r} has never produced an inventory")
        return self._snapshot

    # -- Interface ---------------------------------------------------------
    def instances(self) -> Optional[Instances]:
        return self._current()

    def zones(self) -> Optional[Zones]:
        return self._current()

    def clusters(self) -> Optional[Clusters]:
        self._current()
        return self._clusters


def _from_env():
    import os
    import shlex
    cmd = os.environ.get("KTPU_CLOUD_PROBE_CMD", "")
    if not cmd:
        raise ProbeError("KTPU_CLOUD_PROBE_CMD is not set")
    return ProbeCloud(shlex.split(cmd))


register_provider("probe", _from_env)
