"""Node/container stats provider — the cAdvisor seam
(ref: pkg/kubelet/cadvisor/: cadvisor_linux.go real client,
cadvisor_fake.go/cadvisor_mock.go doubles).

The kubelet and its HTTP server consume ``StatsProvider``:
- ``machine_info()``      -> MachineInfo        (ref: /spec/ endpoint)
- ``node_stats()``        -> ContainerStats     (root cgroup equivalent)
- ``container_stats(uid, container)`` -> ContainerStats

``ProcStatsProvider`` reads /proc — a real, dependency-free implementation
standing where cAdvisor's daemon would be. ``FakeStatsProvider`` is the
scriptable double for tests.

Port of ``kubernetes_tpu/kubelet/stats.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["MachineInfo", "ContainerStats", "StatsProvider",
           "ProcStatsProvider", "ProcessRuntimeStatsProvider",
           "FakeStatsProvider"]


@dataclass
class MachineInfo:
    """ref: cadvisor api MachineInfo (NumCores/MemoryCapacity)."""

    num_cores: int = 0
    memory_capacity_bytes: int = 0
    machine_id: str = ""

    def as_dict(self) -> dict:
        return {"num_cores": self.num_cores,
                "memory_capacity": self.memory_capacity_bytes,
                "machine_id": self.machine_id}


@dataclass
class ContainerStats:
    """ref: cadvisor ContainerStats subset the kubelet serves."""

    timestamp: float = 0.0
    cpu_usage_core_seconds: float = 0.0
    memory_usage_bytes: int = 0

    def as_dict(self) -> dict:
        return {"timestamp": self.timestamp,
                "cpu": {"usage_core_seconds": self.cpu_usage_core_seconds},
                "memory": {"usage_bytes": self.memory_usage_bytes}}


class StatsProvider:
    def machine_info(self) -> MachineInfo:
        raise NotImplementedError

    def node_stats(self) -> ContainerStats:
        raise NotImplementedError

    def container_stats(self, pod_uid: str,
                        container_name: str) -> Optional[ContainerStats]:
        raise NotImplementedError


class ProcStatsProvider(StatsProvider):
    """Reads /proc directly — the whole-node numbers cAdvisor would give
    (per-container cgroup accounting needs a real container runtime, which
    the FakeRuntime doesn't have; container_stats returns the node numbers
    scaled to zero the way cadvisor_fake does for unknown containers)."""

    def machine_info(self) -> MachineInfo:
        mem = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        mem = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
        return MachineInfo(num_cores=os.cpu_count() or 1,
                           memory_capacity_bytes=mem)

    def node_stats(self) -> ContainerStats:
        cpu_seconds = 0.0
        try:
            with open("/proc/stat") as f:
                first = f.readline().split()
            # user+nice+system in USER_HZ (typically 100)
            cpu_seconds = sum(int(x) for x in first[1:4]) / 100.0
        except (OSError, ValueError):
            pass
        mem_used = 0
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1]) * 1024
            mem_used = info.get("MemTotal", 0) - info.get("MemAvailable", 0)
        except (OSError, ValueError, IndexError):
            pass
        return ContainerStats(timestamp=time.time(),
                              cpu_usage_core_seconds=cpu_seconds,
                              memory_usage_bytes=mem_used)

    def container_stats(self, pod_uid, container_name):
        return ContainerStats(timestamp=time.time())


class ProcessRuntimeStatsProvider(ProcStatsProvider):
    """Per-container accounting for the real ProcessRuntime (ref:
    pkg/kubelet/cadvisor + dockertools container stats): the runtime's
    locked ``group_stats`` sums utime+stime and VmRSS over the container's
    whole process group — forked children included — and reports None for
    dead groups so /stats 404s instead of serving zeros. Node-level
    numbers come from ProcStatsProvider."""

    def __init__(self, runtime):
        self.runtime = runtime

    def container_stats(self, pod_uid, container_name):
        for rec in self.runtime.containers_for_pod(pod_uid):
            if rec.parsed and rec.parsed[0] == container_name:
                gs = self.runtime.group_stats(rec.id)
                if gs is None:
                    return None
                cpu, rss = gs
                return ContainerStats(timestamp=time.time(),
                                      cpu_usage_core_seconds=cpu,
                                      memory_usage_bytes=rss)
        return None


class FakeStatsProvider(StatsProvider):
    """Scriptable double (ref: cadvisor_fake.go)."""

    def __init__(self):
        self.machine = MachineInfo(num_cores=4,
                                   memory_capacity_bytes=8 << 30,
                                   machine_id="fake")
        self.node = ContainerStats(timestamp=1.0,
                                   cpu_usage_core_seconds=10.0,
                                   memory_usage_bytes=1 << 30)
        self.containers: Dict[tuple, ContainerStats] = {}

    def machine_info(self) -> MachineInfo:
        return self.machine

    def node_stats(self) -> ContainerStats:
        return self.node

    def container_stats(self, pod_uid, container_name):
        return self.containers.get((pod_uid, container_name))
