"""Cloud provider interface + implementations
(ref: pkg/cloudprovider/cloud.go, pkg/cloudprovider/fake/fake.go).

Port of ``kubernetes_tpu/cloudprovider/cloud.py``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["Interface", "TCPLoadBalancer", "Instances", "Zones", "Zone",
           "Clusters", "FakeCloud", "LocalCloud", "register_provider",
           "get_provider"]


@dataclass
class Zone:
    """ref: cloud.go Zone{FailureDomain, Region}."""

    failure_domain: str = ""
    region: str = ""


class TCPLoadBalancer:
    """ref: cloud.go TCPLoadBalancer interface."""

    def get_tcp_load_balancer(self, name: str, region: str):
        """-> (host, exists)"""
        raise NotImplementedError

    def create_tcp_load_balancer(self, name: str, region: str,
                                 external_ip: str, port: int,
                                 hosts: List[str]) -> None:
        raise NotImplementedError

    def update_tcp_load_balancer(self, name: str, region: str,
                                 hosts: List[str]) -> None:
        raise NotImplementedError

    def delete_tcp_load_balancer(self, name: str, region: str) -> None:
        raise NotImplementedError


class Instances:
    """ref: cloud.go Instances interface."""

    def node_addresses(self, name: str) -> List[str]:
        raise NotImplementedError

    def external_id(self, name: str) -> str:
        raise NotImplementedError

    def list_instances(self, name_filter: str = ".*") -> List[str]:
        raise NotImplementedError

    def get_node_resources(self, name: str) -> Optional[api.NodeSpec]:
        raise NotImplementedError


class Zones:
    def get_zone(self) -> Zone:
        raise NotImplementedError


class Clusters:
    """ref: cloud.go Clusters interface."""

    def list_clusters(self) -> List[str]:
        raise NotImplementedError

    def master(self, cluster_name: str) -> str:
        raise NotImplementedError


class Interface:
    """ref: cloud.go Interface — capability getters return None when the
    provider doesn't support that surface (the (T, bool) pattern)."""

    def tcp_load_balancer(self) -> Optional[TCPLoadBalancer]:
        return None

    def instances(self) -> Optional[Instances]:
        return None

    def zones(self) -> Optional[Zones]:
        return None

    def clusters(self) -> Optional[Clusters]:
        return None


# ---------------------------------------------------------------------------
# fake (ref: pkg/cloudprovider/fake/fake.go)
# ---------------------------------------------------------------------------

class FakeCloud(Interface, TCPLoadBalancer, Instances, Zones, Clusters):
    """Scriptable provider recording every call in ``calls``."""

    def __init__(self, machines: Optional[List[str]] = None,
                 zone: Optional[Zone] = None,
                 node_resources: Optional[api.NodeSpec] = None):
        self.machines = list(machines or [])
        self.zone = zone or Zone("fake-zone", "fake-region")
        self.node_resources = node_resources
        self.balancers: Dict[str, tuple] = {}
        self.calls: List[tuple] = []
        self.err: Optional[Exception] = None

    def _record(self, *call):
        self.calls.append(call)
        if self.err is not None:
            e, self.err = self.err, None
            raise e

    # capabilities
    def tcp_load_balancer(self):
        return self

    def instances(self):
        return self

    def zones(self):
        return self

    def clusters(self):
        return self

    # TCPLoadBalancer
    def get_tcp_load_balancer(self, name, region):
        self._record("get-lb", name, region)
        lb = self.balancers.get(name)
        return (lb[0] if lb else "", name in self.balancers)

    def create_tcp_load_balancer(self, name, region, external_ip, port, hosts):
        self._record("create-lb", name, region, external_ip, port,
                     tuple(hosts))
        self.balancers[name] = (external_ip, port, list(hosts))

    def update_tcp_load_balancer(self, name, region, hosts):
        self._record("update-lb", name, region, tuple(hosts))
        ip, port, _ = self.balancers[name]
        self.balancers[name] = (ip, port, list(hosts))

    def delete_tcp_load_balancer(self, name, region):
        self._record("delete-lb", name, region)
        self.balancers.pop(name, None)

    # Instances
    def node_addresses(self, name):
        self._record("node-addresses", name)
        return ["1.2.3.4"] if name in self.machines else []

    def external_id(self, name):
        self._record("external-id", name)
        return f"ext-{name}"

    def list_instances(self, name_filter=".*"):
        import re
        self._record("list", name_filter)
        rx = re.compile(name_filter)
        return [m for m in self.machines if rx.match(m)]

    def get_node_resources(self, name):
        self._record("get-node-resources", name)
        return self.node_resources

    # Zones
    def get_zone(self):
        self._record("get-zone")
        return self.zone

    # Clusters
    def list_clusters(self):
        self._record("list-clusters")
        return ["fake-cluster"]

    def master(self, cluster_name):
        self._record("master", cluster_name)
        return "fake-master"


# ---------------------------------------------------------------------------
# local — a real provider for single-machine / dev deployments
# ---------------------------------------------------------------------------

class LocalCloud(Interface, Instances, Zones):
    """The machine it runs on is the one instance."""

    def instances(self):
        return self

    def zones(self):
        return self

    def node_addresses(self, name):
        try:
            return [socket.gethostbyname(name)]
        except OSError:
            return ["127.0.0.1"]

    def external_id(self, name):
        return name

    def list_instances(self, name_filter=".*"):
        return [socket.gethostname()]

    def get_node_resources(self, name):
        return None

    def get_zone(self):
        return Zone("local", "local")


# ---------------------------------------------------------------------------
# registry (ref: pkg/cloudprovider/plugins.go)
# ---------------------------------------------------------------------------

_PROVIDERS: Dict[str, Callable[[], Interface]] = {}


def register_provider(name: str, factory: Callable[[], Interface]) -> None:
    _PROVIDERS[name] = factory


def get_provider(name: str) -> Optional[Interface]:
    factory = _PROVIDERS.get(name)
    return factory() if factory else None


register_provider("fake", FakeCloud)
register_provider("local", LocalCloud)
