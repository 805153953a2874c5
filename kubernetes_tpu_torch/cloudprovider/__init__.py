"""Cloud provider abstraction (ref: pkg/cloudprovider/cloud.go:26-80).

Port of ``kubernetes_tpu/cloudprovider/__init__.py``.

``Interface`` exposes optional capability getters — ``tcp_load_balancer()``,
``instances()``, ``zones()``, ``clusters()`` — each returning the capability
object or None, exactly like the reference's (T, bool) pairs. Providers:

- ``FakeCloud``      (ref: pkg/cloudprovider/fake/) — scriptable double
- ``LocalCloud``     — a real provider for single-machine deployments: the
  instance list is localhost, load balancers are kube-proxy portals
- ``InventoryCloud`` — JSON-inventory-file provider (the vagrant/ovirt
  config-driven pattern); registered as "inventory"
- ``ProbeCloud``     — discovery-command provider (the GCE-metadata /
  live-query pattern) with Clusters support; registered as "probe"
- ``LocalLBCloud``   — a TCPLoadBalancer facet that actually balances:
  real listeners forwarding round-robin to the registered hosts (the
  GCE forwarding-rule pattern in software); registered as "locallb"

The registry (``register_provider``/``get_provider``) mirrors
pkg/cloudprovider/plugins.go; importing this package registers the
bundled providers, like the reference's provider init() side effects.
"""

from kubernetes_tpu_torch.cloudprovider.cloud import (Clusters, FakeCloud,  # noqa: F401
                                                Instances, Interface,
                                                LocalCloud, TCPLoadBalancer,
                                                Zone, Zones, get_provider,
                                                register_provider)
from kubernetes_tpu_torch.cloudprovider.inventory import InventoryCloud  # noqa: F401,E402
from kubernetes_tpu_torch.cloudprovider.locallb import LocalLBCloud  # noqa: F401,E402
from kubernetes_tpu_torch.cloudprovider.probe import ProbeCloud  # noqa: F401,E402
