"""The port's Master (apiserver/master.py) on every case of
tests/test_apiserver.py, through the port's ``InProcessTransport``: the
generic verbs, registries and subresources, the portal IP allocator,
namespace finalization, the default admission chain (auto-provisioning,
LimitRanger, ResourceQuota), event TTLs, the bounded watch queues and
the batched bind."""

from test_torch_twin import port_twin

globals().update(port_twin("test_apiserver"))
