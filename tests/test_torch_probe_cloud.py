"""The port's discovery-command cloud provider (cloudprovider/probe.py)
on every case of tests/test_probe_cloud.py: instances, zones and
clusters from a real probe process, the TTL cache, the stale snapshot
served over a failing or malformed probe, the refusal to answer empty
before a first success, and the registry's ``KTPU_CLOUD_PROBE_CMD``."""

from test_torch_twin import port_twin

globals().update(port_twin("test_probe_cloud"))
