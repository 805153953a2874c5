"""The port's kubelet (kubelet/) on every case of tests/test_kubelet.py,
tests/test_kubelet_server.py, tests/test_envvars.py and
tests/test_capabilities.py: pod sync against a ``FakeRuntime`` (the
infra container, starts, restarts under each policy, kills of pods no
longer desired), node-side admission on the scheduler's predicates,
probes (HTTP, TCP and exec), status writes, garbage collection, the
config sources and their merge, the read-only HTTP server (``/pods``,
``/stats``, ``/containerLogs``, ``/run``, port-forward), the service
environment variables and the privileged-container capability."""

from test_torch_twin import port_twin

globals().update(port_twin("test_kubelet"))
globals().update(port_twin("test_kubelet_server"))
globals().update(port_twin("test_envvars"))
globals().update(port_twin("test_capabilities"))
