"""The port's in-process cluster (cluster.py: master, scheduler,
controller manager and FakeRuntime kubelets in one process) on every
case of tests/test_integration.py and tests/test_density.py: pods
scheduled and run, RCs scaled, services' endpoints filled, static pods
mirrored, node failure and recovery, 30 and 100 pods a node, and the
master's short-lived pod churn.

``/debug/pprof/heap`` of another file on the same worker may leave
``tracemalloc`` on, which makes the density cases overrun their budget
(ROADMAP, "JAX-side failures"); each case here runs with it off and
leaves it off."""

import tracemalloc

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_integration"))
globals().update(port_twin("test_density"))


@pytest.fixture(autouse=True)
def _untraced(monkeypatch):
    port_on_the_cpu(monkeypatch)
    tracemalloc.stop()
    try:
        yield
    finally:
        tracemalloc.stop()
