"""tests/test_tracing.py against the port: the span ring, the wire form,
the solver daemon's spans, ``Histogram.quantile``'s semantics and the
pod-latency metrics. Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_tracing"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
