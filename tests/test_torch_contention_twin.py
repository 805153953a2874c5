"""tests/test_contention.py against the port: optimistic-concurrency
conflicts between schedulers on one apiserver. Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_contention"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
