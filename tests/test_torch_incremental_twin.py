"""tests/test_incremental.py against the port: the incremental encoder's
waves equal ``encode_snapshot``'s and the port's ``oracle.solve_serial``.
Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_incremental"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
