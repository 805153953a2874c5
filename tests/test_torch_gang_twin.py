"""tests/test_gang.py against the port: gang waves (checkpoint and
rollback, all-or-nothing) through the port's ``solve`` equal the port's
``oracle.solve_serial(gangs=True)``, and the scheduler's quorum gate.
Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_gang"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
