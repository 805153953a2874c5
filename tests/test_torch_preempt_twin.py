"""tests/test_preempt.py against the port: preemption waves through the
port's ``solve`` and incremental encoder equal the port's
``oracle.preempt_serial``; the PriorityClass API, its wire round trip
over every registered version, and the loop's evict+bind through the
port's apiserver."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_preempt"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
