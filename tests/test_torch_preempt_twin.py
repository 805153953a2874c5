"""tests/test_preempt.py against the port: preemption waves through the
port's ``solve`` and incremental encoder equal the port's
``oracle.preempt_serial``; the PriorityClass API and the loop's
evict+bind through the port's apiserver. Left out: the PriorityClass wire
round trip over every registered version, since the legacy
v1beta1/v1beta2 wire is not ported (ROADMAP Queue 1 item 13)."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_preempt", {
    "TestPriorityClassAPI::test_wire_roundtrip_all_versions":
        "the legacy v1beta1/v1beta2 wire is not ported (Queue 1 item 13)",
}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
