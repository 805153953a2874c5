"""tests/test_explain.py against the port: ``explain_wave`` is
count-identical to the port's ``oracle.explain_serial``, the message
grammar, the Explainer's rate limit and the SLO rule on unschedulable
pods, and the two end-to-end cases that render the event through the
port's ``kubectl describe``."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_explain"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
