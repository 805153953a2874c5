"""tests/test_explain.py against the port: ``explain_wave`` is
count-identical to the port's ``oracle.explain_serial``, the message
grammar, the Explainer's rate limit and the SLO rule on unschedulable
pods. Left out: the two end-to-end cases that end by rendering the event
through ``kubectl describe`` (``kubectl/``, ROADMAP Queue 1 item 15)."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

KUBECTL = "needs kubectl/describe.py (ROADMAP Queue 1 item 15)"

globals().update(port_twin("test_explain", {
    "TestSchedulerEndToEnd::test_causal_event_carries_breakdown": KUBECTL,
    "TestSchedulerEndToEnd::test_pipelined_event_carries_breakdown_off_hot_path":
        KUBECTL,
}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
