"""The port's descheduler (descheduler/, cmd/descheduler.py) on the cases
of tests/test_defrag.py: the dense wave and the incremental encoder
against the oracle, movable-pod selection, the migration binding's
atomic host swap and per-item conflicts, the controller's token bucket,
its ``pending_work`` decline and its monotone score, kubectl cordon,
uncordon and drain through every layer, the SLO rules, and the binary's
flags.

Left out: the two cases that load the reference's ``hack/churn_mp.py``
and ``hack/perfgate.py``, harness scripts that drive only the reference
(as the chaos twin's four harness cases are)."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

HACK = "loads hack/, whose harness drives only the reference"

globals().update(port_twin("test_defrag", {
    "TestRecordContract::test_fragmentation_gate": HACK,
    "TestRecordContract::test_perfgate_shape_key_isolates_fragment_storms":
        HACK,
}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
