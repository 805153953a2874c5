"""tests/test_policy_solver.py against the port: JSON Policy waves (label
presence and preference, service affinity anchors, zone anti-affinity)
equal the port's ``oracle.solve_serial``. The reference's XLA scan
``solve_jit`` is read as the port's ``solve_scan``, the plain version on
the CPU. Nothing is left out."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_policy_solver",
                           rename={"solve_jit": "solve_scan"}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
