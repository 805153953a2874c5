"""tests/test_batch_solver.py against the port: the encoder and ``solve``
(the kernel's plain version on the CPU) equal the port's
``oracle.solve_serial`` on the reference's fixtures and fuzz.

Left out: the WaveRouter, the reference's host-versus-tunnel dispatch,
which the port leaves out on purpose (ROADMAP, "Left out on purpose");
two of its cases import jax themselves."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_batch_solver", {
    "TestWaveRouter": "the WaveRouter is left out on purpose (ROADMAP); "
                      "two of its cases import jax",
}))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
