"""The port's BatchScheduler and kubelet on every case of
tests/test_stale_wave.py, over the HTTP stack: two schedulers, one frozen
on a stale snapshot, race one node's capacity; the kubelet's admission
fails the overcommitted pod, and the stale scheduler's CAS loser is not
requeued. The schedulers run their waves on the CPU (``port_on_the_cpu``)."""

import pytest

from test_torch_twin import port_on_the_cpu, port_twin

globals().update(port_twin("test_stale_wave"))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    port_on_the_cpu(monkeypatch)
