"""The port's durable store (storage/durable.py) on every case of
tests/test_durable.py: state, indices, CAS tokens, the watch window and
TTLs across a restart, compaction and its carried record count, torn
tails truncated and disclosed, the master's cluster state over a restart,
and the port's kube-apiserver SIGKILLed and resumed on its data
directory."""

from test_torch_twin import port_twin

globals().update(port_twin("test_durable"))
