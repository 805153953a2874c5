"""The port's durable store (storage/durable.py) on every case of
tests/test_durable.py: state, indices, CAS tokens, the watch window and
TTLs across a restart, compaction and its carried record count, torn
tails truncated and disclosed, the master's cluster state over a restart,
and the port's kube-apiserver SIGKILLed and resumed on its data
directory. That case's apiserver listens on 18232 here, not the
reference's 18231: the two files may run at once in two workers, and
two apiservers on one fixed port answer each other's requests."""

from test_torch_twin import port_twin

globals().update(port_twin("test_durable", rename={
    "'18231'": "'18232'", "127.0.0.1:18231": "127.0.0.1:18232"}))
