"""The port's striped store (storage/stripestore.py) on every case of
tests/test_storeshard.py: the namespace shard map, bit-identity with
``MemStore`` under concurrent streams and injected errors, cross-shard
transactions all or nothing, the striped WAL's group commit, replay and
interchange with ``DurableStore``, per-shard staleness, and the lock
discipline under locksmith."""

from test_torch_twin import port_twin

globals().update(port_twin("test_storeshard"))
