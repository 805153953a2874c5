"""The port's store (storage/memstore.py, storage/helper.py) on every case
of tests/test_storage.py: the raw store's CAS, index order, TTLs, watch
replay from an old index and its history window, error injection, and
the typed helper's decode, atomic updates and watch resume."""

from test_torch_twin import port_twin

globals().update(port_twin("test_storage"))
