"""The port's remote store (storage/remote.py) and kube-store binary
(cmd/storeserver.py) on every case of tests/test_remote_store.py: every
verb and error class over the wire, watch streams and resume, server-side
watcher release, concurrent clients on one index, apiserver workers on
one port sharing one kube-store, an idle watch outliving the call
timeout, and a SIGKILLed kube-store respawned under its clients."""

from test_torch_twin import port_twin

globals().update(port_twin("test_remote_store"))
