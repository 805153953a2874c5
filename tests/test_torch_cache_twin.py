"""tests/test_cache.py against the port's client cache (Store, FIFO,
Reflector, Poller, the store listers). Nothing is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_cache"))

