"""The port's registries on every case of tests/test_rest_conformance.py:
each REST verb, its errors and its watch, for every resource the
reference's conformance table lists."""

from test_torch_twin import port_twin

globals().update(port_twin("test_rest_conformance"))
