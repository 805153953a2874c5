"""The port's scheme, validation, field selectors and REST mapper on
every case of tests/test_api_machinery.py, the legacy v1beta1 wire's
included."""

from test_torch_twin import port_twin

globals().update(port_twin("test_api_machinery"))
