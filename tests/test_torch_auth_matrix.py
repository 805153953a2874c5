"""The port's authenticators and ABAC authorizer behind the port's
``APIServer``, on the whole table of tests/test_auth_matrix.py."""

from test_torch_twin import port_twin

globals().update(port_twin("test_auth_matrix"))
