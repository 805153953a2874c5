"""The manifests users create (examples/*/*.json) through the port's
scheme, on every case of tests/test_examples.py: each decodes, validates,
round-trips through every version the port registers (v1, v1beta1,
v1beta2), and every field it writes reaches the decoded object."""

from test_torch_twin import port_twin

globals().update(port_twin("test_examples"))
