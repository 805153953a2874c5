"""The port's label selectors, quantities and codec on every case of
tests/test_labels.py, tests/test_quantity.py and
tests/test_serialization.py: the round-trip fuzz over the three versions
the port registers (v1, v1beta1, v1beta2), the legacy wire's shape, its
defaulting pass and its field labels."""

from test_torch_twin import port_twin

globals().update(port_twin("test_labels"))
globals().update(port_twin("test_quantity"))
globals().update(port_twin("test_serialization"))
