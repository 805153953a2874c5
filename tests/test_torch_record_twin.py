"""tests/test_record.py against the port's event recorders through its
apiserver. Nothing is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_record"))

