"""The port's kubectl (kubectl/: the resource Builder, the printers, the
describers, the generators, resize/stop/rolling-update and the command
tree) on every case of tests/test_kubectl.py, each against an in-process
``Master`` of the port through the port's ``Factory``."""

from test_torch_twin import port_twin

globals().update(port_twin("test_kubectl"))
