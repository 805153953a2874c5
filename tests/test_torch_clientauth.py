"""The port's legacy ``.kubernetes_auth`` reader (client/clientauth.py)
and the kubeconfig's fallback to it (client/clientcmd.py) on every case
of tests/test_clientauth.py."""

from test_torch_twin import port_twin

globals().update(port_twin("test_clientauth"))
