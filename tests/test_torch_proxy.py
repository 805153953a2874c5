"""The port's service proxy (``proxy/``, ``util/iptables.py``) on the
cases of tests/test_proxy.py (the round-robin balancer, the proxier with
real sockets against echo backends, the watch-driven config) and
tests/test_soak.py (the short serve_hostnames soak through the proxy).
No case is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_proxy"))
globals().update(port_twin("test_soak"))
