"""The port's cluster addons (``addons/dns.py``, ``addons/logging.py``,
``addons/monitoring.py``) on the cases of tests/test_addons.py: RFC 1035
packets over UDP, the monitoring and logging aggregators over the
in-process cluster's kubelet servers. No case is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_addons"))
