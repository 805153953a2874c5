"""tests/test_flightrec.py against the port: the flight recorder, the
SLO watchdog and rule set of ``addons/monitoring.py``, the aggregator,
``/debug/vars`` and the binaries' deep health. Nothing is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_flightrec"))

