"""tests/test_scheduler.py against the port's serial scheduler
(predicates, priorities, plugins, GenericScheduler, the driver's loop).
Nothing is left out."""

from test_torch_twin import port_twin

globals().update(port_twin("test_scheduler"))

