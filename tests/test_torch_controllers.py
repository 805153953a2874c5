"""The port's control loops (controllers/) on every case of
tests/test_controllers.py: the replication manager's scale up and down
(unbound pods first, then the newest), its no-op steady state and the
replacement of failed pods, the pod control's creates and deletes and
its refusal of a template without labels; the endpoints controller's
endpoints, its elided no-op write, the protocol change and the pods
without an IP; the node controller's registration, conditions and
evictions; the namespace controller's drain; the quota controller's
usage and its elided no-op write — each against the port's in-process
master."""

from test_torch_twin import port_twin

globals().update(port_twin("test_controllers"))
