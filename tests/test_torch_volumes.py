"""The port's volume plugins (volume/) on every case of
tests/test_volumes.py: empty dirs, host paths, secrets, git repos, NFS
and persistent disks through their mounters, the plugin manager and the
kubelet's mount and teardown of a pod's volumes."""

from test_torch_twin import port_twin

globals().update(port_twin("test_volumes"))
