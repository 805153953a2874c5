"""The port's cloud and credential providers (cloudprovider/,
credentialprovider/) on every case of tests/test_cloudprovider.py: the
provider registry, the local and fake clouds, the node controller's
cloud sync (registration, departure with its pods, the name filter), the
service registry's external load balancer and its rollback, the docker
keyring (the auth round trip, both config shapes, longest and
segment-bounded matches, Docker Hub for bare images, the env and file
providers), and the local balancer over real sockets (round robin,
failover, the backend swap, delete, and a large transfer to a slow
reader), with the reference's timeouts."""

from test_torch_twin import port_twin

globals().update(port_twin("test_cloudprovider"))
