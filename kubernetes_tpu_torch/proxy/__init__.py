"""Service data plane — userspace L4 proxy (ref: pkg/proxy/).

- ``roundrobin`` — LoadBalancerRR endpoint selection with session affinity
- ``proxier``    — per-service listener sockets relaying to endpoints
- ``config``     — watch-driven service/endpoints config distribution

Port of ``kubernetes_tpu/proxy/__init__.py``.
"""

from kubernetes_tpu_torch.proxy.proxier import Proxier  # noqa: F401
from kubernetes_tpu_torch.proxy.roundrobin import LoadBalancerRR  # noqa: F401
