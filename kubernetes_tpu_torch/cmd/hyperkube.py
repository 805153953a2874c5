"""hyperkube — every server in one binary (ref: cmd/hyperkube/main.go +
pkg/hyperkube). ``python -m kubernetes_tpu_torch.cmd.hyperkube <server> [flags]``.

Port of ``kubernetes_tpu/cmd/hyperkube.py``.
"""

from __future__ import annotations

import sys
from typing import List

__all__ = ["main", "SERVERS"]


def _apiserver(argv):
    from kubernetes_tpu_torch.cmd.apiserver import apiserver_server
    return apiserver_server(argv)


def _controller_manager(argv):
    from kubernetes_tpu_torch.cmd.controller_manager import controller_manager_server
    return controller_manager_server(argv)


def _scheduler(argv):
    from kubernetes_tpu_torch.cmd.scheduler import scheduler_server
    return scheduler_server(argv)


def _kubelet(argv):
    from kubernetes_tpu_torch.cmd.kubelet import kubelet_server
    return kubelet_server(argv)


def _proxy(argv):
    from kubernetes_tpu_torch.cmd.proxy import proxy_server
    return proxy_server(argv)


def _kubectl(argv):
    from kubernetes_tpu_torch.kubectl.cmd import main as kubectl_main
    return kubectl_main(argv)


def _standalone(argv):
    from kubernetes_tpu_torch.cmd.standalone import standalone_server
    return standalone_server(argv)


def _version_change(argv):
    from kubernetes_tpu_torch.cmd.version_change import version_change
    return version_change(argv)


def _solverd(argv):
    from kubernetes_tpu_torch.cmd.solverd import solverd_server
    return solverd_server(argv)


def _dns(argv):
    from kubernetes_tpu_torch.cmd.dns import dns_server
    return dns_server(argv)


def _monitoring(argv):
    from kubernetes_tpu_torch.cmd.monitoring import monitoring_server
    return monitoring_server(argv)


SERVERS = {
    "apiserver": _apiserver,
    "kube-apiserver": _apiserver,
    "controller-manager": _controller_manager,
    "kube-controller-manager": _controller_manager,
    "scheduler": _scheduler,
    "kube-scheduler": _scheduler,
    "kubelet": _kubelet,
    "proxy": _proxy,
    "kube-proxy": _proxy,
    "kubectl": _kubectl,
    "standalone": _standalone,
    "kubernetes": _standalone,
    "version-change": _version_change,
    "kube-version-change": _version_change,
    "solverd": _solverd,
    "kube-solverd": _solverd,
    "dns": _dns,
    "cluster-dns": _dns,
    "monitoring": _monitoring,
    "cluster-monitoring": _monitoring,
}


def main(argv: List[str] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help", "help"):
        names = ", ".join(sorted(set(SERVERS)))
        print(f"usage: hyperkube <server> [flags]\nservers: {names}",
              file=sys.stderr)
        return 0 if argv else 1
    server = SERVERS.get(argv[0])
    if server is None:
        print(f"error: unknown server {argv[0]!r}", file=sys.stderr)
        return 1
    return server(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
