"""kube-controller-manager binary
(ref: cmd/kube-controller-manager/app/controllermanager.go:138-187).

Port of ``kubernetes_tpu/cmd/controller_manager.py``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["controller_manager_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-controller-manager",
                                exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080")
    p.add_argument("--cloud-provider", "--cloud_provider", default="")
    p.add_argument("--minion-regexp", "--minion_regexp", default=".*")
    p.add_argument("--machines", default="",
                   help="comma-separated static node names")
    p.add_argument("--node-sync-period", "--node_sync_period",
                   type=float, default=10.0)
    p.add_argument("--pod-eviction-timeout", "--pod_eviction_timeout",
                   type=float, default=300.0)
    p.add_argument("--node-cpu", default="4", help="static node cpu capacity")
    p.add_argument("--node-memory", default="8Gi",
                   help="static node memory capacity")
    return p


def build_manager(opts):
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cloudprovider import get_provider
    from kubernetes_tpu_torch.controllers.manager import (ControllerManager,
                                                    ControllerManagerConfig)

    if opts.machines and opts.cloud_provider:
        raise ValueError("--machines and --cloud-provider are mutually "
                         "exclusive (static list vs cloud discovery)")
    client = Client(HTTPTransport(opts.master, user_agent="kube-controller-manager"))
    static_nodes = [
        api.Node(metadata=api.ObjectMeta(name=name),
                 spec=api.NodeSpec(capacity={
                     api.ResourceCPU: Quantity(opts.node_cpu),
                     api.ResourceMemory: Quantity(opts.node_memory)}))
        for name in opts.machines.split(",") if name]
    return ControllerManager(client, ControllerManagerConfig(
        node_sync_period=opts.node_sync_period,
        pod_eviction_timeout=opts.pod_eviction_timeout,
        static_nodes=static_nodes,
        cloud=get_provider(opts.cloud_provider) if opts.cloud_provider else None,
        match_re=opts.minion_regexp))


def controller_manager_server(argv: List[str],
                              ready: Optional[threading.Event] = None,
                              stop: Optional[threading.Event] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
        manager = build_manager(opts)
    except (argparse.ArgumentError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    manager.run()
    print("kube-controller-manager running", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    manager.stop()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return controller_manager_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
