"""Single-process demo cluster (ref: cmd/kubernetes/kubernetes.go:183 —
"a testing binary that runs every component in one process").

Starts: HTTP apiserver + controller manager + scheduler + N kubelets (fake
runtime) with their read-only servers, all against one in-memory store.
``--algorithm tpu-batch`` solves each wave with ``commit_solve`` on
``--device`` (``cuda`` by default, which raises without a card; ``cpu``
runs the kernel's plain version).

Port of ``kubernetes_tpu/cmd/standalone.py``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["standalone_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubernetes", exit_on_error=False)
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--nodes", type=int, default=2)
    p.add_argument("--algorithm", default="serial",
                   choices=["serial", "tpu-batch"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="tpu-batch: where each wave solves")
    return p


def standalone_server(argv: List[str],
                      ready: Optional[threading.Event] = None,
                      stop: Optional[threading.Event] = None) -> int:
    from kubernetes_tpu_torch.apiserver.http import APIServer
    from kubernetes_tpu_torch.cluster import Cluster, ClusterConfig

    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cluster = Cluster(ClusterConfig(
        num_nodes=opts.nodes, kubelet_http=True,
        batch_scheduler=opts.algorithm == "tpu-batch",
        device=opts.device)).start()
    srv = APIServer(cluster.master, host=opts.address, port=opts.port,
                    node_locator=cluster.node_locator).start()
    print(f"kubernetes standalone: apiserver {srv.base_url}, "
          f"{opts.nodes} nodes", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    srv.stop()
    cluster.stop()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return standalone_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
