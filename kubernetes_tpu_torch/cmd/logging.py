"""cluster-logging binary — the fluentd-elasticsearch-analog aggregator
(ref: cluster/addons/fluentd-elasticsearch deployment).

Port of ``kubernetes_tpu/cmd/logging.py``.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import List, Optional

__all__ = ["logging_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cluster-logging", exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080",
                   help="apiserver URL")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10252)
    p.add_argument("--kubelet-port", "--kubelet_port", type=int,
                   default=10250)
    p.add_argument("--period", type=float, default=2.0,
                   help="log tail period seconds")
    p.add_argument("--max-records", "--max_records", type=int,
                   default=100_000, help="retention ring size")
    return p


def logging_server(argv: List[str],
                   ready: Optional[threading.Event] = None,
                   stop: Optional[threading.Event] = None) -> int:
    from kubernetes_tpu_torch.addons.logging import (LogAggregator,
                                               http_kubelet_log_fetcher)
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport

    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    client = Client(HTTPTransport(opts.master))
    agg = LogAggregator(client,
                        fetch=http_kubelet_log_fetcher(opts.kubelet_port),
                        period_s=opts.period, max_records=opts.max_records,
                        host=opts.address, port=opts.port).start()
    print(f"cluster-logging on http://{opts.address}:{agg.port} "
          f"(/logs, /metrics)", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    agg.stop()
    return 0


def main() -> int:
    return logging_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
