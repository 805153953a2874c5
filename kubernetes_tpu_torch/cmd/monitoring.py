"""cluster-monitoring binary — the heapster-analog aggregator
(ref: cluster/addons/cluster-monitoring deployment), grown into the
kube-flightrec control-plane aggregator: with ``--flightrec-target``
it also pulls every named process's /debug/vars metric time-series
shard, merges them on the shared monotonic axis, evaluates the churn
SLO rule set live, and serves the merged timeline + alarm transitions
at /api/v1/timeline and /api/v1/alarms.

Port of ``kubernetes_tpu/cmd/monitoring.py``.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import List, Optional

__all__ = ["monitoring_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cluster-monitoring",
                                exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080",
                   help="apiserver URL")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10251)
    p.add_argument("--kubelet-port", "--kubelet_port", type=int,
                   default=10250)
    p.add_argument("--period", type=float, default=5.0,
                   help="scrape period seconds")
    p.add_argument("--flightrec-target", "--flightrec_target",
                   action="append", default=[],
                   help="NAME=URL[,WORKERS] of a control-plane process "
                        "debug server to pull /debug/vars from "
                        "(repeatable; WORKERS>1 = SO_REUSEPORT worker "
                        "processes sharing the URL's port, each poll "
                        "drains until all pids answered). E.g. "
                        "apiserver=http://127.0.0.1:8080,4")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=2.0, help="flightrec pull period seconds")
    return p


def parse_flightrec_targets(specs: List[str]) -> List[dict]:
    out = []
    for spec in specs:
        name, _, rest = spec.partition("=")
        url, _, workers = rest.partition(",")
        if not name or not url:
            raise ValueError(f"bad --flightrec-target {spec!r} "
                             "(want NAME=URL[,WORKERS])")
        out.append({"name": name, "url": url,
                    "workers": int(workers) if workers else 1})
    return out


def monitoring_server(argv: List[str],
                      ready: Optional[threading.Event] = None,
                      stop: Optional[threading.Event] = None) -> int:
    from kubernetes_tpu_torch.addons.monitoring import (
        Monitoring,
        http_kubelet_fetcher,
    )
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport

    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    client = Client(HTTPTransport(opts.master))
    mon = Monitoring(client, fetch=http_kubelet_fetcher(opts.kubelet_port),
                     period_s=opts.period, host=opts.address,
                     port=opts.port)
    flight = None
    if opts.flightrec_target:
        from kubernetes_tpu_torch.addons.monitoring import FlightAggregator
        try:
            targets = parse_flightrec_targets(opts.flightrec_target)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        flight = FlightAggregator(targets,
                                  period_s=opts.flightrec_period).start()
        mon.flight = flight
    mon.start()
    print(f"cluster-monitoring on http://{opts.address}:{mon.port} "
          f"(/metrics, /api/v1/model"
          + (", /api/v1/timeline, /api/v1/alarms" if flight else "")
          + ")", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    if flight is not None:
        flight.stop(final_poll=False)
    mon.stop()
    return 0


def main() -> int:
    return monitoring_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
