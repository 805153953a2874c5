"""kube-descheduler binary — the kube-defrag wave loop as its own process.

Mirrors cmd/scheduler.py's server shape (build_parser -> build ->
server(argv, ready, stop)) so hack/churn_mp.py and the hyperkube-style
launchers drive it identically. The descheduler is strictly off the
scheduler hot path: its own client, its own user-agent (rides the
apiserver's system flow like the scheduler), its own wave-loop thread.

Port of ``kubernetes_tpu/cmd/descheduler.py``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["descheduler_server", "build_descheduler", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-descheduler", exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080")
    p.add_argument("--period", type=float, default=5.0,
                   help="wave loop tick, seconds")
    p.add_argument("--qps", type=float, default=0.2,
                   help="token-bucket wave rate (waves/second)")
    p.add_argument("--burst", type=int, default=1,
                   help="token-bucket burst (waves a quiet period banks)")
    p.add_argument("--max-moves", "--max_moves", type=int, default=50,
                   help="voluntary migrations per wave (whole source "
                        "nodes at a time; drains are not budget-limited)")
    p.add_argument("--source-max-permille", "--source_max_permille",
                   type=int, default=700,
                   help="only nodes below this summed core-dim "
                        "used-permille may be voluntary sources")
    p.add_argument("--protected-namespaces", "--protected_namespaces",
                   default="kube-system",
                   help="comma-separated namespaces whose pods are never "
                        "moved")
    p.add_argument("--always-defrag", "--always_defrag",
                   action="store_true",
                   help="solve even while unbound pods exist (default: "
                        "decline the wave — the scheduler owns the churn "
                        "budget while work is pending)")
    p.add_argument("--one-shot", "--one_shot", action="store_true",
                   help="run exactly one wave (ignoring the token "
                        "bucket), print its report as JSON, exit")
    p.add_argument("--metrics-port", "--metrics_port", type=int, default=0,
                   help="serve /metrics, /healthz and /debug/* on this "
                        "port (0 disables)")
    p.add_argument("--flightrec", action="store_true",
                   help="kube-flightrec: sample every metric series from "
                        "boot (see cmd/scheduler.py --flightrec)")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=1.0)
    return p


def build_descheduler(opts):
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.descheduler import Descheduler, DeschedulerConfig
    from kubernetes_tpu_torch.models.defrag import DefragConfig

    client = Client(HTTPTransport(opts.master,
                                  user_agent="kube-descheduler"))
    cfg = DeschedulerConfig(
        period_s=opts.period, qps=opts.qps, burst=opts.burst,
        decline_on_pending=not opts.always_defrag,
        defrag=DefragConfig(
            max_moves=opts.max_moves,
            source_max_permille=opts.source_max_permille,
            protected_namespaces=tuple(
                ns for ns in opts.protected_namespaces.split(",") if ns)))
    return Descheduler(client, cfg)


def _descheduler_health(master: str):
    import urllib.parse

    from kubernetes_tpu_torch import probe

    def health():
        u = urllib.parse.urlparse(master)
        st, msg = probe.probe_http(u.hostname, u.port, "/healthz/ping")
        ok = st == probe.SUCCESS
        return ({"kind": "ComponentStatusList", "healthy": ok,
                 "items": [{"name": "apiserver", "status": st,
                            "message": msg if not ok else
                            f"apiserver {master} reachable"}]}, ok)

    return health


def descheduler_server(argv: List[str],
                       ready: Optional[threading.Event] = None,
                       stop: Optional[threading.Event] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if opts.flightrec:
        from kubernetes_tpu_torch.util import metrics as metrics_pkg
        metrics_pkg.flightrec_arm("descheduler",
                                  period_s=opts.flightrec_period)
    d = build_descheduler(opts)
    if opts.metrics_port:
        from kubernetes_tpu_torch.cmd.scheduler import _serve_debug
        _serve_debug(opts.metrics_port, service="descheduler",
                     health=_descheduler_health(opts.master))
    if opts.one_shot:
        rep = d.run_once(force=True)
        json.dump({"declined": rep.declined, "error": rep.error,
                   "score_before": rep.score_before,
                   "score_mandatory": rep.score_mandatory,
                   "score_after": rep.score_after,
                   "proposed": rep.proposed, "committed": rep.committed,
                   "conflicts": rep.conflicts,
                   "voluntary_dropped": rep.voluntary_dropped,
                   "nodes_drained": rep.nodes_drained,
                   "nodes_emptied": rep.nodes_emptied,
                   "undrainable": rep.undrainable}, sys.stdout)
        sys.stdout.write("\n")
        return 0 if not rep.error else 1
    d.run()
    print("kube-descheduler running", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    d.stop()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return descheduler_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
