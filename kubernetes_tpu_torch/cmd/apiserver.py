"""kube-apiserver binary (ref: cmd/kube-apiserver/app/server.go:107-153).

Port of ``kubernetes_tpu/cmd/apiserver.py``: the store the reference
picks (``--store-server`` a ``RemoteStore`` of a kube-store process, else
``--data-dir`` a ``DurableStore``, or a ``DurableStripedStore`` with
``--store-shards`` > 1, else ``--store-shards`` > 1 a ``StripedStore``,
else the in-memory ``MemStore``), the default admission chain,
kube-fairshed (``--no-fairshed`` turns it off), the share segment of an
SO_REUSEPORT worker fleet (``--share-seg``/``--share-worker``: the frame
seeds and fairshed's cross-worker ledger), token, basic and ABAC
authorization files, CORS, the watch lag bound, the rate-limited
read-only port, ``--trace``, ``--flightrec`` and ``--cloud-provider``
(a provider of ``cloudprovider/`` for the services' external load
balancers; an unknown name gives no cloud, as in the reference).
``python -m kubernetes_tpu_torch.cmd.apiserver --port 8080``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["apiserver_server", "main"]

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-apiserver", exit_on_error=False)
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--portal-net", "--portal_net", default="10.0.0.0/24")
    # default shared with apiserver.master.DEFAULT_ADMISSION — a plugin
    # added to the in-process default (PriorityDefault was the incident:
    # priorityClassName silently unresolved in the multi-process
    # topology) must ship in the binary's default too
    from kubernetes_tpu_torch.apiserver.master import DEFAULT_ADMISSION
    p.add_argument("--admission-control", "--admission_control",
                   default=",".join(DEFAULT_ADMISSION))
    p.add_argument("--token-auth-file", "--token_auth_file", default="")
    p.add_argument("--basic-auth-file", "--basic_auth_file", default="")
    p.add_argument("--authorization-policy-file",
                   "--authorization_policy_file", default="")
    p.add_argument("--cloud-provider", "--cloud_provider", default="")
    p.add_argument("--event-ttl", "--event_ttl", type=float, default=3600.0)
    p.add_argument("--kubelet-port", "--kubelet_port", type=int, default=10250)
    p.add_argument("--data-dir", "--data_dir", default="",
                   help="persist cluster state here (WAL + snapshots); "
                        "empty = in-memory only (the etcd_servers analog: "
                        "ref cmd/kube-apiserver/app/server.go etcd flags)")
    p.add_argument("--store-server", "--store_server", default="",
                   help="HOST:PORT of a kube-store process to use instead "
                        "of an in-process store (the --etcd_servers "
                        "analog); lets several apiserver workers share one "
                        "store")
    p.add_argument("--store-shards", "--store_shards", type=int, default=1,
                   help="kube-stripe: shard the in-process store's "
                        "keyspace by namespace hash into this many shards "
                        "(power of two). Ignored with --store-server (the "
                        "kube-store process takes --shards itself); 1 = "
                        "the unsharded twin.")
    p.add_argument("--allow-privileged", "--allow_privileged",
                   action="store_true",
                   help="if set, allow containers to request privileged "
                        "mode (ref: the reference's --allow_privileged)")
    p.add_argument("--cors-allowed-origins", "--cors_allowed_origins",
                   default="",
                   help="comma-separated allowed CORS origins; each entry "
                        "is a regular expression matched against the ENTIRE "
                        "Origin header (anchored fullmatch — "
                        "'https://example\\.com' does NOT admit "
                        "'https://example.com.evil.net'; use an explicit "
                        "'.*\\.example\\.com' style pattern for subdomains). "
                        "Empty disables CORS (ref: the reference's "
                        "--cors_allowed_origins)")
    p.add_argument("--read-only-port", "--read_only_port", type=int,
                   default=0,
                   help="serve a GET-only, unauthenticated, rate-limited "
                        "companion port (the kubernetes-ro backend; the "
                        "reference defaults it to 7080). 0 disables.")
    p.add_argument("--api-rate", "--api_rate", type=float, default=10.0,
                   help="read-only port rate limit, QPS")
    p.add_argument("--api-burst", "--api_burst", type=int, default=200,
                   help="read-only port burst size")
    p.add_argument("--reuse-port", "--reuse_port", action="store_true",
                   help="bind with SO_REUSEPORT so several apiserver "
                        "worker processes share one listen port")
    p.add_argument("--watch-lag-limit", "--watch_lag_limit", type=int,
                   default=65536,
                   help="per-watch-connection event queue bound: a "
                        "watcher lagging past it is dropped to resync "
                        "(410 ERROR frame; the client re-lists). "
                        "0 disables.")
    p.add_argument("--fairshed", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="kube-fairshed flow-classified admission "
                        "(docs/design/apiserver-hotpath.md): every "
                        "request rides an isolated per-flow inflight "
                        "budget (system / workload / best-effort) and "
                        "excess sheds with 429 + a measured-drain "
                        "Retry-After. Default budgets are generous "
                        "enough to be invisible below overload; "
                        "--no-fairshed disables the layer entirely.")
    p.add_argument("--fairshed-backlog", "--fairshed_backlog", type=int,
                   default=0,
                   help="workload backlog governor: shed pod creates "
                        "once created-but-unbound pods exceed this, "
                        "with Retry-After derived from the measured "
                        "bind drain rate — bounds the invisible e2e "
                        "backlog queue under overload. 0 disables. "
                        "Exact at one worker by construction; an "
                        "SO_REUSEPORT fleet stays exact through the "
                        "--share-seg cross-worker ledger.")
    p.add_argument("--share-seg", "--share_seg", default="",
                   help="path to a kube-share segment file "
                        "(apiserver/share.py), created by the parent/"
                        "harness with one block per worker: cross-"
                        "process frame-cache seeding + the cross-worker "
                        "fairshed backlog ledger. Empty disables.")
    p.add_argument("--share-worker", "--share_worker", type=int, default=-1,
                   help="this worker's block index in --share-seg "
                        "(0-based; required with --share-seg)")
    p.add_argument("--trace", action="store_true",
                   help="kube-trace: record handler/store spans for "
                        "requests carrying an X-KTPU-Trace header (a "
                        "scheduler wave's commit leg); drain via "
                        "GET /debug/trace. Default OFF — untraced "
                        "requests never record.")
    p.add_argument("--flightrec", action="store_true",
                   help="kube-flightrec: sample every metric series into "
                        "the per-process (monotonic_ns, value) ring from "
                        "boot, served incrementally at GET /debug/vars. "
                        "Default OFF (lazy: the first /debug/vars pull "
                        "arms sampling anyway; this flag just makes the "
                        "rings span the whole run).")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=1.0, help="flight recorder sample period, "
                        "seconds")
    return p


def build_server(opts, ready_event: Optional[threading.Event] = None):
    from kubernetes_tpu_torch.apiserver.http import APIServer
    from kubernetes_tpu_torch.apiserver.master import Master, MasterConfig
    from kubernetes_tpu_torch.cloudprovider import get_provider

    from kubernetes_tpu_torch import auth as authpkg
    from kubernetes_tpu_torch import capabilities

    # per-binary capability gate (ref: cmd server.go:186 + capabilities.go):
    # validation consults it when admitting privileged containers
    capabilities.setup(getattr(opts, "allow_privileged", False))

    authenticators = []
    if opts.token_auth_file:
        with open(opts.token_auth_file) as f:
            authenticators.append(authpkg.load_token_file(f.read()))
    if opts.basic_auth_file:
        with open(opts.basic_auth_file) as f:
            authenticators.append(authpkg.BasicAuthAuthenticator(
                authpkg.load_password_file(f.read())))
    authenticator = (authpkg.UnionAuthenticator(*authenticators)
                     if authenticators else None)
    authorizer = None
    if opts.authorization_policy_file:
        from kubernetes_tpu_torch.auth.abac import ABACAuthorizer
        with open(opts.authorization_policy_file) as f:
            authorizer = ABACAuthorizer.from_text(f.read())

    store = None
    store_shards = getattr(opts, "store_shards", 1)
    if getattr(opts, "store_server", ""):
        from kubernetes_tpu_torch.storage.remote import RemoteStore
        store = RemoteStore(opts.store_server)
    elif getattr(opts, "data_dir", ""):
        if store_shards > 1:
            from kubernetes_tpu_torch.storage.stripestore import DurableStripedStore
            store = DurableStripedStore(opts.data_dir, shards=store_shards)
        else:
            from kubernetes_tpu_torch.storage.durable import DurableStore
            store = DurableStore(opts.data_dir)
    elif store_shards > 1:
        from kubernetes_tpu_torch.storage.stripestore import StripedStore
        store = StripedStore(shards=store_shards)

    master = Master(MasterConfig(
        store=store,
        portal_net=opts.portal_net,
        admission_control=tuple(
            x for x in opts.admission_control.split(",") if x),
        authorizer=authorizer,
        event_ttl_seconds=opts.event_ttl,
        cloud=get_provider(opts.cloud_provider) if opts.cloud_provider else None,
    ))
    cors = [o for o in
            getattr(opts, "cors_allowed_origins", "").split(",") if o]
    share = ledger = None
    if getattr(opts, "share_seg", ""):
        from kubernetes_tpu_torch.apiserver.share import ShareSegment, SharedLedger
        share = ShareSegment(opts.share_seg,
                             worker_index=getattr(opts, "share_worker", -1))
        ledger = SharedLedger(share)
    fs = None
    if getattr(opts, "fairshed", True):
        from kubernetes_tpu_torch.apiserver.fairshed import FairShed
        fs = FairShed(backlog_limit=getattr(opts, "fairshed_backlog", 0),
                      ledger=ledger)
    srv = APIServer(master, host=opts.address, port=opts.port,
                    authenticator=authenticator,
                    kubelet_port=opts.kubelet_port,
                    reuse_port=getattr(opts, "reuse_port", False),
                    cors_allowed_origins=cors,
                    watch_lag_limit=getattr(opts, "watch_lag_limit", 65536),
                    fairshed=fs, share=share)
    ro_port = getattr(opts, "read_only_port", 0)
    if ro_port:
        # the kubernetes-ro companion (ref: cmd server.go:267-276):
        # GET-only, unauthenticated, token-bucket throttled, same master
        from kubernetes_tpu_torch.util.throttle import TokenBucketRateLimiter
        srv.read_only_server = APIServer(
            master, host=opts.address, port=ro_port,
            kubelet_port=opts.kubelet_port,
            cors_allowed_origins=cors,
            reuse_port=getattr(opts, "reuse_port", False),
            read_only=True,
            rate_limiter=TokenBucketRateLimiter(opts.api_rate,
                                                opts.api_burst))
    return srv


def apiserver_server(argv: List[str],
                     ready: Optional[threading.Event] = None,
                     stop: Optional[threading.Event] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if getattr(opts, "trace", False):
        from kubernetes_tpu_torch.util import tracing
        tracing.enable("apiserver")
    srv = build_server(opts)
    if getattr(opts, "flightrec", False):
        from kubernetes_tpu_torch.util import metrics as metrics_pkg
        metrics_pkg.flightrec_arm(
            "apiserver", period_s=getattr(opts, "flightrec_period", 1.0))
        metrics_pkg.flightrec_watch(srv.metrics_registry)
    srv.start()
    print(f"kube-apiserver listening on {srv.base_url}", file=sys.stderr)
    ro = getattr(srv, "read_only_server", None)
    if ro is not None:
        ro.start()
        print(f"read-only (kubernetes-ro) listening on {ro.base_url}",
              file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    if ro is not None:
        ro.stop()
    srv.stop()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return apiserver_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
