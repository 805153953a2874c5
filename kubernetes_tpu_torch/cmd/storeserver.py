"""kube-store — the cluster store as its own server process.

Port of ``kubernetes_tpu/cmd/storeserver.py``.

The reference does not ship this binary because it delegates the role to
etcd (ref: DESIGN.md:17 "all persistent master state is stored in etcd";
cmd/kube-apiserver flags --etcd_servers). This is that missing process
for the rebuild: it owns the one MemStore/DurableStore and serves it to
any number of apiserver workers over the RemoteStore protocol.

kube-chaos (docs/design/ha.md) grew it an observability sidecar:
``--metrics-port`` serves /healthz (recovery disclosure: replayed
records, snapshot age, recovery wall time — the numbers that make
"bounded recovery" a measured claim), /metrics (the ``store_wal_*``
family), and /debug/vars (flightrec), so a respawned kube-store proves
what its recovery cost instead of silently replaying.

Usage: python -m kubernetes_tpu_torch.cmd.storeserver [--port 2379]
           [--data-dir DIR] [--fsync] [--compact-every N]
           [--metrics-port PORT] [--flightrec]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

__all__ = ["main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-store", exit_on_error=False)
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2379)  # etcd's port, homage
    p.add_argument("--data-dir", "--data_dir", default="",
                   help="persist state here (WAL + snapshots); empty = "
                        "in-memory only")
    p.add_argument("--fsync", action="store_true",
                   help="fsync(2) every WAL group commit (media-crash "
                        "durability; default flush-only survives process "
                        "kill)")
    p.add_argument("--compact-every", "--compact_every", type=int,
                   default=10_000,
                   help="snapshot + truncate the WAL every N records")
    p.add_argument("--shards", type=int, default=1,
                   help="kube-stripe: shard the keyspace by namespace "
                        "hash into this many shards (power of two; per-"
                        "shard locks, rings, and watcher lists under one "
                        "global revision counter). 1 = the unsharded "
                        "MemStore/DurableStore twin.")
    p.add_argument("--max-inflight", "--max_inflight", type=int, default=0,
                   help="kube-fairshed overload valve: shed ops past "
                        "this many concurrent dispatches with a "
                        "retryable ErrTooManyRequests + measured-drain "
                        "retry_after hint (RemoteStore honors it "
                        "transparently). 0 disables.")
    p.add_argument("--metrics-port", "--metrics_port", type=int, default=0,
                   help="serve /metrics, /healthz (recovery disclosure) "
                        "and /debug/vars on this port (0 disables)")
    p.add_argument("--flightrec", action="store_true",
                   help="kube-flightrec: sample every metric series into "
                        "the per-process ring from boot (served at "
                        "GET /debug/vars on --metrics-port)")
    p.add_argument("--flightrec-period", "--flightrec_period", type=float,
                   default=1.0, help="flight recorder sample period, "
                        "seconds")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from kubernetes_tpu_torch.storage.remote import StoreServer

    if opts.shards > 1:
        if opts.data_dir:
            from kubernetes_tpu_torch.storage.stripestore import DurableStripedStore
            store = DurableStripedStore(
                opts.data_dir, shards=opts.shards, fsync=opts.fsync,
                compact_every=opts.compact_every)
        else:
            from kubernetes_tpu_torch.storage.stripestore import StripedStore
            store = StripedStore(shards=opts.shards)
    elif opts.data_dir:
        from kubernetes_tpu_torch.storage.durable import DurableStore
        store = DurableStore(opts.data_dir, fsync=opts.fsync,
                             compact_every=opts.compact_every)
    else:
        from kubernetes_tpu_torch.storage.memstore import MemStore
        store = MemStore()
    if opts.flightrec:
        from kubernetes_tpu_torch.util import metrics as metrics_pkg
        metrics_pkg.flightrec_arm(
            "storeserver", period_s=opts.flightrec_period)
    if opts.metrics_port:
        from kubernetes_tpu_torch import probe
        from kubernetes_tpu_torch.cmd.scheduler import _serve_debug

        def health():
            payload = {
                "kind": "ComponentStatusList", "healthy": True,
                "items": [{"name": "store", "status": probe.SUCCESS,
                           "message": f"{type(store).__name__} serving "
                                      f"index {store.index}"}],
            }
            recovery = getattr(store, "recovery", None)
            if recovery is not None:
                payload["recovery"] = dict(recovery)
                payload["data_dir"] = opts.data_dir
            return payload, True

        _serve_debug(opts.metrics_port, service="storeserver",
                     health=health)
    srv = StoreServer(store, host=opts.address, port=opts.port,
                      max_inflight=opts.max_inflight)
    # the "listening" line FIRST — harness readiness checks key on it;
    # the recovery disclosure follows (and stays on /healthz forever)
    print(f"kube-store listening on {srv.address}", flush=True)
    recovery = getattr(store, "recovery", None)
    if recovery is not None:
        print(f"kube-store recovered {opts.data_dir}: "
              f"{recovery['replayed_records']} WAL records "
              f"({recovery['replayed_ops']} ops) replayed in "
              f"{recovery['recovery_s']}s, snapshot "
              + (f"age {recovery['snapshot_age_s']}s"
                 if recovery["snapshot"] else "absent")
              + (f", torn tail {recovery['torn_bytes']}B discarded"
                 if recovery["torn_bytes"] else ""), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
