"""cluster-dns binary — the DNS addon as a standalone server
(ref: cluster/addons/dns: skydns + kube2sky deployment).

Port of ``kubernetes_tpu/cmd/dns.py``.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import List, Optional

__all__ = ["dns_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cluster-dns", exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080",
                   help="apiserver URL")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10053)
    p.add_argument("--domain", default="cluster.local")
    return p


def dns_server(argv: List[str],
               ready: Optional[threading.Event] = None,
               stop: Optional[threading.Event] = None) -> int:
    from kubernetes_tpu_torch.addons.dns import DNSServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport

    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    client = Client(HTTPTransport(opts.master))
    srv = DNSServer(client, host=opts.address, port=opts.port,
                    domain=opts.domain).start()
    print(f"cluster-dns serving {opts.domain} on udp://{srv.addr[0]}:"
          f"{srv.addr[1]}", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    srv.stop()
    return 0


def main() -> int:
    return dns_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
