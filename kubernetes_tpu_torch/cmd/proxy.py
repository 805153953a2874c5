"""kube-proxy binary (ref: cmd/kube-proxy/app/server.go:65).

Port of ``kubernetes_tpu/cmd/proxy.py``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

__all__ = ["proxy_server", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kube-proxy", exit_on_error=False)
    p.add_argument("--master", default="http://127.0.0.1:8080")
    p.add_argument("--bind-address", "--bind_address", default="127.0.0.1")
    p.add_argument("--real-iptables", action="store_true",
                   help="program real netfilter rules (needs root); default "
                        "uses the in-memory rule table")
    return p


def build_proxy(opts):
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.proxy.config import EndpointsConfig, ServiceConfig
    from kubernetes_tpu_torch.proxy.proxier import Proxier
    from kubernetes_tpu_torch.util.iptables import ExecIPTables, FakeIPTables

    client = Client(HTTPTransport(opts.master, user_agent="kube-proxy"))
    ipt = ExecIPTables() if opts.real_iptables else FakeIPTables()
    proxier = Proxier(listen_ip=opts.bind_address, iptables=ipt)
    svc_cfg = ServiceConfig(client, [proxier.on_update])
    ep_cfg = EndpointsConfig(client, [proxier.lb.on_update])
    return proxier, svc_cfg, ep_cfg


def proxy_server(argv: List[str],
                 ready: Optional[threading.Event] = None,
                 stop: Optional[threading.Event] = None) -> int:
    try:
        opts = build_parser().parse_args(argv)
    except argparse.ArgumentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    proxier, svc_cfg, ep_cfg = build_proxy(opts)
    svc_cfg.run()
    ep_cfg.run()
    sync = threading.Thread(target=proxier.sync_loop, daemon=True,
                            name="proxy-sync")
    sync.start()
    print("kube-proxy running", file=sys.stderr)
    if ready is not None:
        ready.set()
    stop = stop or threading.Event()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    svc_cfg.stop()
    ep_cfg.stop()
    proxier.stop()
    return 0


def main() -> int:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    return proxy_server(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
