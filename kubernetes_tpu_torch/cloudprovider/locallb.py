"""LocalLBCloud — a provider whose TCPLoadBalancer facet actually
balances.

Port of ``kubernetes_tpu/cloudprovider/locallb.py``.

Third real provider, exercising the one Interface facet the inventory
and probe providers leave unsupported (ref: pkg/cloudprovider/cloud.go
TCPLoadBalancer; GCE implements it by programming a forwarding rule
from <lb>:port to every minion, where the service proxy answers on the
service port — pkg/cloudprovider/gce/gce.go CreateTCPLoadBalancer).
Here the "forwarding rule" is real software: ``create_tcp_load_balancer``
binds a listening socket on the balancer address and forwards each
accepted connection to one of the registered hosts at the SAME port,
round-robin with failover — exactly the reference's wire contract,
relayed the same way this repo's userspace service proxy relays
(proxy/proxier.py) instead of calling a cloud API.

Semantics mirrored from the reference:
- create(name, region, external_ip, port, hosts): bring up the listener
  (external_ip empty -> the provider's bind address); idempotent per
  (name, region) only via delete+create, like GCE forwarding rules.
- update(name, region, hosts): atomically replace the backend set; live
  connections keep their backend, new connections see the new set.
- get(name, region) -> (host, exists).
- delete(name, region): close the listener and every live connection;
  deleting an absent balancer is a no-op (rest.go logs and continues).
"""

from __future__ import annotations

import select
import socket
import threading
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.cloudprovider.cloud import (Interface, TCPLoadBalancer,
                                                Zone, Zones,
                                                register_provider)

__all__ = ["LocalLBCloud"]


class _Forwarder:
    """One balancer: listener + per-connection bidirectional pumps."""

    def __init__(self, bind_host: str, port: int, hosts: List[str]):
        self._lock = threading.Lock()
        self._hosts = list(hosts)
        self._rr = 0
        self._closed = threading.Event()
        self._conns: set = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind_host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"locallb-{self.port}").start()

    def set_hosts(self, hosts: List[str]) -> None:
        with self._lock:
            self._hosts = list(hosts)
            self._rr = 0

    def _pick_hosts(self) -> List[str]:
        """Backends in round-robin-rotated order (try-next failover)."""
        with self._lock:
            if not self._hosts:
                return []
            start = self._rr % len(self._hosts)
            self._rr += 1
            return self._hosts[start:] + self._hosts[:start]

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                client, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(client,),
                             daemon=True).start()

    def _serve(self, client: socket.socket) -> None:
        backend = None
        for host in self._pick_hosts():
            try:
                backend = socket.create_connection((host, self.port),
                                                   timeout=5)
                break
            except OSError:
                continue
        if backend is None:
            client.close()
            return
        with self._lock:
            self._conns.add(client)
            self._conns.add(backend)
        try:
            # re-check AFTER registering: close() may have snapshotted
            # _conns while this connection was still dialing its backend
            # — a deleted balancer must not keep relaying
            if self._closed.is_set():
                return
            self._pump(client, backend)
        finally:
            with self._lock:
                self._conns.discard(client)
                self._conns.discard(backend)
            for s in (client, backend):
                try:
                    s.close()
                except OSError:
                    pass

    @staticmethod
    def _pump(a: socket.socket, b: socket.socket) -> None:
        """Bidirectional copy: select for readiness, BLOCKING sendall for
        backpressure — the userspace proxy's relay pattern
        (proxy/proxier.py _TCPProxy._relay; a non-blocking sendall would
        drop data mid-write the moment the peer's buffer fills). Unlike
        the proxy's relay this forwards half-closes instead of tearing
        down on the first EOF: an LB client may SHUT_WR after its
        request and still expect the response."""
        peer = {a: b, b: a}
        socks = [a, b]
        while socks:
            readable, _, _ = select.select(socks, [], [], 60.0)
            for sock in readable:
                try:
                    data = sock.recv(1 << 16)
                except OSError:
                    return
                if not data:
                    try:
                        peer[sock].shutdown(socket.SHUT_WR)
                    except OSError:
                        return
                    socks.remove(sock)
                    continue
                try:
                    peer[sock].sendall(data)
                except OSError:
                    return

    def close(self) -> None:
        self._closed.set()
        # shutdown BEFORE close: the accept thread parked on this socket
        # holds the fd, so a bare close() would leave the listener able
        # to accept one more connection after "deletion"
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.close()
            except OSError:
                pass


class LocalLBCloud(Interface, TCPLoadBalancer, Zones):
    """Interface wiring: TCPLoadBalancer (real) + Zones (static)."""

    def __init__(self, bind_host: str = "127.0.0.1",
                 zone: Optional[Zone] = None):
        self.bind_host = bind_host
        self.zone = zone or Zone("local", "local")
        self._lock = threading.Lock()
        self._lbs: Dict[Tuple[str, str], _Forwarder] = {}

    # -- Interface ----------------------------------------------------------
    def tcp_load_balancer(self) -> Optional[TCPLoadBalancer]:
        return self

    def zones(self) -> Optional[Zones]:
        return self

    def get_zone(self) -> Zone:
        return self.zone

    # -- TCPLoadBalancer ----------------------------------------------------
    def get_tcp_load_balancer(self, name: str, region: str):
        with self._lock:
            fwd = self._lbs.get((name, region))
        return (fwd.host if fwd else "", fwd is not None)

    def create_tcp_load_balancer(self, name: str, region: str,
                                 external_ip: str, port: int,
                                 hosts: List[str]) -> None:
        with self._lock:
            # existence check BEFORE binding: a second create for the
            # same (name, region) must fail the contract's way, not with
            # the bind's EADDRINUSE; a failed bind inserts nothing
            if (name, region) in self._lbs:
                raise ValueError(
                    f"load balancer {name!r} already exists in {region!r}")
            self._lbs[(name, region)] = _Forwarder(
                external_ip or self.bind_host, port, hosts)

    def update_tcp_load_balancer(self, name: str, region: str,
                                 hosts: List[str]) -> None:
        with self._lock:
            fwd = self._lbs.get((name, region))
        if fwd is None:
            raise KeyError(f"no load balancer {name!r} in {region!r}")
        fwd.set_hosts(hosts)

    def delete_tcp_load_balancer(self, name: str, region: str) -> None:
        with self._lock:
            fwd = self._lbs.pop((name, region), None)
        if fwd is not None:
            fwd.close()

register_provider("locallb", LocalLBCloud)
