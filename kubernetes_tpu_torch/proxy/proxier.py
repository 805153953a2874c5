"""Userspace L4 proxy (ref: pkg/proxy/proxier.go).

One listener socket per service; every accepted TCP connection is relayed
to an endpoint chosen by the load balancer (ref: tcpProxySocket.ProxyLoop
:91-151). UDP uses a single socket with a per-client activity map
(:166-266). Portal rules — the reference's iptables REDIRECT from
portalIP:port to the proxy port (:360-388) — go through the
``util.iptables`` seam so they're assertable without netfilter.

The reference spawns a goroutine per service + per connection; here each
service gets an accept thread and each connection a relay thread pair —
the same topology on OS threads (this is IO-bound; the GIL is released in
socket syscalls).

Port of ``kubernetes_tpu/proxy/proxier.py``.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import meta_namespace_key_func
from kubernetes_tpu_torch.proxy.roundrobin import (ErrMissingEndpoints,
                                             ErrMissingServiceEntry,
                                             LoadBalancerRR)
from kubernetes_tpu_torch.util import iptables as iptablespkg

__all__ = ["Proxier", "ServiceInfo"]

IPTABLES_PROXY_CHAIN = "KUBE-PROXY"  # ref: proxier.go iptablesProxyChain


@dataclass
class ServiceInfo:
    """ref: proxier.go serviceInfo."""

    name: str = ""                 # "namespace/name"
    portal_ip: str = ""
    portal_port: int = 0
    protocol: str = api.ProtocolTCP
    proxy_port: int = 0
    session_affinity: str = api.AffinityNone
    active: bool = True
    sock: Optional[socket.socket] = None
    thread: Optional[threading.Thread] = None


class _TCPProxy:
    """Accept loop + bidirectional relay (ref: tcpProxySocket :91-151)."""

    def __init__(self, proxier: "Proxier", info: ServiceInfo):
        self.proxier = proxier
        self.info = info

    def run(self) -> None:
        sock = self.info.sock
        while self.info.active:
            try:
                # select first: a close() from stop_proxy can't interrupt a
                # thread already blocked in accept(), and the blocked syscall
                # would keep the listening socket alive in the kernel
                ready, _, _ = select.select([sock], [], [], 0.5)
                if not ready:
                    continue
                client, addr = sock.accept()
            except (OSError, ValueError):
                return  # socket closed by stop_proxy
            try:
                backend = self.proxier.connect_to_backend(
                    self.info.name, addr[0], self.info.protocol)
            except (ErrMissingServiceEntry, ErrMissingEndpoints, OSError):
                client.close()
                continue
            t = threading.Thread(target=self._relay, args=(client, backend),
                                 daemon=True,
                                 name=f"proxy-conn-{self.info.name}")
            t.start()

    def _relay(self, client: socket.socket, backend: socket.socket) -> None:
        """io.Copy both ways (ref: proxyTCP :121-135). Idle connections are
        NOT killed — like the reference's io.Copy, only EOF/error ends the
        relay; the timeout exists solely to notice service shutdown."""
        socks = [client, backend]
        try:
            while True:
                readable, _, _ = select.select(socks, [], [], 5.0)
                if not readable:
                    if not self.info.active:
                        return
                    continue
                for s in readable:
                    other = backend if s is client else client
                    data = s.recv(65536)
                    if not data:
                        return
                    other.sendall(data)
        except OSError:
            pass
        finally:
            client.close()
            backend.close()


class _UDPProxy:
    """Single socket, per-client backend map with TTL
    (ref: udpProxySocket :166-266)."""

    CLIENT_TTL = 60.0  # ref: proxier.go udpIdleTimeout flag default scale

    def __init__(self, proxier: "Proxier", info: ServiceInfo):
        self.proxier = proxier
        self.info = info
        self.clients: Dict[Tuple[str, int], socket.socket] = {}
        self.last_seen: Dict[Tuple[str, int], float] = {}
        self.lock = threading.Lock()

    def run(self) -> None:
        sock = self.info.sock
        while self.info.active:
            try:
                ready, _, _ = select.select([sock], [], [], 0.5)
                if not ready:
                    continue
                data, addr = sock.recvfrom(65536)
            except (OSError, ValueError):
                break
            if addr is None:  # shutdown() makes recvfrom return (b'', None)
                break
            backend = self._backend_for(addr)
            if backend is None:
                continue
            try:
                backend.send(data)
            except OSError:
                with self.lock:
                    self.clients.pop(addr, None)
                    self.last_seen.pop(addr, None)
        self._close_all()

    def _backend_for(self, addr) -> Optional[socket.socket]:
        with self.lock:
            now = time.monotonic()
            sock = self.clients.get(addr)
            if sock is not None and \
                    now - self.last_seen.get(addr, 0) < self.CLIENT_TTL:
                self.last_seen[addr] = now
                return sock
            try:
                ep = self.proxier.lb.next_endpoint(self.info.name, addr[0])
            except (ErrMissingServiceEntry, ErrMissingEndpoints):
                return None
            host, _, port = ep.rpartition(":")
            try:
                backend = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                backend.connect((host, int(port)))
            except OSError:
                return None
            self.clients[addr] = backend
            self.last_seen[addr] = now
            t = threading.Thread(target=self._pump_back,
                                 args=(addr, backend), daemon=True)
            t.start()
            return backend

    def _pump_back(self, addr, backend: socket.socket) -> None:
        while self.info.active:
            try:
                backend.settimeout(self.CLIENT_TTL)
                data = backend.recv(65536)
            except OSError:
                break
            if not data:
                break
            try:
                self.info.sock.sendto(data, addr)
            except OSError:
                break
        with self.lock:
            if self.clients.get(addr) is backend:
                del self.clients[addr]
                self.last_seen.pop(addr, None)
        backend.close()

    def _close_all(self):
        with self.lock:
            for s in self.clients.values():
                s.close()
            self.clients.clear()
            self.last_seen.clear()


class Proxier:
    """ref: proxier.go Proxier — OnUpdate is the full-state service config
    hook; SyncLoop re-ensures portal rules periodically."""

    def __init__(self, lb: Optional[LoadBalancerRR] = None,
                 listen_ip: str = "127.0.0.1",
                 iptables: Optional[iptablespkg.IPTables] = None,
                 sync_period: float = 5.0):
        self.lb = lb or LoadBalancerRR()
        self.listen_ip = listen_ip
        self.iptables = iptables or iptablespkg.FakeIPTables()
        self.sync_period = sync_period
        self.service_map: Dict[str, ServiceInfo] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._init_iptables()

    # -- portal rules ------------------------------------------------------
    def _init_iptables(self) -> None:
        """ref: proxier.go iptablesInit:330-358."""
        ipt = self.iptables
        ipt.ensure_chain(iptablespkg.TableNAT, IPTABLES_PROXY_CHAIN)
        ipt.ensure_rule(iptablespkg.TableNAT, iptablespkg.ChainPrerouting,
                        "-j", IPTABLES_PROXY_CHAIN)
        ipt.ensure_rule(iptablespkg.TableNAT, iptablespkg.ChainOutput,
                        "-j", IPTABLES_PROXY_CHAIN)

    def _portal_args(self, info: ServiceInfo) -> tuple:
        """ref: proxier.go iptablesPortalArgs:390-423."""
        return ("-m", info.protocol.lower(),
                "-p", info.protocol.lower(),
                "-d", f"{info.portal_ip}/32",
                "--dport", str(info.portal_port),
                "-j", "REDIRECT", "--to-ports", str(info.proxy_port))

    def open_portal(self, info: ServiceInfo) -> None:
        """ref: proxier.go openPortal."""
        if info.portal_ip:
            self.iptables.ensure_rule(iptablespkg.TableNAT,
                                      IPTABLES_PROXY_CHAIN,
                                      *self._portal_args(info))

    def close_portal(self, info: ServiceInfo) -> None:
        if info.portal_ip:
            self.iptables.delete_rule(iptablespkg.TableNAT,
                                      IPTABLES_PROXY_CHAIN,
                                      *self._portal_args(info))

    def ensure_portals(self) -> None:
        """Reinstall portal rules for every known service
        (ref: proxier.go ensurePortals:375-388, called from SyncLoop)."""
        with self._lock:
            for info in self.service_map.values():
                self.open_portal(info)

    def sync_loop(self) -> None:
        """ref: proxier.go SyncLoop:360-373."""
        while not self._stopped.wait(self.sync_period):
            self.ensure_portals()
            self.clean_stale_sessions()

    def clean_stale_sessions(self) -> None:
        with self._lock:
            names = list(self.service_map)
        for name in names:
            self.lb.clean_up_stale_sessions(name)

    # -- proxy socket management ------------------------------------------
    def connect_to_backend(self, service: str, src_ip: str,
                           protocol: str) -> socket.socket:
        """Dial an endpoint with one retry through the balancer
        (ref: tcpProxySocket.ProxyLoop retry over sessionAffinity reset)."""
        last_err: Optional[Exception] = None
        for attempt in range(2):
            ep = self.lb.next_endpoint(service, src_ip,
                                       reset_affinity=attempt > 0)
            host, _, port = ep.rpartition(":")
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(5.0)
            try:
                s.connect((host, int(port)))
                s.settimeout(None)
                return s
            except OSError as e:
                s.close()
                last_err = e
        raise last_err

    def add_service_on_port(self, name: str, protocol: str,
                            proxy_port: int = 0) -> ServiceInfo:
        """Open a local listener for a service
        (ref: proxier.go addServiceOnPort:425-451)."""
        if protocol == api.ProtocolUDP:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.listen_ip, proxy_port))
        if protocol != api.ProtocolUDP:
            sock.listen(128)
        info = ServiceInfo(name=name, protocol=protocol,
                           proxy_port=sock.getsockname()[1], sock=sock)
        runner = _UDPProxy(self, info) if protocol == api.ProtocolUDP \
            else _TCPProxy(self, info)
        info.thread = threading.Thread(target=runner.run, daemon=True,
                                       name=f"proxy-{name}")
        info.thread.start()
        return info

    def stop_proxy(self, info: ServiceInfo) -> None:
        info.active = False
        if info.sock is not None:
            try:
                # shutdown wakes a thread blocked in accept() and makes the
                # kernel refuse new connections immediately even while the
                # accept thread still holds the file open
                info.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                info.sock.close()
            except OSError:
                pass

    # -- config hook -------------------------------------------------------
    def on_update(self, services: List[api.Service]) -> None:
        """Full-state service list (ref: proxier.go OnUpdate:467-530):
        start proxies for new services, restart on portal changes, stop
        proxies for removed services."""
        with self._lock:
            active: set = set()
            for svc in services:
                name = meta_namespace_key_func(svc)
                active.add(name)
                info = self.service_map.get(name)
                if info is not None and \
                        info.portal_ip == svc.spec.portal_ip and \
                        info.portal_port == svc.spec.port and \
                        info.protocol == svc.spec.protocol:
                    if info.session_affinity != svc.spec.session_affinity:
                        # affinity change needs no socket restart, just a
                        # balancer update (ref: proxier.go updates lb state
                        # from serviceInfo on every OnUpdate pass)
                        info.session_affinity = svc.spec.session_affinity
                        self.lb.new_service(name, svc.spec.session_affinity)
                    continue
                if info is not None:
                    self.close_portal(info)
                    self.stop_proxy(info)
                info = self.add_service_on_port(name, svc.spec.protocol)
                info.portal_ip = svc.spec.portal_ip
                info.portal_port = svc.spec.port
                info.session_affinity = svc.spec.session_affinity
                self.service_map[name] = info
                self.lb.new_service(name, svc.spec.session_affinity)
                self.open_portal(info)
            for name in list(self.service_map):
                if name not in active:
                    info = self.service_map.pop(name)
                    self.close_portal(info)
                    self.stop_proxy(info)

    def proxy_port_of(self, namespace: str, name: str) -> Optional[int]:
        info = self.service_map.get(f"{namespace}/{name}")
        return info.proxy_port if info else None

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            for info in self.service_map.values():
                self.close_portal(info)
                self.stop_proxy(info)
            self.service_map.clear()
