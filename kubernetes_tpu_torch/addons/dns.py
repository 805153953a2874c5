"""Cluster DNS addon — service discovery by name.

ref: cluster/addons/dns/ (skydns + kube2sky): the reference runs a
sidecar that watches services and serves ``<service>.<namespace>.<domain>``
A records pointing at portal IPs. This is the consolidated equivalent: a
dependency-free UDP DNS server backed by the same list-watch cache every
other component uses (no sidecar bridge needed — the reflector IS
kube2sky).

Supported queries (case-insensitive, domain default ``cluster.local``):

    <service>.<namespace>.<domain>   -> A <portal IP>
    <service>.<domain>               -> A <portal IP> (default namespace)

Everything else answers NXDOMAIN; non-A/IN queries answer with an empty
NOERROR (the name exists when the service does). Standard RFC 1035 wire
format, one question per packet, answers use name compression pointers.

Port of ``kubernetes_tpu/addons/dns.py``.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import Reflector, Store

__all__ = ["DNSServer"]

_QTYPE_A = 1
_QCLASS_IN = 1


def _parse_query(data: bytes) -> Optional[Tuple[int, str, int, int, bytes]]:
    """(txid, qname, qtype, qclass, question_bytes) or None if malformed."""
    if len(data) < 12:
        return None
    (txid, _flags, qd, _an, _ns, _ar) = struct.unpack(">HHHHHH", data[:12])
    if qd < 1:
        return None
    labels = []
    pos = 12
    while True:
        if pos >= len(data):
            return None
        n = data[pos]
        if n == 0:
            pos += 1
            break
        if n & 0xC0:  # compression pointers are illegal in queries
            return None
        labels.append(data[pos + 1: pos + 1 + n].decode("ascii", "replace"))
        pos += 1 + n
    if pos + 4 > len(data):
        return None
    qtype, qclass = struct.unpack(">HH", data[pos: pos + 4])
    return txid, ".".join(labels), qtype, qclass, data[12: pos + 4]


def _response(txid: int, question: bytes, rcode: int,
              ip: Optional[str]) -> bytes:
    flags = 0x8180 | (rcode & 0xF)  # QR+RD+RA
    an = 1 if ip else 0
    head = struct.pack(">HHHHHH", txid, flags, 1, an, 0, 0)
    out = head + question
    if ip:
        try:
            rdata = socket.inet_aton(ip)
        except OSError:
            return struct.pack(">HHHHHH", txid, 0x8182, 1, 0, 0, 0) + question
        # 0xC00C: pointer to the question name at offset 12
        out += struct.pack(">HHHIH", 0xC00C, _QTYPE_A, _QCLASS_IN, 30, 4) + rdata
    return out


class DNSServer:
    """UDP DNS over the service list-watch cache."""

    def __init__(self, client, host: str = "127.0.0.1", port: int = 0,
                 domain: str = "cluster.local"):
        self.client = client
        self.domain = domain.lower().strip(".")
        self.store = Store()
        self._reflector = Reflector(
            client.services(api.NamespaceAll).list_watch(),
            self.store, name="dns-services")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.5)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> Tuple[str, int]:
        return self._sock.getsockname()

    def start(self) -> "DNSServer":
        self._reflector.run()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="cluster-dns")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._reflector.stop()
        if self._thread:
            self._thread.join(timeout=2)
        self._sock.close()

    # -- resolution ---------------------------------------------------------
    def resolve(self, qname: str) -> Optional[str]:
        """Portal IP for a service name, else None."""
        name = qname.lower().strip(".")
        # a real subdomain of the cluster domain, not merely a string
        # suffix ("webcluster.local" must NOT match "cluster.local")
        if not name.endswith("." + self.domain):
            return None
        head = name[: -(len(self.domain) + 1)]
        parts = head.split(".") if head else []
        if len(parts) == 1:
            svc, ns = parts[0], api.NamespaceDefault
        elif len(parts) == 2:
            svc, ns = parts
        else:
            return None
        # names/namespaces are DNS-1123 (lowercase) — the cache's
        # namespace/name index answers in O(1)
        s = self.store.get_by_key(f"{ns}/{svc}")
        if s is None:
            return None
        return s.spec.portal_ip or None

    # -- serving ------------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, peer = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                break
            parsed = _parse_query(data)
            if parsed is None:
                continue
            txid, qname, qtype, qclass, question = parsed
            ip = self.resolve(qname)
            if ip is None:
                resp = _response(txid, question, rcode=3, ip=None)  # NXDOMAIN
            elif qtype == _QTYPE_A and qclass == _QCLASS_IN:
                resp = _response(txid, question, rcode=0, ip=ip)
            else:
                resp = _response(txid, question, rcode=0, ip=None)
            try:
                self._sock.sendto(resp, peer)
            except OSError:
                pass
