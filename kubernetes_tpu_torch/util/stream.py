"""Bidirectional byte relay shared by the stream-upgrade endpoints
(ref: pkg/util/httpstream — the SPDY plumbing's data-pump slot; used by the
kubelet's /portForward handler and kubectl port-forward's tunnel).

Port of ``kubernetes_tpu/util/stream.py``."""

from __future__ import annotations

import select
import socket
from typing import Callable, Optional

__all__ = ["relay_bidirectional"]


def relay_bidirectional(a: socket.socket, b: socket.socket,
                        idle_timeout: float = 30.0,
                        keep_going: Optional[Callable[[], bool]] = None,
                        ) -> None:
    """Copy bytes both ways until EOF/error on either side. If
    ``keep_going`` is given, idle periods poll it and the relay survives
    them; otherwise an idle period of ``idle_timeout`` ends the relay.
    Closes neither socket — callers own lifetimes."""
    socks = [a, b]
    try:
        while True:
            readable, _, _ = select.select(socks, [], [], idle_timeout)
            if not readable:
                if keep_going is not None and keep_going():
                    continue
                return
            for s in readable:
                data = s.recv(65536)
                if not data:
                    return
                (b if s is a else a).sendall(data)
    except OSError:
        return
