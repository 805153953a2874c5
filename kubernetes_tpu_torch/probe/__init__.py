"""Probe primitives (ref: pkg/probe/{exec,http,tcp}).

Port of ``kubernetes_tpu/probe/__init__.py``: the HTTP and TCP probers
(the scheduler binary's deep ``/healthz`` probes its apiserver and its
solver daemon with them, the kubelet its containers) and the exec prober
the kubelet runs in a container.

Each prober returns one of SUCCESS / FAILURE / UNKNOWN
(ref: pkg/probe/probe.go Result).
"""

from __future__ import annotations

import socket
import urllib.error
import urllib.request
from typing import List, Tuple

SUCCESS = "success"
FAILURE = "failure"
UNKNOWN = "unknown"

__all__ = ["SUCCESS", "FAILURE", "UNKNOWN", "probe_http", "probe_tcp",
           "probe_exec"]


def probe_http(host: str, port: int, path: str = "/",
               timeout: float = 1.0) -> Tuple[str, str]:
    """ref: pkg/probe/http/http.go — 2xx/3xx is success."""
    path = path if path.startswith("/") else "/" + path
    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read(4096).decode("utf-8", "replace")
            if 200 <= resp.status < 400:
                return SUCCESS, body
            return FAILURE, body
    except urllib.error.HTTPError as e:
        return FAILURE, str(e)
    except Exception as e:
        return FAILURE, str(e)


def probe_tcp(host: str, port: int, timeout: float = 1.0) -> Tuple[str, str]:
    """ref: pkg/probe/tcp/tcp.go — a successful connect is success."""
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return SUCCESS, ""
    except OSError as e:
        return FAILURE, str(e)


def probe_exec(runtime, container_id: str, cmd: List[str]) -> Tuple[str, str]:
    """ref: pkg/probe/exec/exec.go — exit code 0 is success. ``runtime`` is
    the kubelet's ContainerRuntime seam."""
    try:
        code, output = runtime.exec_in_container(container_id, cmd)
    except Exception as e:
        return UNKNOWN, str(e)
    return (SUCCESS if code == 0 else FAILURE), output
