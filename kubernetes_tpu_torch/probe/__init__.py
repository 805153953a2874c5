"""Probe primitives (ref: pkg/probe/{exec,http,tcp}).

Port of ``kubernetes_tpu/probe/__init__.py``'s HTTP prober, what the
scheduler binary's deep ``/healthz`` probes its apiserver with; the TCP
and exec probers come with the kubelet (ROADMAP Queue 1 item 8).

Each prober returns one of SUCCESS / FAILURE / UNKNOWN
(ref: pkg/probe/probe.go Result).
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Tuple

SUCCESS = "success"
FAILURE = "failure"
UNKNOWN = "unknown"

__all__ = ["SUCCESS", "FAILURE", "UNKNOWN", "probe_http"]


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
