"""Cluster logging addon — the fluentd-elasticsearch analog.

ref: cluster/addons/fluentd-elasticsearch/ — the reference runs a
fluentd collector on every node shipping container logs into an
elasticsearch store queried through kibana. Same architecture here, one
process (this is an aggregation addon, not a search engine):

- **collect** (the fluentd role): node discovery via the node
  list-watch cache and pod discovery via a pod reflector; per
  (pod, container) the collector polls the owning kubelet's read-only
  ``/containerLogs/<ns>/<pod>/<container>`` endpoint (the same files
  `kubectl logs` reads) over a pluggable fetch seam, keeps a byte
  offset per container, and ingests only the delta — a poll-based tail;
- **store** (the elasticsearch role): a bounded in-memory ring of
  ``{ts, namespace, pod, container, node, line}`` records — oldest
  shed first, like a retention policy;
- **query** (the kibana role): an HTTP API — ``/logs?namespace=&pod=
  &container=&node=&q=<substring>&limit=N`` returning matching records
  as JSON (newest last), plus ``/healthz`` and Prometheus ``/metrics``
  (lines ingested, scrape errors, ring size).

Port of ``kubernetes_tpu/addons/logging.py``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import Reflector, Store
from kubernetes_tpu_torch.util import metrics as metrics_pkg

__all__ = ["LogAggregator", "http_kubelet_log_fetcher"]


def http_kubelet_log_fetcher(kubelet_port: int = 10250,
                             timeout: float = 2.0) -> Callable:
    """Default collection seam: GET container logs from the kubelet
    read-only server. Returns the full text, or None on scrape failure."""
    def fetch(node: api.Node, ns: str, pod: str, container: str
              ) -> Optional[str]:
        host = node.metadata.name
        for addr in node.status.addresses:
            if addr.address:
                host = addr.address
                break
        url = (f"http://{host}:{kubelet_port}/containerLogs/"
               f"{ns}/{pod}/{container}")
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.read().decode("utf-8", "replace")
        except (OSError, ValueError):
            return None
    return fetch


class LogAggregator:
    """Tail every container's log through its kubelet; store + serve."""

    def __init__(self, client, fetch: Optional[Callable] = None,
                 period_s: float = 2.0, max_records: int = 100_000,
                 host: str = "127.0.0.1", port: int = 0):
        self.client = client
        self.fetch = fetch or http_kubelet_log_fetcher()
        self.period_s = period_s
        self.node_store = Store()
        self.pod_store = Store()
        self._records: deque = deque(maxlen=max_records)
        self._offsets: Dict[Tuple[str, str, str], int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._runners = []
        self.registry = metrics_pkg.Registry()
        self.metric_lines = self.registry.counter(
            "logging_lines_ingested", "Log lines ingested", ("namespace",))
        self.metric_errors = self.registry.counter(
            "logging_scrape_errors", "Failed log scrapes", ())
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.aggregator = self  # type: ignore[attr-defined]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LogAggregator":
        self._runners.append(Reflector(
            self.client.nodes().list_watch(), self.node_store,
            name="logging-nodes").run())
        self._runners.append(Reflector(
            self.client.pods(api.NamespaceAll).list_watch(),
            self.pod_store, name="logging-pods").run())
        threading.Thread(target=self._collect_loop, daemon=True,
                         name="logging-collect").start()
        threading.Thread(target=self._httpd.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True,
                         name="logging-http").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._runners:
            r.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- collection --------------------------------------------------------
    def collect_once(self) -> int:
        """One tail pass over every running container; returns new lines."""
        nodes = {n.metadata.name: n for n in self.node_store.list()}
        new_lines = 0
        live_keys = set()
        for pod in self.pod_store.list():
            ns = pod.metadata.namespace or "default"
            # a pod is "live" whether or not its node currently resolves —
            # a node-store flap must not reset offsets (duplicate ingestion)
            for c in pod.spec.containers:
                live_keys.add((ns, pod.metadata.name, c.name))
            node = nodes.get(pod.status.host or pod.spec.host)
            if node is None:
                continue
            for c in pod.spec.containers:
                key = (ns, pod.metadata.name, c.name)
                text = self.fetch(node, ns, pod.metadata.name, c.name)
                if text is None:
                    self.metric_errors.inc()
                    continue
                offset = self._offsets.get(key, 0)
                if len(text) < offset:   # container restarted: log reset
                    offset = 0
                delta = text[offset:]
                self._offsets[key] = len(text)
                if not delta:
                    continue
                now = time.time()
                lines = delta.splitlines()
                with self._lock:
                    for line in lines:
                        self._records.append({
                            "ts": now, "namespace": ns,
                            "pod": pod.metadata.name, "container": c.name,
                            "node": node.metadata.name, "line": line})
                        new_lines += 1
                self.metric_lines.inc(ns, by=len(lines))
        # prune offsets of deleted pods so churn doesn't grow the dict forever
        for key in list(self._offsets):
            if key not in live_keys:
                del self._offsets[key]
        return new_lines

    def _collect_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.collect_once()
            except Exception:
                self.metric_errors.inc()
            self._stop.wait(self.period_s)

    # -- query -------------------------------------------------------------
    def query(self, namespace: str = "", pod: str = "", container: str = "",
              node: str = "", q: str = "", limit: int = 1000) -> list:
        out = []
        with self._lock:
            records = list(self._records)
        for r in records:
            if namespace and r["namespace"] != namespace:
                continue
            if pod and r["pod"] != pod:
                continue
            if container and r["container"] != container:
                continue
            if node and r["node"] != node:
                continue
            if q and q not in r["line"]:
                continue
            out.append(r)
        return out[-limit:]


class _Handler(BaseHTTPRequestHandler):
    server_version = "kubernetes-tpu-logging"

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        agg: LogAggregator = self.server.aggregator  # type: ignore
        parsed = urllib.parse.urlsplit(self.path)
        qs = {k: v[0] for k, v in
              urllib.parse.parse_qs(parsed.query).items()}
        if parsed.path == "/healthz":
            body, ctype = b"ok", "text/plain"
        elif parsed.path == "/metrics":
            body = agg.registry.render_text().encode("utf-8")
            ctype = "text/plain; version=0.0.4"
        elif parsed.path == "/logs":
            try:
                limit = int(qs.get("limit", "1000"))
            except ValueError:
                limit = 1000
            body = json.dumps({"entries": agg.query(
                namespace=qs.get("namespace", ""), pod=qs.get("pod", ""),
                container=qs.get("container", ""), node=qs.get("node", ""),
                q=qs.get("q", ""), limit=limit)}).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
