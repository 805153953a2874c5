"""Kubelet read-only HTTP server (ref: pkg/kubelet/server.go:118-134).

Endpoints (parity with server.go InstallDefaultHandlers/InstallDebuggingHandlers):
  GET  /healthz                                  -> "ok"
  GET  /pods                                     -> bound pods + statuses
  GET  /podInfo?podID=&podNamespace=             -> one pod's status
  GET  /spec/                                    -> machine info (cadvisor seam)
  GET  /stats/                                   -> node stats
  GET  /stats/<ns>/<pod>/<uid>/<container>       -> container stats
  GET  /logs/...                                 -> files under the log dir
  GET  /containerLogs/<ns>/<pod>/<container>     -> container output (?tail=N)
  GET/POST /run/<ns>/<pod>/<container>?cmd=      -> exec, returns output
  GET  /exec/<ns>/<pod>/<container>?command=     -> exec (same transport)
  POST /portForward/<ns>/<pod>?port=N            -> raw byte tunnel after a
       101 upgrade — the httpstream/spdy equivalent (ref:
       pkg/util/httpstream/spdy/upgrade.go) without the SPDY framing
  GET  /metrics                                  -> Prometheus text

Port of ``kubernetes_tpu/kubelet/server.py``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.latest import scheme as default_scheme
from kubernetes_tpu_torch.kubelet.stats import ProcStatsProvider, StatsProvider
from kubernetes_tpu_torch.runtime.serialize import to_wire
from kubernetes_tpu_torch.util.stream import relay_bidirectional
from kubernetes_tpu_torch.util import metrics as metricspkg

__all__ = ["KubeletServer"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    server_version = "kubelet-tpu"

    def log_message(self, fmt, *args):
        pass

    # -- helpers -----------------------------------------------------------
    @property
    def ks(self) -> "KubeletServer":
        return self.server.kubelet_server  # type: ignore[attr-defined]

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=2).encode())

    def _send_text(self, code: int, text: str) -> None:
        self._send(code, text.encode(), "text/plain; charset=utf-8")

    def _drain(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    # -- dispatch ----------------------------------------------------------
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def _route(self, method: str) -> None:
        self._drain()
        parsed = urllib.parse.urlsplit(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        # parse once; handlers get the single-value view, _handle_run the
        # multi-value one (repeated cmd= params are argv entries)
        self._multi_query = urllib.parse.parse_qs(parsed.query)
        query = {k: v[-1] for k, v in self._multi_query.items()}
        try:
            self._dispatch(method, parts, query)
        except BrokenPipeError:
            pass
        except Exception as e:
            try:
                self._send_text(500, f"Internal Error: {e}\n")
            except OSError:
                pass

    def _dispatch(self, method: str, parts, query) -> None:
        ks = self.ks
        head = parts[0] if parts else ""
        if head == "healthz":
            return self._send_text(200, "ok")
        if head == "pods":
            return self._handle_pods()
        if head == "podInfo":
            return self._handle_pod_info(query)
        if head == "spec":
            return self._send_json(200, ks.stats.machine_info().as_dict())
        if head == "stats":
            return self._handle_stats(parts[1:])
        if head == "logs":
            return self._handle_logs(parts[1:])
        if head == "containerLogs":
            return self._handle_container_logs(parts[1:], query)
        if head in ("run", "exec"):
            return self._handle_run(parts[1:], query)
        if head == "portForward":
            return self._handle_port_forward(parts[1:], query)
        if head == "metrics":
            body = ks.metrics.render_text()
            if ks.metrics is not metricspkg.default_registry():
                # default-registry merge (the apiserver's pattern):
                # process-wide families — the async event recorder's
                # posted/dropped counters above all — must ride the
                # kubelet's scrape too, or its event shedding would be
                # invisible exactly where events originate
                body += metricspkg.default_registry().render_text()
            return self._send(200, body.encode(),
                              "text/plain; version=0.0.4")
        if head == "debug" and len(parts) >= 2 and parts[1] == "pprof":
            # ref: every reference binary mounts pprof (master.go:431-435)
            from kubernetes_tpu_torch.util import pprof
            body = pprof.handle(parts[2] if len(parts) > 2 else "",
                                query.get("seconds", ""))
            if body is not None:
                return self._send_text(200, body)
        self._send_text(404, f"unknown path /{'/'.join(parts)}\n")

    # -- endpoints ---------------------------------------------------------
    def _handle_pods(self) -> None:
        ks = self.ks
        pods = ks.kubelet_pods()
        wire = ks.scheme.encode_to_wire(api.PodList(items=pods))
        self._send(200, json.dumps(wire).encode())

    def _handle_pod_info(self, query) -> None:
        name = query.get("podID", "")
        ns = query.get("podNamespace", "")
        if not name or not ns:
            return self._send_text(400, "Missing 'podID' or 'podNamespace' "
                                        "query entry.\n")
        pod = self.ks.find_pod(ns, name)
        if pod is None:
            return self._send_text(404, f"pod {ns}/{name} not found\n")
        # PodStatus is not a top-level registered kind; serialize it raw
        wire = to_wire(pod.status)
        self._send(200, json.dumps(wire).encode())

    def _handle_stats(self, rest) -> None:
        ks = self.ks
        if not rest:
            return self._send_json(200, ks.stats.node_stats().as_dict())
        # /stats/<ns>/<pod>/<uid>/<container> or /stats/<ns>/<pod>/<container>
        if len(rest) == 4:
            ns, pod_name, uid, container = rest
        elif len(rest) == 3:
            ns, pod_name, container = rest
            pod = ks.find_pod(ns, pod_name)
            uid = pod.metadata.uid if pod else ""
        else:
            return self._send_text(400, "stats needs "
                                        "/stats/<ns>/<pod>/[<uid>/]<container>\n")
        st = ks.stats.container_stats(uid, container)
        if st is None:
            return self._send_text(404, "no stats for container\n")
        self._send_json(200, st.as_dict())

    def _handle_logs(self, rest) -> None:
        ks = self.ks
        if ks.log_dir is None:
            return self._send_text(404, "log serving disabled\n")
        root = os.path.realpath(ks.log_dir)
        target = os.path.realpath(os.path.join(ks.log_dir, *rest))
        # prefix check must be directory-aware: /var/log/kubelet-private
        # shares a raw string prefix with /var/log/kubelet
        if target != root and not target.startswith(root + os.sep):
            return self._send_text(403, "path escapes the log dir\n")
        if os.path.isdir(target):
            return self._send_text(
                200, "".join(f"{n}\n" for n in sorted(os.listdir(target))))
        if not os.path.exists(target):
            return self._send_text(404, "no such log\n")
        with open(target, "rb") as f:
            self._send(200, f.read(), "text/plain; charset=utf-8")

    def _resolve_container(self, rest):
        """(ns, pod, container) path -> (pod, container record) or None."""
        if len(rest) != 3:
            return None, None
        ns, pod_name, container = rest
        ks = self.ks
        pod = ks.find_pod(ns, pod_name)
        if pod is None:
            return None, None
        rec = ks.container_record(pod, container)
        return pod, rec

    def _handle_container_logs(self, rest, query) -> None:
        pod, rec = self._resolve_container(rest)
        if pod is None:
            return self._send_text(404, "pod not found\n")
        if rec is None:
            return self._send_text(404, "container not found\n")
        tail = int(query.get("tail") or 0)
        text = self.ks.runtime.container_logs(rec.id, tail=tail)
        self._send_text(200, text)

    def _handle_run(self, rest, query) -> None:
        pod, rec = self._resolve_container(rest)
        if pod is None or rec is None:
            return self._send_text(404, "container not found\n")
        # repeated cmd= params are argv entries (ref: server.go handleRun);
        # a single spaced value is whitespace-split as a convenience
        multi = self._multi_query
        cmd = multi.get("cmd") or multi.get("command") or []
        if len(cmd) == 1 and " " in cmd[0]:
            cmd = cmd[0].split()
        if not cmd:
            return self._send_text(400, "missing cmd\n")
        from kubernetes_tpu_torch.util import websocket as ws
        if ws.wants_websocket(self.headers):
            # streaming exec (the stream-upgrade seam the reference fills
            # with SPDY, ref: pkg/util/httpstream/spdy/upgrade.go): output
            # chunks as binary frames, exit code in the final text frame
            self._ws_handshake(ws)
            exit_code = 0
            try:
                for item in self.ks.runtime.exec_stream_in_container(
                        rec.id, cmd):
                    if isinstance(item, int):
                        exit_code = item
                    elif item:
                        ws.send_binary(self.wfile, item)
                ws.send_text(self.wfile,
                             json.dumps({"exitCode": exit_code}).encode())
                ws.send_close(self.wfile)
            except Exception:
                # after the 101 upgrade an HTTP error response would be
                # garbage inside the websocket stream; just drop the
                # connection (ref: SPDY upgrade has the same property)
                pass
            self.close_connection = True
            return
        code, output = self.ks.runtime.exec_in_container(rec.id, cmd)
        self._send_text(200 if code == 0 else 500, output)

    def _ws_handshake(self, ws) -> None:
        self.send_response_only(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", ws.accept_key(
            self.headers.get("Sec-WebSocket-Key", "")))
        self.end_headers()
        self.wfile.flush()

    def _handle_port_forward(self, rest, query) -> None:
        """Raw byte tunnel: 101 upgrade, then relay the HTTP connection to
        the pod's port (the stream-upgrade seam the reference fills with
        SPDY, ref: server.go handlePortForward + httpstream/spdy)."""
        if len(rest) < 2:
            return self._send_text(400, "portForward needs /<ns>/<pod>\n")
        ns, pod_name = rest[0], rest[1]
        port = int(query.get("port") or 0)
        if not port:
            return self._send_text(400, "missing port\n")
        pod = self.ks.find_pod(ns, pod_name)
        if pod is None:
            return self._send_text(404, "pod not found\n")
        try:
            backend = self.ks.port_forward_dial(pod, port)
        except OSError as e:
            return self._send_text(502, f"dial failed: {e}\n")
        from kubernetes_tpu_torch.util import websocket as ws
        if ws.wants_websocket(self.headers):
            # WebSocket port-forward: client binary frames -> backend,
            # backend bytes -> binary frames (the reference's SPDY stream
            # pair, per RFC 6455 instead)
            self._ws_handshake(ws)
            wlock = threading.Lock()

            def pump_client():
                try:
                    while True:
                        frame = ws.read_frame(self.rfile)
                        if frame is None or frame[0] == ws.OP_CLOSE:
                            # None = EOF or an over-MAX_FRAME length: the
                            # tunnel closes cleanly either way (fragment
                            # large messages; CONT frames relay fine)
                            break
                        if frame[0] == ws.OP_PING:
                            with wlock:
                                ws.send_pong(self.wfile, frame[1])
                        elif frame[0] in (ws.OP_BIN, ws.OP_TEXT,
                                          ws.OP_CONT) and frame[1]:
                            backend.sendall(frame[1])
                except OSError:
                    pass
                try:
                    backend.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

            t = threading.Thread(target=pump_client, daemon=True,
                                 name="ws-portforward")
            t.start()
            # same idle bound the raw-relay path enforces: a silently
            # vanished client must not pin this thread forever
            backend.settimeout(30.0)
            try:
                while True:
                    data = backend.recv(65536)
                    if not data:
                        break
                    with wlock:
                        ws.send_binary(self.wfile, data)
                with wlock:
                    ws.send_close(self.wfile)
            except (BrokenPipeError, ConnectionResetError, OSError,
                    socket.timeout):
                pass
            finally:
                backend.close()
                self.close_connection = True
            return
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "tcp")
        self.send_header("Connection", "Upgrade")
        self.end_headers()
        self.wfile.flush()
        try:
            relay_bidirectional(self.connection, backend, idle_timeout=30.0)
        finally:
            backend.close()
            self.close_connection = True


class KubeletServer:
    """Wires the handler to a kubelet instance (ref: server.go ListenAndServe
    + the HostInterface seam it serves from)."""

    def __init__(self, kubelet, host: str = "127.0.0.1", port: int = 0,
                 stats: Optional[StatsProvider] = None,
                 log_dir: Optional[str] = None,
                 scheme=None,
                 port_forward_dial: Optional[Callable] = None,
                 metrics: Optional[metricspkg.Registry] = None):
        self.kubelet = kubelet
        self.stats = stats or ProcStatsProvider()
        self.log_dir = log_dir
        self.scheme = scheme or default_scheme
        self.metrics = metrics or metricspkg.Registry()
        self._dial = port_forward_dial
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.kubelet_server = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- HostInterface (ref: server.go HostInterface) ----------------------
    @property
    def runtime(self):
        return self.kubelet.runtime

    def kubelet_pods(self):
        """Bound pods with their current generated status."""
        pods = []
        with self.kubelet._lock:
            desired = list(self.kubelet._desired.values())
        for pod in desired:
            p = self.scheme.deep_copy(pod)
            try:
                p.status = self.kubelet.generate_pod_status(pod)
            except Exception:
                pass
            pods.append(p)
        return pods

    def find_pod(self, namespace: str, name: str) -> Optional[api.Pod]:
        with self.kubelet._lock:
            match = next(
                (p for p in self.kubelet._desired.values()
                 if p.metadata.namespace == namespace
                 and p.metadata.name == name), None)
        if match is None:
            return None
        # copy + status only the one pod — kubelet_pods() would regenerate
        # every pod's status per request
        pod = self.scheme.deep_copy(match)
        try:
            pod.status = self.kubelet.generate_pod_status(match)
        except Exception:
            pass
        return pod

    def container_record(self, pod: api.Pod, container_name: str):
        uid = pod.metadata.uid or pod.metadata.name
        records = [r for r in self.runtime.list_containers(include_dead=True)
                   if r.parsed and r.parsed[3] == uid
                   and r.parsed[0] == container_name]
        running = [r for r in records if r.running]
        pick = running or records
        return pick[-1] if pick else None

    def port_forward_dial(self, pod: api.Pod, port: int) -> socket.socket:
        if self._dial is not None:
            return self._dial(pod, port)
        ip = pod.status.pod_ip or "127.0.0.1"
        return socket.create_connection((ip, port), timeout=5)

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "KubeletServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="kubelet-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
