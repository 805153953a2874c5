"""HTTP transport for the typed client.

Port of ``kubernetes_tpu/client/http.py`` (ref: pkg/client/restclient.go +
the chainable request builder, pkg/client/request.go): the
``request(verb, resource, **kw)`` seam the port's ``Client`` calls, over
real HTTP/JSON against an apiserver, in any wire version the scheme
registers (v1, or the legacy v1beta1 and v1beta2). Kept-alive
connections per thread with stale-connection detection, failure bodies
raised as ``errors.StatusError``, field and label selectors in the URL,
the batch-bind POST (``bindings:batch``), the 429 retry window, and
watches consumed as the chunked JSON frame stream (ref: pkg/apiserver/
watch.go) by a pump thread feeding a ``watch.Watcher``. With tracing on
(util/tracing.py) every request and watch carries the caller's ambient
span as the ``X-KTPU-Trace`` header, so the apiserver's spans join the
caller's trace. Credentials are ``auth=("basic", user, pw)`` or
``("bearer", token)``; TLS takes a CA bundle, a client certificate and
key, or ``insecure_skip_tls_verify``, through the standard library's
``ssl`` (the kubeconfig files that name them are read by
``client/clientcmd.py``).
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import select
import socket
import threading
import time
import urllib.parse
from collections import OrderedDict
from typing import Any, Dict, NoReturn, Optional

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.latest import scheme as default_scheme
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.util import tracing
from kubernetes_tpu_torch.util.retry import Backoff

__all__ = ["HTTPTransport"]

_log = logging.getLogger("kubernetes_tpu_torch.client.http")

# Set by a test harness to run a suite over a chosen wire version (ref:
# hack/test-go.sh KUBE_TEST_API_VERSIONS loop). Deliberately NOT read from
# os.environ: a stray variable must not change the wire version of
# production clients.
test_version_override: str = ""


class _EventDecodeCache:
    """(apiVersion, kind, namespace, name, resourceVersion) -> decoded
    object. A component typically runs several watches over overlapping
    sets (the scheduler's unassigned/assigned reflectors both see every
    bind), and a revision's decode is immutable — the client-side mirror
    of StoreHelper's decode cache. Callers get a deep_clone, never the
    cached tree. Bounded FIFO. One instance PER TRANSPORT: resource
    versions are only unique within one server's store, so a shared
    cache would let two clusters collide on the same (kind, name, rv)."""

    MAX = 4096

    def __init__(self):
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def decode(self, scheme, wire: dict):
        meta = wire.get("metadata") or {}
        key = (wire.get("apiVersion", ""), wire.get("kind", ""),
               meta.get("namespace", ""), meta.get("name", ""),
               meta.get("resourceVersion", ""))
        if not (key[3] and key[4]):  # unversioned/unnamed: decode directly
            return scheme.decode_from_wire(wire)
        with self._lock:
            obj = self._cache.get(key)
        if obj is None:
            obj = scheme.decode_from_wire(wire)
            with self._lock:
                self._cache[key] = obj
                while len(self._cache) > self.MAX:
                    self._cache.popitem(last=False)
        return deep_clone(obj)


class HTTPTransport:
    """Talks to an API server over HTTP or HTTPS. ``auth`` is ``("basic",
    user, pw)`` or ``("bearer", token)`` (ref: pkg/client/client.go
    Config.{Username,Password,BearerToken}); ``ca_cert``, ``client_cert``,
    ``client_key`` and ``insecure_skip_tls_verify`` shape the TLS context
    (ref: Config.TLSClientConfig, Config.Insecure)."""

    def __init__(self, base_url: str, scheme=None, version: str = "",
                 auth: Optional[tuple] = None, timeout: float = 30.0,
                 ca_cert: str = "", client_cert: str = "", client_key: str = "",
                 insecure_skip_tls_verify: bool = False,
                 connect_retry_s: float = 15.0,
                 throttle_retry_s: float = 20.0,
                 user_agent: str = ""):
        # a refused or failed CONNECT (an apiserver mid-restart) retries
        # with capped exponential backoff and jitter for up to
        # connect_retry_s before surfacing; nothing was sent, so the retry
        # can never double-execute. 0 disables (fail-fast probes).
        self.connect_retry_s = connect_retry_s
        # a 429 means the server refused the request before executing it,
        # so a resend is always safe: honour its Retry-After for up to
        # throttle_retry_s, then surface the StatusError (which carries
        # details.retryAfterSeconds). 0 disables (fail-fast).
        self.throttle_retry_s = throttle_retry_s
        self.throttled_retries = 0
        self.base_url = base_url.rstrip("/")
        self.scheme = scheme or default_scheme
        self.version = version or test_version_override \
            or self.scheme.default_version
        self.timeout = timeout
        self.ssl_context = None
        if base_url.startswith("https") or ca_cert or client_cert \
                or insecure_skip_tls_verify:
            import ssl
            ctx = ssl.create_default_context(cafile=ca_cert or None)
            if insecure_skip_tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                ctx.load_cert_chain(client_cert, client_key or None)
            self.ssl_context = ctx
        self._tl = threading.local()   # per-thread kept-alive connection
        self._event_cache = _EventDecodeCache()
        self._headers: Dict[str, str] = {"Content-Type": "application/json"}
        if user_agent:
            # the apiserver's flow classifier reads the user-agent:
            # control-plane components identify themselves so their
            # reflector and bind traffic rides the system flow
            self._headers["User-Agent"] = user_agent
        if auth is not None:
            if auth[0] == "basic":
                raw = base64.b64encode(f"{auth[1]}:{auth[2]}".encode()).decode()
                self._headers["Authorization"] = f"Basic {raw}"
            elif auth[0] == "bearer":
                self._headers["Authorization"] = f"Bearer {auth[1]}"
            else:
                raise ValueError(f"unknown auth kind {auth[0]!r}")

    # -- url building (ref: request.go namespace/resource/name chain) -----

    def _url(self, resource: str, namespace: str, name: str, subresource: str,
             query: Dict[str, str], watching: bool = False) -> str:
        parts = ["api", self.version]
        if watching:
            parts.append("watch")
        if namespace:
            parts += ["namespaces", namespace]
        parts.append(resource)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        # ':' stays literal (RFC 3986 pchar) — the bindings:batch verb
        # suffix must reach the server unescaped
        url = self.base_url + "/" + "/".join(
            urllib.parse.quote(p, safe=":") for p in parts)
        q = {k: v for k, v in query.items() if v}
        if q:
            url += "?" + urllib.parse.urlencode(q)
        return url

    def _raise_status_error(self, raw: bytes, code: int) -> NoReturn:
        """Decode an error body into a StatusError (ref: restclient.go
        transformResponse); fall back to a generic Status on opaque bodies."""
        try:
            status = self.scheme.decode(raw, default_version=self.version)
            if isinstance(status, api.Status):
                raise errors.from_status(status) from None
        except errors.StatusError:
            raise
        except Exception:
            pass
        raise errors.StatusError(api.Status(
            status=api.StatusFailure, code=code,
            message=raw.decode("utf-8", "replace"))) from None

    # -- persistent connections (ref: Go http.Transport keep-alive) --------
    # One HTTP/1.1 connection per (thread, transport), reused across
    # requests: a fresh TCP connect per request costs ~5-6ms and caps a
    # churn feeder well below the apiserver's capacity. Watch streams own
    # their socket separately (_start_watch).

    def _conn(self):
        tl = self._tl
        conn = getattr(tl, "conn", None)
        if conn is not None and conn.sock is not None \
                and self._conn_stale(conn):
            # Go's Transport notices a server-side close through its
            # background read loop and evicts the idle connection before a
            # request can land on it; _conn_stale emulates that, so even a
            # POST goes out on a live socket instead of dying after the
            # send (where no safe retry exists).
            self._drop_conn()
            conn = None
        if conn is None:
            parsed = urllib.parse.urlsplit(self.base_url)
            if parsed.scheme == "https":
                conn = http.client.HTTPSConnection(
                    parsed.hostname, parsed.port, timeout=self.timeout,
                    context=self.ssl_context)
            else:
                conn = http.client.HTTPConnection(
                    parsed.hostname, parsed.port, timeout=self.timeout)
            conn.connect()
            # headers and body go out as separate writes; without NODELAY,
            # Nagle + the peer's delayed ACK turns every request into a
            # ~40ms round trip
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            tl.conn = conn
        return conn

    @staticmethod
    def _conn_stale(conn) -> bool:
        """True when an idle kept-alive connection is unusable for a new
        request. Zero-timeout readability poll (poll(2) — select(2)'s
        FD_SETSIZE cap would falsely flag healthy sockets on fd>=1024):
        any pending byte/EOF on an idle plaintext HTTP/1.1 connection means
        the server closed or desynced. Under TLS a pending record can also
        be a benign control message (session ticket, KeyUpdate), so peek
        through the TLS layer: SSLWantReadError = control-only = healthy;
        EOF or unsolicited app data = stale."""
        sock = conn.sock
        try:
            if hasattr(select, "poll"):
                p = select.poll()
                p.register(sock,
                           select.POLLIN | select.POLLHUP | select.POLLERR)
                readable = bool(p.poll(0))
            else:  # platforms without poll(2)
                readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            return True
        if not readable:
            return False
        if not isinstance(conn, http.client.HTTPSConnection):
            return True
        import ssl
        prev = sock.gettimeout()
        try:
            sock.settimeout(0.0)
            sock.recv(1)        # b'' (EOF) or app data: both unusable
            return True
        except ssl.SSLWantReadError:
            return False        # partial TLS control record; conn healthy
        except OSError:
            return True
        finally:
            try:
                sock.settimeout(prev)
            except OSError:
                pass

    def _drop_conn(self):
        conn = getattr(self._tl, "conn", None)
        if conn is not None:
            self._tl.conn = None
            try:
                conn.close()
            except Exception:
                pass

    @staticmethod
    def _trace_headers(headers: Dict[str, str]) -> Dict[str, str]:
        """Add the caller's ambient span (the wave's commit or list leg)
        as X-KTPU-Trace, so the apiserver's handler span joins its
        trace; unchanged when tracing is off or no span is open."""
        if tracing.enabled():
            w = tracing.wire()
            if w:
                headers[tracing.HEADER] = w
        return headers

    def _open(self, url: str, method: str, body: Optional[bytes] = None):
        """-> (status, raw bytes); raises StatusError on HTTP errors. A dead
        kept-alive connection is retried once under Go http.Transport's rules
        (which the reference relies on, ref: pkg/client/restclient.go): only
        when the retry cannot double-execute — the method is idempotent, or
        the request was never fully written to the socket. Server idle-closes
        are instead caught BEFORE sending by _conn's readability probe, the
        same way Go's background read loop evicts dead idle connections."""
        parsed = urllib.parse.urlsplit(url)
        path = parsed.path + ("?" + parsed.query if parsed.query else "")
        idempotent = method in ("GET", "HEAD")
        headers = self._trace_headers(dict(self._headers))
        throttle_deadline = None   # armed on the first 429
        throttle_backoff = None
        while True:
            deadline = time.monotonic() + self.connect_retry_s
            connect_backoff = Backoff(base=0.05, cap=1.0)
            for attempt in (0, 1):
                while True:
                    try:
                        conn = self._conn()
                        break
                    except (ConnectionError, TimeoutError):
                        # TRANSIENT connect failure (refused/reset/timeout —
                        # an apiserver worker mid-respawn): no bytes out, so
                        # retrying is always safe. Permanent failures (DNS
                        # gaierror, TLS cert verification) fall through and
                        # surface immediately — backing off on those would
                        # turn a typo'd --master into a silent 15 s stall.
                        if self.connect_retry_s <= 0 or \
                                time.monotonic() + connect_backoff.peek() \
                                >= deadline:
                            raise
                        connect_backoff.sleep_next()
                sent = False
                try:
                    conn.request(method, path, body=body, headers=headers)
                    sent = True
                    resp = conn.getresponse()
                    raw = resp.read()
                    status = resp.status
                    retry_after = resp.getheader("Retry-After")
                    if resp.will_close:
                        self._drop_conn()
                    break
                except (http.client.HTTPException, ConnectionError, OSError):
                    self._drop_conn()
                    # Once a non-idempotent request has gone out in full, the
                    # server may have executed it even though the response
                    # never arrived — a blind re-send would duplicate the
                    # create/delete (spurious 409/404). Surface the
                    # connection error instead, exactly as Go refuses to
                    # retry non-replayable requests (net/http transport.go
                    # shouldRetryRequest/isReplayable).
                    if attempt or (sent and not idempotent):
                        raise
            if status == 429 and self.throttle_retry_s > 0:
                # kube-fairshed shed: the server REFUSED this request
                # before doing any work, so a resend can never
                # double-execute — honor its measured Retry-After
                # (falling back to jittered exponential backoff) within
                # the throttle window, then surface the 429.
                now = time.monotonic()
                if throttle_deadline is None:
                    throttle_deadline = now + self.throttle_retry_s
                    throttle_backoff = Backoff(base=0.5, cap=5.0)
                try:
                    hint = float(retry_after) if retry_after else 0.0
                except ValueError:
                    hint = 0.0
                delay = hint if hint > 0 else throttle_backoff.next()
                if now + delay < throttle_deadline:
                    self.throttled_retries += 1
                    time.sleep(delay)
                    continue
            break
        if status >= 400:
            self._raise_status_error(raw, status)
        return status, raw

    # -- the transport seam ------------------------------------------------

    def request(self, verb: str, resource: str, *, namespace: str = "",
                name: str = "", body: Any = None, subresource: str = "",
                label_selector: str = "", field_selector: str = "",
                resource_version: str = "") -> Any:
        query = {"labelSelector": label_selector, "fieldSelector": field_selector,
                 "resourceVersion": resource_version}
        if verb == "watch":
            url = self._url(resource, namespace, name, subresource, query,
                            watching=True)
            return self._start_watch(url)

        if verb == "create" and resource == "bindings" \
                and isinstance(body, api.BindingList):
            # the bind_many seam over the wire: one keep-alive POST to the
            # batch endpoint commits a whole wave (per-item results;
            # per-pod CAS semantics preserved server-side)
            resource = "bindings:batch"

        method = {"get": "GET", "list": "GET", "create": "POST",
                  "update": "PUT", "delete": "DELETE", "patch": "PATCH"}[verb]
        payload = None
        if body is not None:
            if verb == "patch":
                payload = json.dumps(body).encode("utf-8") \
                    if isinstance(body, dict) else body
            else:
                payload = self.scheme.encode(body, self.version).encode("utf-8")
        url = self._url(resource, namespace, name, subresource, query)
        _status, raw = self._open(url, method, payload)
        if not raw:
            return None
        out = self.scheme.decode(raw, default_version=self.version)
        if isinstance(out, api.Status) and out.status == api.StatusFailure:
            raise errors.from_status(out)
        return out

    # -- watch streaming ---------------------------------------------------

    def _start_watch(self, url: str) -> watchpkg.Watcher:
        # http.client directly (not urllib) so we own the socket: stopping a
        # watch from another thread must shutdown() the socket to unblock the
        # reader — HTTPResponse.close() would deadlock against it.
        parsed = urllib.parse.urlsplit(url)
        conn_cls = (http.client.HTTPSConnection if parsed.scheme == "https"
                    else http.client.HTTPConnection)
        kw = {"context": self.ssl_context} if parsed.scheme == "https" else {}
        conn = conn_cls(parsed.hostname, parsed.port, timeout=24 * 3600.0,
                        **kw)
        path = parsed.path + ("?" + parsed.query if parsed.query else "")
        headers = self._trace_headers({
            k: v for k, v in self._headers.items()
            if k.lower() != "content-type"})
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        if resp.status >= 400:
            raw = resp.read()
            conn.close()
            self._raise_status_error(raw, resp.status)
        stopped = threading.Event()

        def on_stop(_w):
            stopped.set()
            try:
                if conn.sock is not None:
                    conn.sock.shutdown(socket.SHUT_RDWR)
            except Exception:
                pass

        watcher = watchpkg.Watcher(on_stop=on_stop)

        def pump():
            try:
                for line in resp:
                    if stopped.is_set():
                        break
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        frame = json.loads(line)
                        obj = self._event_cache.decode(self.scheme,
                                                       frame["object"])
                        watcher.send(watchpkg.Event(frame["type"], obj))
                    except Exception:
                        # the watcher closes and the reflector relists
                        _log.exception("watch frame dropped the stream")
                        break
            except Exception:
                pass
            finally:
                try:
                    conn.close()
                except Exception:
                    pass
                watcher.close()

        threading.Thread(target=pump, daemon=True, name="http-watch").start()
        return watcher
