"""HTTP REST layer over Master.dispatch.

Port of ``kubernetes_tpu/apiserver/http.py``.

Rebuild of the reference's API serving stack: route installation
(ref: pkg/apiserver/api_installer.go:194-239), generic REST handlers
(ref: pkg/apiserver/resthandler.go), watch streaming as chunked JSON frames
(ref: pkg/apiserver/watch.go:62-142), JSON merge PATCH
(ref: resthandler.go:205 PatchResource), proxy/redirect
(ref: pkg/apiserver/{proxy,redirect}.go), request logging
(ref: pkg/httplog/log.go), Prometheus request metrics
(ref: pkg/apiserver/apiserver.go:40-87), plus the unversioned endpoints
/healthz (ref: pkg/healthz), /version (ref: pkg/version), /validate
(ref: pkg/master/master.go:516-551) and /metrics.

Paths, both namespaced-in-path (v1-style, ref v1beta3) and
namespace-as-query-param (legacy v1beta1 style):

    /api                                   -> {"versions": [...]}
    /api/{v}/namespaces/{ns}/{res}[/{name}[/{sub}]]
    /api/{v}/{res}[/{name}]?namespace=ns
    /api/{v}/watch/...        or ?watch=true  -> chunked watch stream
    /api/{v}/proxy/{res}/{name}/{path...}     -> subrequest relay
    /api/{v}/redirect/{res}/{name}            -> 307 Location
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
import urllib.parse
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from kubernetes_tpu_torch import version as version_pkg
from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver import fairshed as fairshed_mod
from kubernetes_tpu_torch.auth import AuthRequest
from kubernetes_tpu_torch.util import chaos
from kubernetes_tpu_torch.util import metrics as metrics_pkg
from kubernetes_tpu_torch.util import tracing

_httplog = logging.getLogger("kubernetes_tpu_torch.apiserver.httplog")

__all__ = ["APIServer"]


def _convert_field_selector(apisrv, version: str, resource: str,
                            sel: str) -> str:
    """Rewrite a field selector from the request version's label vocabulary
    to the internal one (ref: pkg/api/v1beta1/conversion.go field-label
    conversion funcs; registered per kind in api/latest.py)."""
    from kubernetes_tpu_torch.api.fields import FieldSelector, parse_field_selector

    try:
        _, registry = apisrv.master._registry(resource)
        obj_type = registry.obj_type
        kind = getattr(obj_type, "kind", "") or obj_type.__name__
    except Exception:
        return sel
    try:
        fs = parse_field_selector(sel)
    except ValueError:
        return sel  # the registry layer surfaces the parse error uniformly
    out = []
    for f, op, v in fs.requirements:
        nf, nv = apisrv.scheme.convert_field_label(version, kind, f, v)
        out.append((nf, op, nv))
    return str(FieldSelector(out))


def _merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch (ref: resthandler.go:205 PatchResource)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out


class _FastHeaders:
    """Case-insensitive header mapping with the small API surface the
    handlers use (.get/.items/in). Replaces the stdlib email-parser
    message object, which costs ~0.2ms per request at churn rates."""

    __slots__ = ("_h",)

    def __init__(self, lower_to_pairs: dict):
        self._h = lower_to_pairs  # lower-name -> (original name, value)

    def get(self, name, default=None):
        pair = self._h.get(name.lower())
        return pair[1] if pair is not None else default

    def __contains__(self, name) -> bool:
        return name.lower() in self._h

    def __getitem__(self, name):
        return self._h[name.lower()][1]

    def items(self):
        return [(n, v) for n, v in self._h.values()]

    def keys(self):
        return [n for n, _ in self._h.values()]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # keep-alive clients see headers and body as separate writes; without
    # NODELAY, Nagle + the client's delayed ACK makes every kept-alive
    # request a ~40ms round trip
    disable_nagle_algorithm = True
    server_version = "kubernetes-tpu-apiserver"

    def parse_request(self) -> bool:
        """Lean replacement for the stdlib parse (same observable
        behavior for HTTP/1.0-1.1 clients: keep-alive semantics, Expect:
        100-continue, 431 on oversized headers). The stdlib path builds
        an email.message.Message per request via feedparser — measurably
        the single biggest fixed cost per request under churn."""
        self.command = None
        self.request_version = "HTTP/0.9"
        self.close_connection = True
        requestline = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
        self.requestline = requestline
        words = requestline.split()
        if len(words) == 3:
            command, path, version = words
            if not version.startswith("HTTP/"):
                self.send_error(400, f"Bad request version ({version!r})")
                return False
        elif len(words) == 2:
            command, path = words
            version = "HTTP/0.9"
            if command != "GET":
                self.send_error(400,
                                f"Bad HTTP/0.9 request type ({command!r})")
                return False
        else:
            self.send_error(400, f"Bad request syntax ({requestline!r})")
            return False
        self.command, self.path, self.request_version = command, path, version

        headers: dict = {}
        n_lines = 0
        while True:
            line = self.rfile.readline(65537)
            if len(line) > 65536:
                self.send_error(431, "Header line too long")
                return False
            if line in (b"\r\n", b"\n", b""):
                break
            n_lines += 1
            if n_lines > 200:  # bound header LINES, not dict entries —
                self.send_error(431, "Too many headers")  # joins don't grow it
                return False
            name, sep, value = line.decode("iso-8859-1").partition(":")
            if not sep:
                self.send_error(400, "Malformed header line")
                return False
            name = name.strip()
            lname = name.lower()
            prev = headers.get(lname)
            if prev is None:
                headers[lname] = (name, value.strip())
            elif lname == "content-length":
                # RFC 7230 §3.3.2: repeats must be identical; a joined value
                # would fail int() later, so reject differing repeats here
                if value.strip() != prev[1]:
                    self.send_error(400, "Conflicting Content-Length")
                    return False
            else:  # RFC 7230 §3.2.2: join repeats with ", "
                headers[lname] = (prev[0], prev[1] + ", " + value.strip())
        self.headers = _FastHeaders(headers)

        # bodies are framed by Content-Length only; a chunked body would be
        # left unread in rfile and desync the kept-alive stream (CL.TE
        # smuggling, RFC 7230 §3.3.3) — refuse rather than desync
        te = headers.get("transfer-encoding")
        if te is not None and te[1].strip().lower() not in ("", "identity"):
            self.send_error(501, "Transfer-Encoding not supported")
            return False

        conntokens = [t.strip() for t in
                      (self.headers.get("Connection") or "").lower().split(",")]
        if "close" in conntokens:
            self.close_connection = True
        elif version >= "HTTP/1.1" or ("keep-alive" in conntokens
                                       and self.protocol_version >= "HTTP/1.1"):
            self.close_connection = False
        expect = [t.strip() for t in
                  self.headers.get("Expect", "").lower().split(",")]
        if ("100-continue" in expect
                and self.protocol_version >= "HTTP/1.1"
                and version >= "HTTP/1.1"):
            if not self.handle_expect_100():
                return False
        return True

    # ----- plumbing -------------------------------------------------------

    def log_message(self, fmt, *args):  # ref: pkg/httplog — route to hook
        log = self.server.api.request_log  # type: ignore[attr-defined]
        if log is not None:
            log("%s %s" % (self.address_string(), fmt % args))

    def _send_json(self, code: int, payload: str, extra_headers=()):
        body = payload.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, ctype="text/plain; charset=utf-8"):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_status_error(self, e: errors.StatusError, version: str,
                           extra_headers=()):
        apisrv = self.server.api  # type: ignore[attr-defined]
        try:
            payload = apisrv.scheme.encode(e.status, version)
        except Exception:
            payload = json.dumps({"kind": "Status", "status": "Failure",
                                  "message": str(e), "code": e.code})
        self._send_json(e.code, payload, extra_headers=extra_headers)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    # ----- verb entry points ---------------------------------------------

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_PATCH(self):
        self._route("PATCH")

    def do_DELETE(self):
        self._route("DELETE")

    def do_OPTIONS(self):
        # CORS preflight (ref: handlers.go:140-144): an allowed origin gets
        # its headers and stops at 204; anything else keeps the pre-CORS
        # behavior — a plain 501 Unsupported method, never dispatched
        apisrv = self.server.api  # type: ignore[attr-defined]
        started = time.monotonic()
        resource = ([p for p in self.path.split("/") if p] + ["", "", ""])[2]
        self._read_body()  # keep-alive hygiene, like _route
        rl = apisrv.rate_limiter
        if self._cors_check():
            # allowed-origin preflight: answered WITHOUT consuming a
            # rate-limit token. A preflight is browser-generated, touches
            # no store state, and costs one header block — metering it
            # would let anonymous OPTIONS bursts starve the throttled
            # port's reads of tokens, while refusing it (on the read-only
            # port) would break the non-simple GETs (Authorization,
            # X-Requested-With, ...) whose headers this server itself
            # advertises in _CORS_HEADERS
            code = 204
            self.send_response(code)
            self.send_header("Content-Length", "0")
            self.end_headers()
        elif apisrv.read_only:
            # ReadOnly(RateLimit(handler)) nesting for everything else: a
            # non-preflight OPTIONS is a write-shaped method and the
            # GET-only gate rejects it BEFORE the limiter, so it can never
            # drain tokens legitimate reads need
            code = 403
            self._send_status_error(
                errors.new_forbidden("", "", "this is a read-only endpoint"),
                apisrv.default_version)
        elif rl is not None and not rl.can_accept():
            code = 429
            hint = apisrv.retry_after_hint()
            self._send_status_error(
                errors.new_too_many_requests(retry_after_s=hint),
                apisrv.default_version,
                extra_headers=(("Retry-After", str(hint)),))
        else:
            code = 501
            self.send_error(code, "Unsupported method ('OPTIONS')")
        # preflights are real traffic: browsers send one before every
        # non-simple request — record them like every other response
        apisrv.metric_requests.inc("options", resource,
                                   self.client_address[0], str(code))
        apisrv.metric_latency.observe(time.monotonic() - started,
                                      "options", resource)
        _httplog.log(logging.DEBUG, "OPTIONS %s -> %d from %s",
                     self.path, code, self.client_address[0])

    # ----- CORS (ref: pkg/apiserver/handlers.go CORS) ---------------------

    _CORS_METHODS = "POST, GET, OPTIONS, PUT, DELETE"
    _CORS_HEADERS = ("Content-Type, Content-Length, Accept-Encoding, "
                     "X-CSRF-Token, Authorization, X-Requested-With, "
                     "If-Modified-Since")

    def _cors_check(self) -> bool:
        """Remember the request Origin when it matches the allow-list; the
        end_headers hook then stamps the CORS headers on whatever response
        the handler writes."""
        self._cors_origin = None
        patterns = self.server.api.cors_patterns  # type: ignore[attr-defined]
        self._cors_enabled = bool(patterns)
        if not patterns:
            return False
        origin = self.headers.get("Origin") or ""
        # fullmatch, not search: these responses carry Allow-Credentials,
        # and an unanchored pattern like "https://example.com" would also
        # grant a lookalike origin ("https://example.com.evil.net") the
        # browser's credentialed trust. Patterns are anchored at both ends;
        # authors who want subdomains say so explicitly (".*\.example\.com")
        if origin and any(p.fullmatch(origin) for p in patterns):
            self._cors_origin = origin
            return True
        return False

    def end_headers(self):
        if getattr(self, "_cors_enabled", False):
            # responses differ by Origin whenever CORS is on (headers
            # present vs absent, and the reflected origin value): caches
            # must key on it or one origin's variant poisons another's
            self.send_header("Vary", "Origin")
            self._cors_enabled = False
        origin = getattr(self, "_cors_origin", None)
        if origin:
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Methods", self._CORS_METHODS)
            self.send_header("Access-Control-Allow-Headers", self._CORS_HEADERS)
            self.send_header("Access-Control-Allow-Credentials", "true")
            self._cors_origin = None  # once per response
        super().end_headers()

    # ----- routing --------------------------------------------------------

    def _route(self, method: str):
        apisrv = self.server.api  # type: ignore[attr-defined]
        started = time.monotonic()
        parsed = urllib.parse.urlsplit(self.path)
        # handlers use the single-value view; the node/pod proxy forwards
        # the raw pairs so repeated params (exec argv) survive
        self._raw_query_pairs = urllib.parse.parse_qsl(parsed.query)
        # first-value view from the pairs already parsed (the stdlib
        # parse_qs would re-parse the query string a second time)
        query: dict = {}
        for k, v in self._raw_query_pairs:
            if k not in query:
                query[k] = v
        parts = [p for p in parsed.path.split("/") if p]
        self._cors_check()   # stamps headers on the response if allowed
        code = 200
        self._fs_ticket = None   # per-request (keep-alive reuses self)
        verb_label = method.lower()
        self._metric_resource = (parts + ["", "", ""])[2]
        # Always drain the body up front: unread bytes would desync the
        # keep-alive connection (next request parses them as a request line).
        raw_body = self._read_body()
        # kube-trace: a request carrying X-KTPU-Trace joins its caller's
        # trace (the scheduler wave's commit leg, a client's list). Only
        # traced requests record spans — untraced churn traffic must not
        # fill the ring. One header lookup when tracing is on; zero cost
        # when off.
        self._trace_ctx = tracing.parse(
            self.headers.get(tracing.HEADER)) if tracing.enabled() else None
        try:
            # read-only / rate-limit serving modes. The reference nests
            # ReadOnly(RateLimit(handler)) (handlers.go, wired by
            # cmd/kube-apiserver onto the ro port), so the GET-only check
            # runs FIRST: a rejected write must not consume a token that a
            # legitimate read could have used.
            if apisrv.read_only and method != "GET":
                raise errors.new_forbidden(
                    "", "", "this is a read-only endpoint")
            rl = apisrv.rate_limiter
            if rl is not None and not rl.can_accept():
                code = 429
                hint = apisrv.retry_after_hint()
                self._send_status_error(
                    errors.new_too_many_requests(retry_after_s=hint),
                    self._version_of(parts),
                    extra_headers=(("Retry-After", str(hint)),))
                return
            # kube-fairshed flow-classified admission (docs/design/
            # apiserver-hotpath.md): classify by path/user-agent, take
            # (or wait for) an inflight slot in the request's OWN flow,
            # shed with 429 + a measured-drain Retry-After when the
            # flow's queue or the workload backlog governor says no.
            # System traffic never waits on lower bands — isolation is
            # per-flow by construction.
            fs = apisrv.fairshed
            flow = ""
            if fs is not None:
                flow = fairshed_mod.classify(
                    method, parts, self.headers.get("User-Agent"))
                _head, res, sub = fairshed_mod.route_info(parts)
                try:
                    self._fs_ticket = fs.admit(
                        flow, pod_create=(method == "POST"
                                          and res == "pods" and not sub))
                except fairshed_mod.Shed as e:
                    code = 429
                    hint = max(1, int(-(-e.retry_after_s // 1)))
                    self._send_status_error(
                        errors.new_too_many_requests(
                            f"{e.flow} flow over capacity "
                            f"({e.reason}); retry in {hint}s",
                            retry_after_s=hint),
                        self._version_of(parts),
                        extra_headers=(("Retry-After", str(hint)),))
                    return
            user = self._authenticate(apisrv)
            # kube-chaos gray-latency twins: the harness's
            # component@T:delay=MS schedule pauses a live process; these
            # seams inject the same stall in-process so tier-1 proves
            # flow isolation under slowness without process churn
            chaos.delay_if_armed("apiserver.dispatch")
            if flow:
                chaos.delay_if_armed("apiserver.dispatch." + flow)
            if self._trace_ctx is not None:
                with tracing.span("http." + verb_label,
                                  parent=self._trace_ctx,
                                  path=parsed.path):
                    code = self._dispatch_path(method, parts, query, user,
                                               raw_body)
            else:
                code = self._dispatch_path(method, parts, query, user,
                                           raw_body)
        except errors.StatusError as e:
            code = e.code
            self._send_status_error(e, self._version_of(parts))
        except (BrokenPipeError, ConnectionResetError):
            # the client left, or a dependency reset mid-request: nothing
            # was answered, so end the connection rather than read the
            # next request on it while the client waits for this answer
            code = 499
            self.close_connection = True
        except Exception as e:  # ref: util.HandleCrash — 500, keep serving
            code = 500
            try:
                self._send_status_error(errors.new_internal_error(repr(e)),
                                        self._version_of(parts))
            except Exception:
                pass
        finally:
            ticket = self._fs_ticket
            if ticket is not None:
                ticket.release()   # idempotent: watches released early
            apisrv.metric_requests.inc(verb_label, self._metric_resource,
                                       self.client_address[0], str(code))
            elapsed = time.monotonic() - started
            apisrv.metric_latency.observe(elapsed, verb_label,
                                          self._metric_resource)
            # request log (ref: pkg/httplog/log.go — method, path, status,
            # latency per request; DEBUG so production defaults stay quiet
            # like glog's v-levels, errors at INFO)
            _httplog.log(
                logging.INFO if code >= 500 else logging.DEBUG,
                "%s %s -> %d (%.1fms) from %s", method, self.path, code,
                elapsed * 1000.0, self.client_address[0])

    def _version_of(self, parts) -> str:
        apisrv = self.server.api  # type: ignore[attr-defined]
        if len(parts) >= 2 and parts[0] == "api" and parts[1] in apisrv.versions:
            return parts[1]
        return apisrv.default_version

    def _authenticate(self, apisrv):
        authn = apisrv.authenticator
        if authn is None:
            return None
        peer_cert = None
        if hasattr(self.connection, "getpeercert"):
            try:
                peer_cert = self.connection.getpeercert()
            except Exception:
                peer_cert = None
        req = AuthRequest(headers=dict(self.headers.items()), peer_cert=peer_cert)
        info, ok = authn.authenticate(req)
        if not ok:
            raise errors.new_unauthorized()
        return info

    def _dispatch_path(self, method: str, parts, query: Dict[str, str], user,
                       raw_body: bytes = b"") -> int:
        apisrv = self.server.api  # type: ignore[attr-defined]

        if not parts:
            self._send_json(200, json.dumps(
                {"paths": ["/api", "/healthz", "/metrics", "/ui/",
                           "/validate", "/version"]}))
            return 200
        head = parts[0]
        if head in ("ui", "static"):  # ref: pkg/ui served at /static/
            if method != "GET":
                raise errors.new_method_not_supported("asset", method)
            from kubernetes_tpu_torch.ui import asset
            found = asset("/".join(parts[1:]))
            if found is None:
                raise errors.new_not_found("asset", "/".join(parts[1:]))
            body, ctype = found
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return 200
        if head == "healthz":
            return self._handle_healthz(parts[1:])
        if head == "version":
            self._send_json(200, json.dumps(version_pkg.get().as_dict()))
            return 200
        if head == "metrics":
            payload = apisrv.metrics_registry.render_text()
            # the process-wide default registry carries the watch-package
            # loss counters (watch_events_dropped/coalesced, lag resyncs)
            # — surface them alongside the per-server families
            default_reg = metrics_pkg.default_registry()
            if default_reg is not apisrv.metrics_registry:
                payload += default_reg.render_text()
            self._send_text(200, payload,
                            ctype="text/plain; version=0.0.4; charset=utf-8")
            return 200
        if head == "validate":
            payload, ok = apisrv.validate_components()
            self._send_json(200 if ok else 500, json.dumps(payload))
            return 200 if ok else 500
        if head == "debug" and len(parts) >= 2 and parts[1] == "pprof":
            return self._handle_pprof(parts[2:], query)
        if head == "debug" and len(parts) >= 2 and parts[1] == "vars":
            # kube-flightrec shard: this process's metric time-series
            # rings, incremental past the caller's ?since=<ns> cursor.
            # The first pull ARMS the recorder (lazily, like the span
            # ring) so aggregator discovery is also activation.
            if method != "GET":
                raise errors.new_method_not_supported("vars", method)
            try:
                since = int(query.get("since", "0") or "0")
            except ValueError:
                since = 0
            self._send_json(200, json.dumps(self.server.api.flightrec_vars(
                since)))
            return 200
        if head == "debug" and len(parts) >= 2 and parts[1] == "trace":
            # drain this process's span ring (kube-trace shard); the churn
            # harness merges every process's shard into one Perfetto file.
            # ?peek=1 reads without resetting the drain cursor.
            if method != "GET":
                raise errors.new_method_not_supported("trace", method)
            self._send_json(200, json.dumps(tracing.drain(
                reset=query.get("peek") not in ("1", "true"))))
            return 200
        if head != "api":
            raise errors.new_not_found("path", "/" + "/".join(parts))
        if len(parts) == 1:
            self._send_json(200, json.dumps({"versions": list(apisrv.versions)}))
            return 200

        version = parts[1]
        if version not in apisrv.versions:
            raise errors.new_not_found("apiVersion", version)
        rest = parts[2:]

        watching = query.get("watch") in ("true", "1")
        if rest and rest[0] == "watch":  # /api/{v}/watch/... prefix form
            watching = True
            rest = rest[1:]
        if rest and rest[0] in ("proxy", "redirect"):
            return self._handle_proxy_redirect(rest[0], version, rest[1:],
                                               query, user, method, raw_body)

        # the batch-bind verb-suffix route: "bindings:batch" is one path
        # segment; normalize it to the bindings resource before namespace
        # scoping so both path-ns and query-ns forms resolve
        batch_bind = "bindings:batch" in rest
        if batch_bind:
            rest = ["bindings" if seg == "bindings:batch" else seg
                    for seg in rest]

        # namespace from path (v1-style) or query param (v1beta1-style).
        # /namespaces/{name}[/finalize] stays the namespaces resource itself;
        # /namespaces/{ns}/{known-resource}/... scopes the request.
        namespace = query.get("namespace", "")
        if rest and rest[0] == "namespaces" and len(rest) >= 3 \
                and apisrv.is_resource(rest[2]):
            namespace, rest = rest[1], rest[2:]
        if not rest:
            raise errors.new_bad_request("no resource in path")
        resource = rest[0]
        self._metric_resource = resource
        name = rest[1] if len(rest) > 1 else ""
        subresource = rest[2] if len(rest) > 2 else ""

        if batch_bind:
            if resource != "bindings" or name or watching:
                raise errors.new_bad_request(
                    "the :batch suffix applies to POST .../bindings:batch")
            self._metric_resource = "bindings:batch"
            if method != "POST":
                raise errors.new_method_not_supported("bindings:batch",
                                                      method)
            return self._handle_batch_bind(version, namespace, raw_body,
                                           user)

        label_sel = query.get("labelSelector", query.get("labels", ""))
        field_sel = query.get("fieldSelector", query.get("fields", ""))
        rv = query.get("resourceVersion", "")
        if field_sel:
            # field labels are a per-version vocabulary (v1beta1
            # "DesiredState.Host" == internal "spec.host"; ref:
            # pkg/api/v1beta1/conversion.go field-label funcs)
            field_sel = _convert_field_selector(apisrv, version, resource,
                                                field_sel)

        if watching:
            if method != "GET":
                raise errors.new_bad_request("watch requires GET")
            if name:  # single-object watch scopes by name
                field_sel = f"metadata.name={name}"
            watcher, translate = apisrv.master.dispatch(
                "watch_raw", resource, namespace=namespace,
                label_selector=label_sel, field_selector=field_sel,
                resource_version=rv, user=user,
                lag_limit=apisrv.watch_lag_limit)
            self._stream_watch(watcher, translate, version,
                               gate_tag=query.get("chaosGate", ""))
            return 200

        body_obj = None
        if method in ("POST", "PUT", "PATCH"):
            if method == "PATCH":
                return self._handle_patch(version, resource, namespace, name,
                                          subresource, raw_body, user)
            if raw_body:
                try:
                    body_obj = apisrv.scheme.decode(
                        raw_body, default_version=version)
                except Exception as e:
                    raise errors.new_bad_request(f"cannot decode body: {e}")

        verb = {"GET": "get" if name else "list", "POST": "create",
                "PUT": "update", "DELETE": "delete"}[method]
        out = apisrv.master.dispatch(
            verb, resource, namespace=namespace, name=name, body=body_obj,
            subresource=subresource, label_selector=label_sel,
            field_selector=field_sel, user=user)
        code = 201 if verb == "create" else 200
        fs = apisrv.fairshed
        if fs is not None and resource == "pods":
            # workload backlog governor ledger: pods entering the
            # pending set, pods bound (the per-pod binding subresource;
            # the batch endpoint counts its own), pods leaving
            if verb == "create" and not subresource:
                fs.note_pod_created()
            elif verb == "create" and subresource == "binding":
                fs.note_pods_bound(1)
            elif verb == "delete" and not subresource:
                fs.note_pod_deleted()
        if out is None:
            ok = api.Status(status=api.StatusSuccess, code=code)
            self._send_json(code, apisrv.scheme.encode(ok, version))
        else:
            # encode_response seeds the watch frame cache with this very
            # payload: the fan-out of the store event this write produced
            # then copies bytes instead of encoding again
            self._send_json(code, apisrv.encode_response(out, version))
        return code

    def _handle_batch_bind(self, version: str, namespace: str,
                           raw_body: bytes, user) -> int:
        """POST .../bindings:batch — one scheduler wave of CAS binds in
        ONE keep-alive request (the bind_many seam's wire form). Body:
        BindingList; response: 200 BindingResultList with per-item
        status/code — partial success, per-pod CAS semantics identical
        to POST pods/{name}/binding."""
        apisrv = self.server.api  # type: ignore[attr-defined]
        started = time.monotonic()
        if not raw_body:
            raise errors.new_bad_request(
                "bindings:batch requires a BindingList body")
        try:
            body = apisrv.scheme.decode(raw_body, default_version=version)
        except Exception as e:
            raise errors.new_bad_request(f"cannot decode body: {e}")
        if isinstance(body, api.Binding):
            body = api.BindingList(items=[body])
        if not isinstance(body, api.BindingList):
            raise errors.new_bad_request(
                "bindings:batch body must be a BindingList")
        out = apisrv.master.bind_batch(
            namespace or api.NamespaceDefault, body, user=user,
            # encode-once at commit: each bound pod's new revision is
            # serialized here, where the write lands, so the watch fan-out
            # of its CAS event is a byte copy for every watcher
            on_bound=lambda pod: apisrv.seed_frame(pod, version))
        payload = apisrv.scheme.encode(out, version)
        if apisrv.fairshed is not None:
            bound = sum(1 for item in out.items if not item.error)
            apisrv.fairshed.note_pods_bound(bound)
        apisrv.metric_batch_bind_size.observe(len(body.items))
        apisrv.metric_batch_bind_seconds.observe(time.monotonic() - started)
        self._send_json(200, payload)
        return 200

    def _handle_patch(self, version, resource, namespace, name, subresource,
                      raw: bytes, user) -> int:
        """JSON merge patch: read-modify-write through the codec
        (ref: resthandler.go PatchResource:205)."""
        apisrv = self.server.api  # type: ignore[attr-defined]
        if not name:
            raise errors.new_bad_request("PATCH requires a resource name")
        try:
            patch = json.loads(raw.decode("utf-8"))
        except Exception as e:
            raise errors.new_bad_request(f"cannot decode patch: {e}")
        current = apisrv.master.dispatch("get", resource, namespace=namespace,
                                         name=name, user=user)
        wire = json.loads(apisrv.scheme.encode(current, version))
        merged = _merge_patch(wire, patch)
        try:
            obj = apisrv.scheme.decode(json.dumps(merged), default_version=version)
        except Exception as e:
            raise errors.new_bad_request(f"patched object invalid: {e}")
        out = apisrv.master.dispatch("update", resource, namespace=namespace,
                                     name=name, body=obj,
                                     subresource=subresource, user=user)
        self._send_json(200, apisrv.scheme.encode(out, version))
        return 200

    def _handle_healthz(self, subpath) -> int:
        """Deep health (ref: pkg/healthz grown toward ComponentStatus):
        /healthz probes the components this server actually depends on —
        store reachability and watch-hub liveness — and answers 503 with
        the per-component verdicts when any fails. /healthz/ping stays
        the unconditional liveness answer (process up, serving)."""
        if subpath and subpath[0] == "ping":
            self._send_text(200, "ok")
            return 200
        payload, ok = self.server.api.health_components()
        code = 200 if ok else 503
        self._send_json(code, json.dumps(payload))
        return code

    # ----- watch streaming (ref: pkg/apiserver/watch.go:62-142) ----------

    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _handle_pprof(self, rest, query) -> int:
        """ref: pprof endpoints every reference binary exposes
        (pkg/master/master.go:431-435)."""
        from kubernetes_tpu_torch.util import pprof

        which = rest[0] if rest else ""
        body = pprof.handle(which, query.get("seconds", ""),
                            query.get("format", ""))
        if body is None:
            raise errors.new_not_found("pprof", which)
        self._send_text(200, body)
        return 200

    def _translate_batch(self, batch, translate, version, ws_frames: bool):
        """Map one drained batch of raw store events to wire byte parts.
        Returns (parts, lagged): ``lagged`` means the bounded-lag resync
        marker was hit — its 410 ERROR frame is the last part and the
        stream must end. The encode (if any) happens here exactly once
        per (revision, version); every other watcher of the same event
        copies cached bytes."""
        apisrv = self.server.api  # type: ignore[attr-defined]
        idx = 2 if ws_frames else 1
        parts = []
        for ev in batch:
            if ev.type == watchpkg.ERROR and ev.object is None:
                # bounded-lag drop-to-resync marker from the store layer
                parts.append(apisrv.lag_resync_entry(version)[idx])
                apisrv.metric_watch_lag_drops.inc()
                return parts, True
            try:
                tev = translate(ev)
                if tev is None:
                    continue
                if isinstance(tev, tuple):  # fast path: (type, rv, thunk)
                    ev_type, rv, thunk = tev
                    parts.append(
                        apisrv.frame_entry(ev_type, thunk, version,
                                           rv=rv)[idx])
                else:
                    parts.append(apisrv.frame_entry(tev.type, tev.object,
                                                    version)[idx])
            except Exception as e:  # undecodable payload: surface, keep going
                parts.append(apisrv.frame_entry(
                    watchpkg.ERROR,
                    errors.new_internal_error(str(e)).status, version)[idx])
        return parts, False

    def _stream_watch(self, watcher: watchpkg.Watcher, translate,
                      version: str, gate_tag: str = ""):
        """Chunked-JSON watch stream as a byte WRITER: this connection's
        thread drains raw store events in batches, maps them through the
        shared frame-bytes cache, and writes each batch with ONE send —
        no per-watcher pump thread, no per-watcher encode, one syscall
        per batch instead of four per event
        (ref: pkg/apiserver/watch.go:62-142).

        ``gate_tag`` (the ``chaosGate`` query param) names an optional
        chaos gate this writer parks on before draining: a test can hold
        ONE watcher's consumer still — deterministically growing the
        producer-side queue past lag_limit — while siblings stream
        freely. Untagged watchers never touch the seam."""
        from kubernetes_tpu_torch.util import websocket as ws

        if ws.wants_websocket(self.headers):
            return self._stream_watch_websocket(watcher, translate, version)
        apisrv = self.server.api  # type: ignore[attr-defined]
        apisrv.track_watcher(watcher)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        if getattr(self, "_trace_ctx", None) is not None:
            # echo the stream's trace context so the client can stamp
            # frame-observation spans onto the same trace
            self.send_header(tracing.HEADER, tracing.wire(self._trace_ctx))
        self.end_headers()
        # fairshed: the admission slot covered the watch SETUP; the
        # long-lived stream itself must not pin an inflight slot (the
        # scheduler's reflectors live for the whole run — they would
        # permanently exhaust the system budget)
        ticket = getattr(self, "_fs_ticket", None)
        if ticket is not None:
            ticket.release()
        try:
            lagged = False
            while not lagged:
                if gate_tag:
                    chaos.gate_if_armed("apiserver.watch.write." + gate_tag)
                batch = watcher.next_batch(
                    linger=apisrv.watch_write_linger)
                if batch is None:
                    break
                t0 = time.monotonic()
                parts, lagged = self._translate_batch(batch, translate,
                                                      version, ws_frames=False)
                if parts:
                    apisrv.metric_fanout_frames.observe(len(parts))
                    self.wfile.write(b"".join(parts))
                    self.wfile.flush()
                    apisrv.metric_fanout_seconds.observe(
                        time.monotonic() - t0)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            pass
        finally:
            watcher.stop()
            apisrv.untrack_watcher(watcher)
            self.close_connection = True

    def _stream_watch_websocket(self, watcher: watchpkg.Watcher, translate,
                                version: str):
        """Watch events as WebSocket text frames, one event per message,
        batches of cached frame bytes per send like the chunked variant
        (ref: pkg/apiserver/watch.go:62-126 — the websocket variant the
        reference serves alongside chunked JSON, negotiated by Upgrade)."""
        from kubernetes_tpu_torch.util import websocket as ws

        apisrv = self.server.api  # type: ignore[attr-defined]
        apisrv.track_watcher(watcher)
        self.send_response_only(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", ws.accept_key(
            self.headers.get("Sec-WebSocket-Key", "")))
        if getattr(self, "_trace_ctx", None) is not None:
            self.send_header(tracing.HEADER, tracing.wire(self._trace_ctx))
        self.end_headers()
        # fairshed: release the admission slot at stream start, like the
        # chunked variant — a long-lived stream never pins inflight
        ticket = getattr(self, "_fs_ticket", None)
        if ticket is not None:
            ticket.release()

        # one writer lock: PONGs from the reader thread and event frames
        # from this thread interleave bytes otherwise (sendall is not
        # atomic once the TCP send buffer fills)
        wlock = threading.Lock()

        # client frames: PING -> PONG, CLOSE (or EOF) -> stop the watcher
        def reader():
            try:
                while True:
                    frame = ws.read_frame(self.rfile)
                    if frame is None or frame[0] == ws.OP_CLOSE:
                        break
                    if frame[0] == ws.OP_PING:
                        with wlock:
                            ws.send_pong(self.wfile, frame[1])
            except OSError:
                pass
            finally:
                watcher.stop()

        threading.Thread(target=reader, daemon=True,
                         name="ws-watch-reader").start()
        try:
            lagged = False
            while not lagged:
                batch = watcher.next_batch(
                    linger=apisrv.watch_write_linger)
                if batch is None:
                    break
                t0 = time.monotonic()
                parts, lagged = self._translate_batch(batch, translate,
                                                      version, ws_frames=True)
                if parts:
                    apisrv.metric_fanout_frames.observe(len(parts))
                    with wlock:
                        self.wfile.write(b"".join(parts))
                        self.wfile.flush()
                    apisrv.metric_fanout_seconds.observe(
                        time.monotonic() - t0)
            with wlock:
                ws.send_close(self.wfile)
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            pass
        finally:
            watcher.stop()
            apisrv.untrack_watcher(watcher)
            self.close_connection = True
        return 101

    # ----- proxy / redirect (ref: pkg/apiserver/{proxy,redirect}.go) -----

    def _handle_proxy_redirect(self, mode: str, version: str, rest, query,
                               user, method: str = "GET",
                               raw_body: bytes = b"") -> int:
        apisrv = self.server.api  # type: ignore[attr-defined]
        namespace = query.get("namespace", "")
        if rest and rest[0] == "namespaces" and len(rest) >= 3:
            namespace, rest = rest[1], rest[2:]
        if len(rest) < 2:
            raise errors.new_bad_request(f"{mode} needs /{{resource}}/{{name}}")
        resource, name, tail = rest[0], rest[1], rest[2:]
        location = apisrv.resource_location(resource, namespace, name, user)
        if location is None:
            raise errors.new_not_found(resource, name)
        target = f"http://{location}/" + "/".join(tail)
        # forward the original query pairs (ref: proxy.go) — repeated keys
        # (e.g. exec's cmd= argv) must survive verbatim
        fwd_pairs = [(k, v) for k, v in getattr(self, "_raw_query_pairs", [])
                     if k != "namespace"]
        if fwd_pairs:
            target += "?" + urllib.parse.urlencode(fwd_pairs)
        if mode == "redirect":
            self.send_response(307)
            self.send_header("Location", target)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return 307
        try:
            # forward the incoming method and body verbatim (ref: proxy.go
            # ServeHTTP builds the backend request from the original) — a bare
            # urlopen(target) would turn every proxied POST into a GET
            fwd = urllib.request.Request(
                target, data=raw_body if raw_body else None, method=method)
            ctype = self.headers.get("Content-Type")
            if ctype and raw_body:
                fwd.add_header("Content-Type", ctype)
            resp = urllib.request.urlopen(fwd, timeout=10)
        except urllib.error.HTTPError as e:
            resp = e  # backend errors relay verbatim (exec exit!=0 is a 500)
        except Exception as e:
            raise errors.new_internal_error(f"proxy to {target} failed: {e}")
        with resp:
            body = resp.read()
            status = resp.status if hasattr(resp, "status") else resp.code
            self.send_response(status)
            self.send_header("Content-Type",
                             resp.headers.get("Content-Type", "text/plain"))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return status


class APIServer:
    """The serving front half of the master (ref: master.go:398-490 route
    installation + cmd/kube-apiserver). Wraps a Master with HTTP."""

    def __init__(self, master, host: str = "127.0.0.1", port: int = 0,
                 authenticator=None, request_log=None, ssl_context=None,
                 metrics_registry: Optional[metrics_pkg.Registry] = None,
                 node_locator=None, kubelet_port: int = 10250,
                 reuse_port: bool = False, cors_allowed_origins=(),
                 read_only: bool = False, rate_limiter=None,
                 watch_lag_limit: int = 65536, fairshed=None, share=None):
        self.master = master
        # kube-share cross-worker side channel (apiserver/share.py;
        # None on single-worker servers — zero cost): the write path
        # publishes every seeded encoding into this worker's ring, and
        # the fan-out's wire-cache misses drain sibling rings before
        # falling back to a local encode.
        self.share = share
        # kube-fairshed flow-classified admission (apiserver/fairshed.py;
        # None disables — zero cost on the request path). The binary
        # enables it by default; the overload harness adds the workload
        # backlog governor on top.
        self.fairshed = fairshed
        # per-HTTP-watcher queue bound: past it, modify events coalesce and
        # anything uncoalescible drops the watcher to resync (410 ERROR
        # frame + end-of-stream; the client re-lists). 0/None disables.
        # The queue holds shared StoreEvent references (bytes are only
        # rendered at write time), so the default is sized as a
        # stuck-watcher safety valve, NOT burst shedding: a commit wave
        # fanning thousands of events at a busy-but-draining consumer
        # (the scheduler's own reflectors) must ride the queue, while a
        # watcher minutes behind gets the 410 and re-lists.
        self.watch_lag_limit = watch_lag_limit or None
        # fan-out write linger: accumulate this long after a batch's
        # first event before draining+writing, so a steady event stream
        # costs each watcher one wakeup and one syscall per BATCH, not
        # per event (see Watcher.next_batch)
        self.watch_write_linger = 0.004
        # CORS origin allow-list, each entry a regex (ref: handlers.go CORS
        # + --cors_allowed_origins; empty list = CORS disabled)
        self.cors_patterns = [re.compile(p) for p in cors_allowed_origins]
        # the kubernetes-ro serving mode (ref: handlers.go ReadOnly +
        # RateLimit; wired by cmd/kube-apiserver onto --read_only_port):
        # GETs only, optionally throttled by a token bucket
        self.read_only = read_only
        self.rate_limiter = rate_limiter
        self.node_locator = node_locator
        self.kubelet_port = kubelet_port
        self.scheme = master.scheme
        self.versions = tuple(master.scheme.versions())
        self.default_version = master.scheme.default_version
        self.authenticator = authenticator
        self.request_log = request_log
        self.metrics_registry = metrics_registry or metrics_pkg.Registry()
        # ref: apiserver.go:40-61 request count + latency instrumentation
        self.metric_requests = self.metrics_registry.counter(
            "apiserver_request_count", "Counter of apiserver requests",
            ("verb", "resource", "client", "code"))
        self.metric_latency = self.metrics_registry.histogram(
            "apiserver_request_latencies_seconds", "Request latency",
            ("verb", "resource"), buckets=metrics_pkg.APISERVER_BUCKETS)
        # the apiserver hot-path family (docs/design/apiserver-hotpath.md):
        # frame-cache effectiveness, fan-out write batching, lag drops,
        # and the batch-bind endpoint's size/latency envelope
        self.metric_frame_hits = self.metrics_registry.counter(
            "apiserver_watch_frame_cache_hits_total",
            "Watch frame deliveries served from cached bytes "
            "(no object encode)")
        self.metric_frame_misses = self.metrics_registry.counter(
            "apiserver_watch_frame_cache_misses_total",
            "Watch frame deliveries that had to encode the object")
        self.metric_frame_seeds = self.metrics_registry.counter(
            "apiserver_watch_frame_seeds_total",
            "Frame-cache entries seeded by the write path "
            "(encode-once at commit)")
        self.metric_watch_lag_drops = self.metrics_registry.counter(
            "apiserver_watch_lag_drops_total",
            "Watch streams dropped to resync (410 ERROR frame) after "
            "exceeding the lag bound")
        self.metric_fanout_seconds = self.metrics_registry.histogram(
            "apiserver_watch_fanout_seconds",
            "Translate+write time per fan-out batch to one watcher",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                     0.025, 0.05, 0.1, 0.25, 1.0))
        self.metric_fanout_frames = self.metrics_registry.histogram(
            "apiserver_watch_write_frames",
            "Frames per fan-out write (write-coalescing depth)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.metric_batch_bind_size = self.metrics_registry.histogram(
            "apiserver_batch_bind_size",
            "Bindings per bindings:batch request",
            buckets=(1, 4, 16, 64, 256, 1024, 4096))
        self.metric_batch_bind_seconds = self.metrics_registry.histogram(
            "apiserver_batch_bind_seconds",
            "bindings:batch handler latency",
            buckets=metrics_pkg.DEFAULT_BUCKETS)
        # cross-process cache seeding (apiserver/share.py): frames this
        # worker published for siblings, sibling frames imported into
        # the local wire cache, fan-out deliveries those imports saved
        # from encoding, and ring laps (lost optimisation records)
        self.metric_seed_published = self.metrics_registry.counter(
            "apiserver_cache_seed_published_total",
            "Seeded encodings published into this worker's share ring")
        self.metric_seed_imported = self.metrics_registry.counter(
            "apiserver_cache_seed_imported_total",
            "Sibling-published encodings imported into the wire cache")
        self.metric_seed_hits = self.metrics_registry.counter(
            "apiserver_cache_seed_hits_total",
            "Wire-cache misses resolved by draining sibling rings "
            "(an encode avoided by the cross-process feed)")
        self.metric_seed_ring_drops = self.metrics_registry.counter(
            "apiserver_cache_seed_ring_drops_total",
            "Ring records lost to reader lap (the sibling re-encodes; "
            "correctness unaffected)")
        # worker identity for SO_REUSEPORT fleet scrapes: a /metrics GET
        # lands on an arbitrary worker, so the harness keys its
        # per-worker disclosure on these two gauges
        self.metric_worker_pid = self.metrics_registry.gauge(
            "apiserver_worker_pid", "This worker process's pid")
        self.metric_worker_pid.set(float(os.getpid()))
        self.metric_worker_index = self.metrics_registry.gauge(
            "apiserver_worker_index",
            "Share-segment block index of this worker (-1 = standalone)")
        self.metric_worker_index.set(
            float(share.worker_index) if share is not None else -1.0)
        self._watchers: set = set()
        self._watch_lock = threading.Lock()
        # Encode-once fan-out caches (one lock guards both):
        #  _wire_cache:  (resourceVersion, wire version) -> the object's
        #      wire JSON string. The store's modified_index is globally
        #      unique per revision (and list responses never seed or
        #      fetch), making it a safe fan-out-wide key — the encode
        #      analog of StoreHelper's decode cache. Seeded by the write
        #      path (create/update responses, batch-bind commits) so the
        #      fan-out usually never encodes at all.
        #  _frame_cache: (resourceVersion, event type, wire version) ->
        #      (frame json str, chunked-transfer bytes, websocket frame
        #      bytes) assembled from the wire JSON — every watcher of any
        #      transport writes the same bytes. Both bounded FIFO.
        self._wire_cache: "OrderedDict" = OrderedDict()
        self._frame_cache: "OrderedDict" = OrderedDict()
        self._frame_lock = threading.Lock()
        # serializes sibling-ring drains (the per-process mmap cursors)
        self._share_drain_lock = threading.Lock()
        # (rv, version) -> Event: one fan-out thread encodes a revision,
        # concurrent watchers of the same event wait for its bytes
        # instead of burning the GIL on duplicate encodes
        self._encode_inflight: Dict[tuple, threading.Event] = {}
        self._httpd = ThreadingHTTPServer((host, port), _Handler,
                                          bind_and_activate=False)
        self._httpd.daemon_threads = True
        # listen with the system's largest backlog, as Go's net.Listen
        # does: socketserver's default of 5 drops the SYNs of a burst of
        # new connections (a controller's parallel creates), and each
        # dropped one waits a retransmit of 1 s or more to connect
        self._httpd.request_queue_size = socket.SOMAXCONN
        if reuse_port:
            # several worker processes share one listen port; the kernel
            # load-balances accepts (the multi-worker topology kube-store
            # exists for)
            self._httpd.socket.setsockopt(socket.SOL_SOCKET,
                                          socket.SO_REUSEPORT, 1)
        try:
            self._httpd.server_bind()
            self._httpd.server_activate()
        except BaseException:
            self._httpd.server_close()
            raise
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self._httpd.api = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True, name="apiserver-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._watch_lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def retry_after_hint(self) -> int:
        """Whole-seconds Retry-After for the token-bucket 429 sites
        (read-only port): the limiter's own measured refill delay,
        clamped to [1, 30] — the hardcoded '1' these sites used to ship
        told a dry-bucket client to hammer a throttled port once per
        second forever."""
        rl = self.rate_limiter
        s = 1.0
        if rl is not None and hasattr(rl, "retry_after_s"):
            s = rl.retry_after_s()
        return max(1, min(30, int(-(-s // 1))))

    def is_resource(self, name: str) -> bool:
        try:
            self.master._registry(name)
            return True
        except Exception:
            return False

    # Sized for the lag depth the watch queues allow, not just the event
    # rate: a watcher thousands of events behind must still find the
    # bytes of the revisions it is draining, or every lagging stream
    # re-encodes history (an 8192-entry first cut churned exactly that
    # way at full shape). Entries are shared strings/bytes, ~1-3 KB each.
    _FRAME_CACHE_MAX = 32768
    _WIRE_CACHE_MAX = 65536

    @staticmethod
    def _rv_of(obj) -> str:
        from kubernetes_tpu_torch.api.meta import accessor

        kind = getattr(obj, "kind", "") or type(obj).__name__
        if kind.endswith("List"):
            # a list's resourceVersion is a store INDEX, which an object's
            # modified_index can equal — lists never seed or fetch
            return ""
        try:
            return accessor.resource_version(obj)
        except Exception:
            return ""

    def seed_frame(self, obj, version: str, wire_json: str = "") -> None:
        """Seed the wire cache with one object's encoding — called by the
        WRITE path (create/update responses, batch-bind commits), where
        the bytes are being produced anyway, so the watch fan-out of the
        resulting store event is a pure byte copy (the 'serialize exactly
        once per (resourceVersion, api version)' contract)."""
        rv = self._rv_of(obj)
        if not rv:
            return
        key = (rv, version)
        with self._frame_lock:
            if key in self._wire_cache:
                return
        if not wire_json:
            try:
                wire_json = self.scheme.encode(obj, version)
            except Exception:
                return
        self.metric_frame_seeds.inc()
        with self._frame_lock:
            self._wire_cache[key] = wire_json
            while len(self._wire_cache) > self._WIRE_CACHE_MAX:
                self._wire_cache.popitem(last=False)
            waiter = self._encode_inflight.pop(key, None)
        if waiter is not None:
            waiter.set()  # wake fan-out threads parked on this revision
        if self.share is not None \
                and self.share.publish_frame(rv, version, wire_json):
            # the cross-process analog of the local seed: siblings'
            # fan-outs import these bytes instead of re-encoding
            self.metric_seed_published.inc()

    def encode_response(self, obj, version: str) -> str:
        """Encode a dispatch result for its HTTP response AND seed the
        frame cache with it (single objects only — see seed_frame; a list
        is assembled by encode_list)."""
        if getattr(obj, "items", None):
            return self.encode_list(obj, version)
        payload = self.scheme.encode(obj, version)
        self.seed_frame(obj, version, wire_json=payload)
        return payload

    def encode_list(self, lst, version: str) -> str:
        """``scheme.encode(lst, version)``, byte for byte, with each item's
        bytes taken from the wire cache: an item is its object's encoding
        without the leading apiVersion and kind (the keys are sorted), and
        a revision missing from the cache is encoded once and seeded. A
        controller manager lists every pod each second; without this each
        list encoded every item again. A version that transforms the list
        or its items (the legacy wire: a v1beta1 ``MinionList`` carries
        its nodes twice, under ``items`` and ``minions``, and a legacy
        object's keys sort ``id`` before ``kind``), an item without a
        revision, or one whose encoding does not start as expected,
        encodes the list whole."""
        scheme = self.scheme
        if not scheme.is_identity(version, scheme.object_kind(lst)):
            return scheme.encode(lst, version)
        items = lst.items
        parts = []
        for obj in items:
            rv = self._rv_of(obj)
            kind = scheme.object_kind(obj)
            if not rv or not scheme.is_identity(version, kind):
                return scheme.encode(lst, version)
            obj_json = self._wire_cache.get((rv, version))  # atomic read
            if obj_json is None:
                obj_json = scheme.encode(obj, version)
                self.seed_frame(obj, version, wire_json=obj_json)
            head = '{"apiVersion": "%s", "kind": "%s", ' % (version, kind)
            if not obj_json.startswith(head):
                return scheme.encode(lst, version)
            parts.append("{" + obj_json[len(head):])
        lst.items = []
        try:
            shell = scheme.encode(lst, version)
        finally:
            lst.items = items
        return shell.replace('"items": []',
                             '"items": [' + ", ".join(parts) + "]", 1)

    @staticmethod
    def _assemble(ev_type: str, obj_json: str):
        """(frame json, chunked bytes, ws frame bytes) for one event —
        pure string/byte assembly, no codec work."""
        from kubernetes_tpu_torch.util import websocket as ws

        frame = '{"type": "%s", "object": %s}' % (ev_type, obj_json)
        payload = frame.encode("utf-8")
        body = payload + b"\n"
        chunk = ("%x\r\n" % len(body)).encode("ascii") + body + b"\r\n"
        return frame, chunk, ws.text_frame(payload)

    _ENCODE_FALLBACK = ('{"kind": "Status", "status": "Failure", '
                        '"message": "encode error"}')

    def frame_entry(self, ev_type: str, obj, version: str,
                    rv: Optional[str] = None):
        """(frame json, chunked bytes, ws frame bytes) for one watch
        event, encoded at most once per (object revision, wire version)
        across every watcher and transport (ref: the reference encodes
        per watch connection, pkg/apiserver/watch.go:66 — here the encode
        is the fan-out hot path, so it is deduplicated). Concurrent
        watchers of one event rendezvous on an in-flight marker: one
        encodes, the rest wait for its bytes.

        ``obj`` may be a zero-arg thunk (the fast translate path passes
        ``rv`` explicitly and defers the decode): it is only called when
        the caches miss — a cache-hit delivery touches no codec."""
        lazy = callable(obj) and rv is not None
        if rv is None:
            rv = self._rv_of(obj)
        if not rv:
            # uncacheable payloads (Status objects in ERROR frames)
            try:
                return self._assemble(ev_type,
                                      self.scheme.encode(obj, version))
            except Exception:
                return self._assemble(ev_type, self._ENCODE_FALLBACK)
        fkey = (rv, ev_type, version)
        wkey = (rv, version)
        with self._frame_lock:
            entry = self._frame_cache.get(fkey)
            if entry is not None:
                self.metric_frame_hits.inc()
                return entry
            obj_json = self._wire_cache.get(wkey)
        if obj_json is None and self.share is not None:
            # before paying an encode (or parking on one), drain the
            # sibling rings: the worker that COMMITTED this revision
            # published its bytes at write time
            self._drain_share_seeds()
            with self._frame_lock:
                obj_json = self._wire_cache.get(wkey)
            if obj_json is not None:
                self.metric_seed_hits.inc()
        waiter = leader = None
        if obj_json is None:
            with self._frame_lock:
                obj_json = self._wire_cache.get(wkey)
                if obj_json is None:
                    waiter = self._encode_inflight.get(wkey)
                    if waiter is None:
                        leader = threading.Event()
                        self._encode_inflight[wkey] = leader
        if obj_json is None and waiter is not None:
            waiter.wait(timeout=2.0)
            with self._frame_lock:
                obj_json = self._wire_cache.get(wkey)
        if obj_json is None:
            if lazy:
                try:
                    obj = obj()
                except Exception:
                    # a DECODE failure must surface as an ERROR frame (the
                    # caller's contract), never as a typed frame wrapping a
                    # Status — release any waiters first
                    if leader is not None:
                        with self._frame_lock:
                            self._encode_inflight.pop(wkey, None)
                        leader.set()
                    raise
            try:
                obj_json = self.scheme.encode(obj, version)
            except Exception:
                # never cache the fallback: a transient encode failure must
                # not poison this revision for later watchers
                if leader is not None:
                    with self._frame_lock:
                        self._encode_inflight.pop(wkey, None)
                    leader.set()
                return self._assemble(ev_type, self._ENCODE_FALLBACK)
            self.metric_frame_misses.inc()
            with self._frame_lock:
                self._wire_cache[wkey] = obj_json
                while len(self._wire_cache) > self._WIRE_CACHE_MAX:
                    self._wire_cache.popitem(last=False)
        else:
            # assembled from cached/seeded wire JSON: the encode was avoided
            self.metric_frame_hits.inc()
        if leader is not None:
            with self._frame_lock:
                self._encode_inflight.pop(wkey, None)
            leader.set()
        entry = self._assemble(ev_type, obj_json)
        with self._frame_lock:
            self._frame_cache[fkey] = entry
            while len(self._frame_cache) > self._FRAME_CACHE_MAX:
                self._frame_cache.popitem(last=False)
        return entry

    def _drain_share_seeds(self) -> None:
        """Import sibling-published encodings (apiserver/share.py) into
        the local wire cache. Single-drainer: the mmap cursors are
        per-process state, so one thread drains while concurrent missers
        wait for its imports and then re-check the cache."""
        share = self.share
        if share is None:
            return
        if not self._share_drain_lock.acquire(blocking=False):
            with self._share_drain_lock:  # ride out the active drain
                return
        try:
            drops0 = share.ring_drops
            records = share.drain_frames()
            if share.ring_drops > drops0:
                self.metric_seed_ring_drops.inc(
                    by=share.ring_drops - drops0)
            if not records:
                return
            waiters = []
            with self._frame_lock:
                for rv, ver, wire_json in records:
                    key = (rv, ver)
                    if key in self._wire_cache:
                        continue
                    self._wire_cache[key] = wire_json
                    self.metric_seed_imported.inc()
                    w = self._encode_inflight.pop(key, None)
                    if w is not None:
                        waiters.append(w)
                while len(self._wire_cache) > self._WIRE_CACHE_MAX:
                    self._wire_cache.popitem(last=False)
            for w in waiters:
                w.set()
        finally:
            self._share_drain_lock.release()

    def event_frame(self, ev, version: str) -> str:
        """One JSON watch frame per (object revision, event type, wire
        version), shared across all watchers."""
        return self.frame_entry(ev.type, ev.object, version)[0]

    _LAG_STATUS = ('{"kind": "Status", "apiVersion": "%s", '
                   '"status": "Failure", "reason": "Expired", "code": 410, '
                   '"message": "watch lag bound exceeded; re-list required"}')

    def lag_resync_entry(self, version: str):
        """The bookmark-style drop-to-resync marker: a 410 Expired Status
        ERROR frame (pre-assembled per version)."""
        key = ("", "ERROR", version)
        with self._frame_lock:
            entry = self._frame_cache.get(key)
        if entry is None:
            entry = self._assemble("ERROR", self._LAG_STATUS % version)
            with self._frame_lock:
                self._frame_cache[key] = entry
        return entry

    def track_watcher(self, w) -> None:
        with self._watch_lock:
            self._watchers.add(w)

    def untrack_watcher(self, w) -> None:
        with self._watch_lock:
            self._watchers.discard(w)

    # -- deep health (ref: pkg/healthz + ComponentStatus) ------------------

    def health_components(self) -> Tuple[Dict[str, Any], bool]:
        """/healthz body: componentstatus-style per-dependency verdicts
        using the probe package's result vocabulary. Probes the two
        things this server cannot serve without: the backing store
        (in-process, durable, or a remote kube-store — one cheap list
        proves the round trip) and the watch hub (a subscribe+cancel
        proves the fan-out layer still accepts watchers)."""
        from kubernetes_tpu_torch import probe

        items = []
        ok = True
        try:
            self.master.dispatch("list", "namespaces")
            items.append({"name": "store", "status": probe.SUCCESS,
                          "message": "list round-trip ok"})
        except Exception as e:
            items.append({"name": "store", "status": probe.FAILURE,
                          "message": repr(e)})
            ok = False
        # kube-chaos recovery disclosure (docs/design/ha.md): when the
        # backing store is an in-process DurableStore, /healthz carries
        # what the last crash recovery cost — replayed records, snapshot
        # age, torn-tail bytes, recovery wall time — so a respawned
        # apiserver proves "bounded recovery" instead of asserting it
        # (the remote-store topology discloses the same via kube-store's
        # own /healthz)
        recovery = getattr(self.master.store, "recovery", None)
        try:
            w, _translate = self.master.dispatch(
                "watch_raw", "namespaces", namespace="", label_selector="",
                field_selector="", resource_version="", user=None,
                lag_limit=16)
            w.stop()
            items.append({"name": "watch-hub", "status": probe.SUCCESS,
                          "message": "subscribe ok"})
        except Exception as e:
            items.append({"name": "watch-hub", "status": probe.FAILURE,
                          "message": repr(e)})
            ok = False
        payload: Dict[str, Any] = {"kind": "ComponentStatusList",
                                   "healthy": ok, "items": items}
        if recovery is not None:
            payload["recovery"] = dict(recovery)
        return payload, ok

    # -- kube-flightrec ----------------------------------------------------

    def flightrec_vars(self, since_ns: int = 0) -> Dict[str, Any]:
        """The /debug/vars shard. First pull arms the sampler (lazy, like
        the kube-trace ring) and registers this server's per-instance
        metrics Registry alongside the process default registry."""
        if not metrics_pkg.flightrec_armed():
            metrics_pkg.flightrec_arm(service="apiserver", sample=False)
        metrics_pkg.flightrec_watch(self.metrics_registry)
        if since_ns == 0:
            metrics_pkg.flightrec_sample_now()
        return metrics_pkg.flightrec_vars(since_ns)

    # -- cluster validation (ref: master.go:516-551) ----------------------

    def validate_components(self) -> Tuple[Dict[str, Any], bool]:
        statuses: Dict[str, Any] = {}
        ok = True
        try:
            self.master.dispatch("list", "namespaces")
            statuses["store"] = {"healthy": True}
        except Exception as e:
            statuses["store"] = {"healthy": False, "error": repr(e)}
            ok = False
        return statuses, ok

    # -- resource locations (ref: pod/rest.go, service/rest.go,
    #    minion ResourceLocation) -----------------------------------------

    def resource_location(self, resource: str, namespace: str, name: str,
                          user=None) -> Optional[str]:
        if resource in ("pods", "pod"):
            pod = self.master.dispatch("get", "pods", namespace=namespace,
                                       name=name, user=user)
            ip = getattr(pod.status, "pod_ip", "") or getattr(pod.status, "host", "")
            return ip or None
        if resource in ("services", "service"):
            eps = self.master.dispatch("get", "endpoints", namespace=namespace,
                                       name=name, user=user)
            endpoints = list(getattr(eps, "endpoints", []) or [])
            if not endpoints:
                return None
            # ref: service/rest.go ResourceLocation — pick an endpoint
            ep = endpoints[hash(name) % len(endpoints)]
            return f"{ep.ip}:{ep.port}"
        if resource in ("nodes", "minions", "node"):
            node = self.master.dispatch("get", "nodes", name=name, user=user)
            if node is None:
                return None
            if self.node_locator is not None:
                # harness/deployment hook: node name -> "host:port" of its
                # kubelet server (ref: minion registry ResourceLocation via
                # client.ConnectionInfoGetter)
                return self.node_locator(name)
            addrs = getattr(node.status, "addresses", []) or []
            host = addrs[0].address if addrs else node.metadata.name
            return f"{host}:{self.kubelet_port}"
        return None
