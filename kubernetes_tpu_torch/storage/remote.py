"""Remote store: the cluster store as its own process.

Port of ``kubernetes_tpu/storage/remote.py``.

The reference keeps ALL state in etcd, a separate process every apiserver
talks to over a socket (ref: pkg/tools/etcd_helper.go over the etcd v2
HTTP client; DESIGN.md:17-40 — components share state only through the
store). The in-process MemStore/DurableStore gave this rebuild its
FakeEtcdClient-style test backend; this module completes the topology
parity: ``StoreServer`` serves any MemStore-compatible store over a local
TCP socket, and ``RemoteStore`` is a drop-in MemStore replacement so
SEVERAL apiserver worker processes can share one consistent store — the
horizontal-scaling shape the reference gets from Go threads inside one
apiserver, recovered here across Python processes (one GIL each).

Protocol: length-prefixed JSON frames (4-byte big-endian size + UTF-8
body). Values are already JSON strings (StoreHelper encodes before
storing, like EtcdHelper), so the framing cost is one small dict per op.
Request/response on a pooled connection; ``watch`` upgrades its
connection to a one-way event stream, exactly like an etcd watch. Store
errors travel as {"err": <class name>, "msg": ...} and are re-raised as
the same StoreError classes clients of MemStore already handle.
"""

from __future__ import annotations

import json
import select
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.util import chaos
from kubernetes_tpu_torch.util.retry import Backoff
from kubernetes_tpu_torch.storage.memstore import (
    KV,
    ErrCASConflict,
    ErrIndexOutdated,
    ErrKeyExists,
    ErrKeyNotFound,
    ErrTooManyRequests,
    MemStore,
    StoreError,
    StoreEvent,
)

__all__ = ["StoreServer", "RemoteStore"]

_ERRORS = {
    "ErrKeyExists": ErrKeyExists,
    "ErrKeyNotFound": ErrKeyNotFound,
    "ErrCASConflict": ErrCASConflict,
    "ErrIndexOutdated": ErrIndexOutdated,
    "ErrTooManyRequests": ErrTooManyRequests,
    "StoreError": StoreError,
}


# -- framing -----------------------------------------------------------------

def _send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (size,) = struct.unpack(">I", head)
    body = _recv_exact(sock, size)
    if body is None:
        return None
    return json.loads(body)


def _kv_out(kv: Optional[KV]) -> Optional[dict]:
    if kv is None:
        return None
    return {"k": kv.key, "v": kv.value, "c": kv.created_index,
            "m": kv.modified_index, "e": kv.expiration}


def _kv_in(d: Optional[dict]) -> Optional[KV]:
    if d is None:
        return None
    return KV(d["k"], d["v"], d["c"], d["m"], d.get("e"))


def _err_out(e: Exception) -> dict:
    out = {"err": type(e).__name__, "msg": str(e)}
    ra = getattr(e, "retry_after_s", None)
    if ra is not None:
        # the throttle hint travels the wire so RemoteStore can honor
        # the server's measured drain, not guess
        out["retry_after"] = ra
    return out


def _raise_err(d: dict) -> None:
    cls = _ERRORS.get(d.get("err", ""), StoreError)
    if cls is ErrTooManyRequests:
        raise ErrTooManyRequests(d.get("msg", ""),
                                 retry_after_s=float(
                                     d.get("retry_after", 1.0) or 1.0))
    raise cls(d.get("msg", ""))


# -- server ------------------------------------------------------------------

class StoreServer:
    """Serves a MemStore-compatible store over TCP (the etcd process
    analog). One thread per connection; watch connections stream."""

    def __init__(self, store: Optional[MemStore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 reuse_port: bool = False, max_inflight: int = 0):
        self.store = store if store is not None else MemStore()
        # kube-fairshed overload valve (0 disables): ops past
        # max_inflight concurrent dispatches are SHED with
        # ErrTooManyRequests + a measured-drain retry_after hint
        # instead of queueing unboundedly on the store lock — the store
        # analog of the apiserver's 429 + Retry-After
        self.max_inflight = int(max_inflight)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._op_done: "deque" = deque(maxlen=512)  # completion stamps
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port and hasattr(socket, "SO_REUSEPORT"):
            # OPT-IN only (in-process kill+respawn tests, embedded
            # deployments that re-listen while pre-crash client sockets
            # drain FIN_WAIT): two live kube-store processes sharing a
            # port would split clients across divergent stores, so the
            # production binary never sets it — a real process death
            # frees the port on its own
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns_lock = threading.Lock()
        self._conns: set = set()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    @property
    def address(self) -> str:
        host, port = self._sock.getsockname()[:2]
        return f"{host}:{port}"

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="store-accept")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # close live per-connection sockets too — a real process death
        # does, and leaving them open both leaks conn threads and keeps
        # the port EADDRINUSE against an in-process respawn (the
        # kill+respawn tests restart a StoreServer on the same port).
        # shutdown() first: the conn thread is blocked in recv, which
        # defers the fd close — shutdown sends the FIN immediately and
        # wakes the reader regardless (the http watch on_stop pattern).
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        self._accept_loop()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="store-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv_frame(conn)
                if req is None:
                    return
                # kube-chaos seams (util/chaos, armed by tests only):
                # a mid-stream connection reset is exactly what a killed
                # server produces; a delay is a wedged-but-alive one
                chaos.delay_if_armed("store.serve.delay")
                if chaos.take_flag("store.serve.reset"):
                    return
                op = req.get("op", "")
                if op == "watch":
                    self._serve_watch(conn, req)
                    return  # the connection is consumed by the stream
                try:
                    chaos.error_if_armed("store.serve.error")
                    if not self._admit():
                        resp = _err_out(ErrTooManyRequests(
                            "store over max-inflight",
                            retry_after_s=self._throttle_hint()))
                    else:
                        try:
                            # seam INSIDE the admitted slot: tests hold
                            # a slot occupied for an exact duration
                            chaos.delay_if_armed("store.serve.busy")
                            resp = self._dispatch(op, req)
                        finally:
                            self._op_complete()
                except StoreError as e:
                    resp = _err_out(e)
                _send_frame(conn, resp)
        except (OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _admit(self) -> bool:
        if not self.max_inflight:
            return True
        with self._inflight_lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            return True

    def _op_complete(self) -> None:
        if not self.max_inflight:
            return
        with self._inflight_lock:
            self._inflight = max(0, self._inflight - 1)
            self._op_done.append(time.monotonic())

    def _throttle_hint(self) -> float:
        """Retry-after from the measured op completion rate — time for
        one inflight's worth of ops to drain, clamped [0.05, 5] s."""
        with self._inflight_lock:
            done = list(self._op_done)
        now = time.monotonic()
        recent = [t for t in done if t > now - 5.0]
        if len(recent) < 2:
            return 0.2
        rate = len(recent) / max(1e-3, now - recent[0])
        return min(5.0, max(0.05, self.max_inflight / rate))

    def _dispatch(self, op: str, req: dict) -> dict:
        s = self.store
        if op == "get":
            return {"ok": _kv_out(s.get(req["key"]))}
        if op == "get_many":
            return {"ok": [_kv_out(kv) for kv in s.get_many(req["keys"])]}
        if op == "list":
            kvs, index = s.list(req["prefix"])
            return {"ok": {"kvs": [_kv_out(kv) for kv in kvs],
                           "index": index}}
        if op == "create":
            return {"ok": _kv_out(s.create(req["key"], req["value"],
                                           ttl=req.get("ttl")))}
        if op == "set":
            return {"ok": _kv_out(s.set(req["key"], req["value"],
                                        ttl=req.get("ttl")))}
        if op == "cas":
            return {"ok": _kv_out(s.compare_and_swap(
                req["key"], req["value"], req["prev_index"],
                ttl=req.get("ttl")))}
        if op == "cas_many":
            outcomes = s.compare_and_swap_many(
                [(k, v, p) for k, v, p in req["items"]])
            return {"ok": [_err_out(oc) if isinstance(oc, Exception)
                           else {"kv": _kv_out(oc)} for oc in outcomes]}
        if op == "txn_many":
            outcomes = s.txn_many(
                [([(k, v, p) for k, v, p in cas],
                  [(k, p) for k, p in dels])
                 for cas, dels in req["items"]])
            return {"ok": [_err_out(oc) if isinstance(oc, Exception)
                           else {"kvs": [_kv_out(kv) for kv in oc]}
                           for oc in outcomes]}
        if op == "delete":
            return {"ok": _kv_out(s.delete(req["key"],
                                           prev_index=req.get("prev_index")))}
        if op == "index":
            return {"ok": s.index}
        raise StoreError(f"unknown op {op!r}")

    def _serve_watch(self, conn: socket.socket, req: dict) -> None:
        try:
            src = self.store.watch(req.get("prefix", ""),
                                   from_index=req.get("from_index", 0),
                                   recursive=req.get("recursive", True),
                                   lag_limit=req.get("lag_limit"))
        except StoreError as e:
            _send_frame(conn, _err_out(e))
            return
        _send_frame(conn, {"ok": True})

        # reader side: an EOF/garbage from the client stops the watch, so
        # a dropped apiserver worker releases its server-side watcher
        def reap():
            try:
                conn.recv(1)
            except OSError:
                pass
            src.stop()

        threading.Thread(target=reap, daemon=True,
                         name="store-watch-reap").start()
        try:
            for ev in src:
                if ev.type == watchpkg.ERROR and ev.object is None:
                    # bounded-lag drop-to-resync marker: forward, then the
                    # stream ends (the client re-lists)
                    _send_frame(conn, {"lagged": True})
                    break
                sev: StoreEvent = ev.object
                _send_frame(conn, {"ev": {
                    "action": sev.action, "key": sev.key, "index": sev.index,
                    "kv": _kv_out(sev.kv), "prev_kv": _kv_out(sev.prev_kv)}})
        except (OSError, ValueError):
            pass
        finally:
            src.stop()
            try:
                conn.close()
            except OSError:
                pass


# -- client ------------------------------------------------------------------

class RemoteStore:
    """Drop-in MemStore replacement speaking to a StoreServer.

    One pooled connection per thread (apiserver handler threads are
    long-lived); watches open a dedicated streaming connection each, and
    stopping the client-side Watcher closes it, which the server notices.

    Restart transparency (docs/design/ha.md): a kube-store respawn must
    look like latency, not errors. Three mechanisms compose:

    - a zero-timeout readability probe evicts pooled connections the
      restarted server half-closed BEFORE a request lands on them (the
      Go http.Transport background-read idiom client/http uses) — the
      common post-restart path never even sees an error;
    - refused/failed CONNECTS retry with capped exponential backoff +
      jitter for up to ``reconnect_window_s`` (nothing was sent, always
      safe; jitter keeps N handler threads from reconnecting in
      lockstep);
    - a connection that dies MID-CALL retries through the same window
      for idempotent reads; writes still raise (the op may have applied
      — the callers' CAS/409 discipline owns that ambiguity, same as
      client/http._open for non-idempotent methods).
    """

    def __init__(self, address: str, call_timeout_s: float = 30.0,
                 reconnect_window_s: float = 20.0):
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._call_timeout_s = call_timeout_s
        self._reconnect_window_s = reconnect_window_s
        self._local = threading.local()
        self.throttled = 0   # ErrTooManyRequests answers ridden out

    # -- plumbing ----------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr,
                                        timeout=self._call_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    @staticmethod
    def _stale(sock: socket.socket) -> bool:
        """True when an idle pooled connection is unusable: any pending
        byte/EOF on an idle request/response connection means the server
        closed or desynced (a restarted kube-store RSTs every pre-crash
        socket). poll(2), not select(2) — fd>=1024 must not false-flag."""
        try:
            p = select.poll()
            p.register(sock, select.POLLIN | select.POLLHUP | select.POLLERR)
            return bool(p.poll(0))
        except (OSError, ValueError):
            return True

    def _drop_sock(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            self._local.sock = None
            try:
                sock.close()
            except OSError:
                pass

    def _connect_with_backoff(self, deadline: float) -> socket.socket:
        """Dial until ``deadline``; OSError past it surfaces as
        StoreError (the caller's per-op failure)."""
        backoff = Backoff(base=0.05, cap=1.0)
        while True:
            try:
                return self._connect()
            except OSError as e:
                if time.monotonic() + backoff.peek() >= deadline:
                    raise StoreError(
                        f"store at {self._addr[0]}:{self._addr[1]} "
                        f"unreachable for {self._reconnect_window_s:.0f}s: "
                        f"{e}") from None
                backoff.sleep_next()

    def _call(self, req: dict, idempotent: bool = False):
        deadline = time.monotonic() + self._reconnect_window_s
        retry_backoff = Backoff(base=0.02, cap=0.5)
        throttle_backoff = Backoff(base=0.05, cap=1.0)
        while True:
            sock = getattr(self._local, "sock", None)
            if sock is not None and self._stale(sock):
                self._drop_sock()
                sock = None
            if sock is None:
                sock = self._local.sock = \
                    self._connect_with_backoff(deadline)
            sent = False
            recv_err: Optional[Exception] = None
            resp = None
            try:
                _send_frame(sock, req)
                sent = True
                resp = _recv_frame(sock)
            except OSError as e:
                recv_err = e
            if resp is None:
                self._drop_sock()
                if not sent:
                    # the request never went out: reconnect and resend
                    # (always safe) — but bounded by the SAME window as
                    # everything else, with a small backoff: a store in
                    # a fast crash loop accepts connects and resets the
                    # send, which would otherwise busy-spin here forever
                    if time.monotonic() >= deadline:
                        raise StoreError(
                            f"store at {self._addr[0]}:{self._addr[1]} "
                            f"resetting sends for "
                            f"{self._reconnect_window_s:.0f}s: {recv_err}")
                    retry_backoff.sleep_next()
                    continue
                # the server died between send and response. Reads are
                # idempotent — retry through the window (a restarted
                # kube-store serves them from recovered state). Writes
                # are NOT retried: the op may have applied (same
                # discipline as client/http._open for non-idempotent
                # methods).
                if idempotent and time.monotonic() < deadline:
                    continue
                raise StoreError("store connection "
                                 + (f"failed mid-call: {recv_err}"
                                    if recv_err else "closed mid-call"))
            if "err" in resp:
                if resp.get("err") == "ErrTooManyRequests":
                    # kube-fairshed: the server SHED this op before
                    # executing it, so a resend can never double-apply
                    # (reads AND writes) — honor its measured
                    # retry_after hint (capped exponential + jitter
                    # when the server sent none) inside the same window
                    # every other transient shares, then surface
                    hint = float(resp.get("retry_after", 0) or 0) \
                        or throttle_backoff.next()
                    if time.monotonic() + hint < deadline:
                        self.throttled += 1
                        time.sleep(hint)
                        continue
                _raise_err(resp)
            return resp["ok"]

    # -- MemStore surface --------------------------------------------------
    @property
    def index(self) -> int:
        return self._call({"op": "index"}, idempotent=True)

    def get(self, key: str) -> KV:
        return _kv_in(self._call({"op": "get", "key": key},
                              idempotent=True))

    def get_many(self, keys: List[str]) -> List[Optional[KV]]:
        return [_kv_in(d) for d in
                self._call({"op": "get_many", "keys": list(keys)},
                           idempotent=True)]

    def list(self, prefix: str) -> Tuple[List[KV], int]:
        out = self._call({"op": "list", "prefix": prefix},
                         idempotent=True)
        return [_kv_in(d) for d in out["kvs"]], out["index"]

    def create(self, key: str, value: str,
               ttl: Optional[float] = None) -> KV:
        return _kv_in(self._call({"op": "create", "key": key,
                                  "value": value, "ttl": ttl}))

    def set(self, key: str, value: str, ttl: Optional[float] = None) -> KV:
        return _kv_in(self._call({"op": "set", "key": key, "value": value,
                                  "ttl": ttl}))

    def compare_and_swap(self, key: str, value: str, prev_index: int,
                         ttl: Optional[float] = None) -> KV:
        return _kv_in(self._call({"op": "cas", "key": key, "value": value,
                                  "prev_index": prev_index, "ttl": ttl}))

    def compare_and_swap_many(self, items: List[Tuple[str, str, int]]
                              ) -> List[object]:
        out = self._call({"op": "cas_many",
                          "items": [list(i) for i in items]})
        results: List[object] = []
        for d in out:
            if "err" in d:
                results.append(_ERRORS.get(d["err"], StoreError)(d["msg"]))
            else:
                results.append(_kv_in(d["kv"]))
        return results

    def txn_many(self, items) -> List[object]:
        """Per-item all-or-nothing CAS+delete transactions (the evict+bind
        commit primitive); wire mirror of MemStore.txn_many."""
        out = self._call({"op": "txn_many",
                          "items": [[[list(c) for c in cas],
                                     [list(d) for d in dels]]
                                    for cas, dels in items]})
        results: List[object] = []
        for d in out:
            if "err" in d:
                results.append(_ERRORS.get(d["err"], StoreError)(d["msg"]))
            else:
                results.append([_kv_in(kv) for kv in d["kvs"]])
        return results

    def delete(self, key: str, prev_index: Optional[int] = None) -> KV:
        return _kv_in(self._call({"op": "delete", "key": key,
                                  "prev_index": prev_index}))

    def watch(self, prefix: str, from_index: int = 0,
              recursive: bool = True,
              lag_limit: Optional[int] = None) -> watchpkg.Watcher:
        # the open handshake is read-only: ride a store respawn with the
        # same backoff window the request/response ops use
        sock = self._connect_with_backoff(
            time.monotonic() + self._reconnect_window_s)
        # the open handshake stays under the connect timeout (a wedged
        # store must fail watch() in bounded time) ...
        try:
            _send_frame(sock, {"op": "watch", "prefix": prefix,
                               "from_index": from_index,
                               "recursive": recursive,
                               "lag_limit": lag_limit})
            resp = _recv_frame(sock)
        except OSError as e:
            # a store dying or respawning resets the handshake: a store
            # failure like a closed one, never a raw ConnectionResetError,
            # which the apiserver would take for its own client leaving
            sock.close()
            raise StoreError(f"store connection failed opening watch: "
                             f"{e}") from None
        if resp is None:
            raise StoreError("store connection closed opening watch")
        if "err" in resp:
            _raise_err(resp)
        # ... but the STREAM must carry no timeout: a watch over a quiet
        # prefix legitimately sees nothing for minutes, and a timed-out
        # recv would silently end every downstream watcher
        sock.settimeout(None)

        def on_stop(_w):
            try:
                sock.close()
            except OSError:
                pass

        w = watchpkg.Watcher(on_stop=on_stop)

        def pump():
            try:
                while True:
                    frame = _recv_frame(sock)
                    if frame is None:
                        break
                    if frame.get("lagged"):
                        # server-side lag bound tripped: replay the
                        # drop-to-resync locally (ERROR + end-of-stream)
                        w.drop_to_resync()
                        break
                    if "ev" not in frame:
                        break
                    d = frame["ev"]
                    w.send(watchpkg.Event(d["action"], StoreEvent(
                        d["action"], d["key"], d["index"],
                        _kv_in(d.get("kv")), _kv_in(d.get("prev_kv")))))
            except (OSError, ValueError):
                pass
            finally:
                w.close()

        threading.Thread(target=pump, daemon=True,
                         name=f"remote-watch-{prefix}").start()
        return w
