"""RemoteSolver — a kube-solverd client with graceful in-process fallback.

Port of ``kubernetes_tpu/solver/client.py``. Drop-in for the in-process
solve path: ``RemoteSolver.solve(snap)`` returns exactly what
``models.batch_solver.solve(snap)`` returns (chosen node indices + winning
scores, gang post-pass applied), so the BatchScheduler's wave loop cannot
tell which solver ran — except by the wave latency. Recovery discipline:
one pooled connection per thread; a failure the daemon never saw the
frame for (refused connect, send error, any death of a REUSED pooled
connection) retries once on a fresh connection, while a post-send failure
on a fresh connection raises — the daemon may be mid-solve, and
re-sending would double its load exactly when it is slow (see _call).

Degradation ladder, worst case first. The fallback solves the wave in
the scheduler's own process through the same ``commit_solve`` kernel on
the same card (``solve(snap, host=host, device=self.device)``): never the
plain version unless the scheduler itself runs on the CPU.

- daemon replies BUSY (bounded queue full): solve this wave in-process,
  do NOT mark the daemon unhealthy — backpressure is it working as
  designed;
- connection refused / timed out / died twice: solve in-process and mark
  the daemon unhealthy for a jittered, doubling cooldown (capped at
  ``cooldown_s``), so a dead daemon costs one connect attempt per
  cooldown, not per wave;
- protocol/version errors: same as above (a version-skewed daemon will
  never start working mid-run).

With ``fallback=False`` (the scheduler's ``--solver-fallback requeue``)
the failures raise instead, and the wave loop requeues the wave.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models.batch_solver import (
    NEG,
    resolve_device,
    snapshot_to_host_inputs,
    solve as solve_in_process,
)
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.solver import protocol
from kubernetes_tpu_torch.util import metrics, tracing
from kubernetes_tpu_torch.util.retry import Backoff

__all__ = ["RemoteSolver", "SolverBusy", "SolverUnavailable"]


class _Mirror:
    """Client-side copy of the resident planes the daemon holds for one
    (worker-thread, shape-bucket) cache entry. The arrays are OWNED
    copies: encoder-resident planes can mutate in place between waves, so
    diffing against a reference we also hold by reference would see
    nothing change. ``epoch`` counts applied frames and must stay in
    lockstep with the daemon's entry — any skew surfaces as a resync."""

    __slots__ = ("epoch", "planes")

    def __init__(self, epoch: int, planes: Dict[str, np.ndarray]):
        self.epoch = epoch
        self.planes = planes


class SolverUnavailable(Exception):
    """No healthy kube-solverd behind the configured address."""


class SolverBusy(Exception):
    """The daemon's bounded queue is full (the 429 analog)."""


class RemoteSolver:
    """Client of one daemon at ``address`` (HOST:PORT). ``device`` is where
    a fallback wave solves in this process: ``cuda`` unless the caller
    names another."""

    # the reply deadline must clear a COLD solve: the daemon's first wave
    # builds the kernel library (tens of seconds of nvcc on a fresh
    # checkout), and treating that as a dead connection would re-send the
    # wave and solve it twice
    def __init__(self, address: str, timeout_s: float = 180.0,
                 connect_timeout_s: float = 2.0, fallback: bool = True,
                 cooldown_s: float = 5.0, delta: bool = True, device=None):
        self.device = resolve_device(device)
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout_s = timeout_s
        self._connect_timeout_s = connect_timeout_s
        self.fallback = fallback
        self.cooldown_s = cooldown_s
        # delta wire (protocol v2): ship O(changed-rows) plane deltas
        # against a daemon-side resident cache; False pins full frames
        self.delta = delta
        self._wid = uuid.uuid4().hex[:12]
        self._local = threading.local()
        self._lock = threading.Lock()
        self._unhealthy_until = 0.0
        # exponential cooldown: a daemon mid-respawn costs a retry after
        # ~cooldown_s/8, doubling (jittered) to the cooldown_s cap while
        # it stays dead — reconnecting within seconds of a kube-chaos
        # respawn instead of always paying the full fixed cooldown,
        # while a permanently-dead daemon still costs one connect per
        # cap. Reset on the first successful remote wave.
        self._cooldown = Backoff(base=max(0.25, cooldown_s / 8.0),
                                 cap=max(0.25, cooldown_s))
        # visible in tests and the scheduler's /metrics narrative
        self.remote_waves = 0
        self.fallback_waves = 0
        self.busy_waves = 0
        self.delta_waves = 0
        self.full_waves = 0
        self.resync_waves = 0
        self.resync_reasons: Dict[str, int] = {}
        self.delta_bytes_shipped = 0
        self.delta_bytes_full = 0
        # device mesh for the in-process fallback (the daemon runs its own
        # MeshExecutor); set by the scheduler from its --mesh flag
        self.fallback_mesh = None

    # -- plumbing ----------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout_s)
        return sock

    def _call(self, header: dict, arrays=()):
        """Request/response on the pooled per-thread connection. Retry-once
        covers failures the daemon never saw the frame for: a refused
        connect, a send error, or any failure on a REUSED pooled
        connection (a daemon restart between waves half-closes the pool;
        the send "succeeds" into the dead socket and the recv gets EOF).
        A failure after a send on a FRESH connection does NOT retry: the
        daemon very likely has the frame and may be solving it, and a
        retry after a merely-slow reply would make it solve the same wave
        twice — exactly when it is most loaded. (Pure solves keep the
        caller's fallback safe either way, just not free.)"""
        last_err: Optional[Exception] = None
        for attempt in (0, 1):
            sock = getattr(self._local, "sock", None)
            reused = sock is not None
            sent = False
            try:
                if sock is None:
                    sock = self._local.sock = self._connect()
                protocol.send_msg(sock, header, arrays)
                sent = True
                resp = protocol.recv_msg(sock)
                if resp is None:
                    raise protocol.SolverProtocolError(
                        "daemon closed the connection mid-call")
                return resp
            except (OSError, protocol.SolverProtocolError) as e:
                last_err = e
                self._local.sock = None
                try:
                    if sock is not None:
                        sock.close()
                except OSError:
                    pass
                if sent and not reused:
                    break
        raise SolverUnavailable(
            f"kube-solverd at {self._addr[0]}:{self._addr[1]} "
            f"unreachable: {last_err}")

    # -- health ------------------------------------------------------------
    def _in_cooldown(self) -> bool:
        with self._lock:
            return time.monotonic() < self._unhealthy_until

    def _mark_unhealthy(self) -> None:
        with self._lock:
            self._unhealthy_until = time.monotonic() + self._cooldown.next()

    def _mark_healthy(self) -> None:
        with self._lock:
            self._unhealthy_until = 0.0
            self._cooldown.reset()

    def ping(self) -> dict:
        """Daemon health + version handshake; raises SolverUnavailable."""
        header, _ = self._call({"op": "ping", "v": protocol.PROTOCOL_VERSION})
        if "err" in header:
            raise SolverUnavailable(header.get("msg", header["err"]))
        if header.get("v") != protocol.PROTOCOL_VERSION:
            raise SolverUnavailable(
                f"daemon protocol v{header.get('v')} != "
                f"client v{protocol.PROTOCOL_VERSION}")
        return header

    # -- the solve seam ----------------------------------------------------
    @staticmethod
    def _parse_solve_reply(resp_header, arrays
                           ) -> Tuple[np.ndarray, np.ndarray]:
        if resp_header.get("busy"):
            raise SolverBusy("kube-solverd queue full")
        if "err" in resp_header:
            raise protocol.SolverProtocolError(
                f"{resp_header['err']}: {resp_header.get('msg', '')}")
        if len(arrays) != 2:
            raise protocol.SolverProtocolError(
                f"solve reply carried {len(arrays)} arrays, expected 2")
        return arrays[0], arrays[1]

    def _mirrors(self) -> Dict[str, _Mirror]:
        m = getattr(self._local, "mirrors", None)
        if m is None:
            m = self._local.mirrors = {}
        return m

    _MAX_MIRRORS = 16  # pow-2 pod buckets keep live shapes well below this

    def _delta_plan(self, host_inputs, mir: _Mirror):
        """Diff the wave's planes against the mirror of what the daemon
        holds -> (wire plane list, arrays to ship, mirror commit list).
        The row compare is a vectorized memcmp over the resident planes
        (~MBs/ms); the bytes SHIPPED are O(changed rows). A plane whose
        delta would not beat re-sending it ships full."""
        plan: list = []
        arrays: list = []
        commits: list = []
        for name, cur in zip(host_inputs._fields, host_inputs):
            cur = np.ascontiguousarray(cur)
            if name not in protocol.DELTA_FIELDS:
                plan.append("F")
                arrays.append(cur)
                continue
            prev = mir.planes[name]
            diff = prev != cur  # same shape/dtype: the bucket key pins them
            changed = diff.any(axis=tuple(range(1, diff.ndim))) \
                if diff.ndim > 1 else diff
            rows = np.nonzero(changed)[0].astype(np.int32)
            if rows.size == 0:
                plan.append("S")
                continue
            row_nbytes = cur.nbytes // max(1, cur.shape[0])
            if rows.size * (row_nbytes + 4) >= cur.nbytes:
                plan.append("F")
                arrays.append(cur)
                commits.append((name, None, cur))
            else:
                vals = np.ascontiguousarray(cur[rows])
                plan.append(["D", int(rows.size)])
                arrays.extend((rows, vals))
                commits.append((name, rows, vals))
        return plan, tuple(arrays), commits

    def solve_remote(self, host_inputs, pol: BatchPolicy, gangs: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Ship one wave's host-side SolverInputs; returns (chosen, scores)
        for the shipped pod axis. Raises SolverBusy / SolverUnavailable /
        SolverProtocolError — no fallback at this layer.

        With ``delta`` on (default), consecutive waves of one thread ship
        O(changed-rows) plane deltas against the daemon's resident cache;
        a ``resync`` answer (daemon restarted, entry evicted, epoch skew)
        degrades that one wave to a full frame and re-establishes the
        pair. The mirror only advances after a successful solve reply, so
        BUSY bounces and daemon-side failures can never desync it
        silently — at worst the next delta resyncs."""
        sx = metrics.slipstream_metrics()
        base = {
            "op": "solve", "v": protocol.PROTOCOL_VERSION,
            "fp": protocol.solver_fingerprint(pol, gangs),
            "policy": protocol.policy_to_wire(pol),
            "gangs": bool(gangs),
            # kube-slipstream: piggyback this scheduler's encoder resync
            # counters so solverd's /metrics mirrors cluster resync health
            "enc": [int(sx.resync_replay.total()),
                    int(sx.resync_full.total())],
        }
        # v3 trace context: the wave's ambient span rides the header so
        # the daemon's queue/solve spans join this trace (advisory only
        # — see protocol.parse_trace; absent when tracing is off)
        ctx = tracing.current()
        if ctx is not None:
            base["trace"] = [ctx[0], ctx[1]]
        if not self.delta:
            resp_header, arrays = self._call(base, tuple(host_inputs))
            return self._parse_solve_reply(resp_header, arrays)
        bucket = protocol.shape_bucket(host_inputs)
        wid = f"{self._wid}.{threading.get_ident()}"
        mirrors = self._mirrors()
        mir = mirrors.get(bucket)
        if mir is not None:
            plan, arrays, commits = self._delta_plan(host_inputs, mir)
            header = dict(base, cache={"wid": wid, "bucket": bucket,
                                       "epoch": mir.epoch}, planes=plan)
            resp_header, rarrs = self._call(header, arrays)
            if not resp_header.get("resync"):
                out = self._parse_solve_reply(resp_header, rarrs)
                mir.epoch += 1
                for name, rows, vals in commits:
                    if rows is None:
                        mir.planes[name] = np.array(vals, copy=True)
                    else:
                        mir.planes[name][rows] = vals
                self.delta_waves += 1
                self.delta_bytes_shipped += sum(a.nbytes for a in arrays)
                self.delta_bytes_full += sum(
                    a.nbytes for a in host_inputs)
                return out
            self.resync_waves += 1
            reason = str(resp_header.get("resync"))
            self.resync_reasons[reason] = (
                self.resync_reasons.get(reason, 0) + 1)
            mirrors.pop(bucket, None)
        # full frame: establish (or resync) the daemon's cache entry
        header = dict(base,
                      cache={"wid": wid, "bucket": bucket, "epoch": 0},
                      planes=["F"] * len(host_inputs))
        resp_header, rarrs = self._call(header, tuple(host_inputs))
        if resp_header.get("resync"):
            raise protocol.SolverProtocolError(
                f"daemon demanded resync of a full frame: "
                f"{resp_header['resync']!r}")
        out = self._parse_solve_reply(resp_header, rarrs)
        self.full_waves += 1
        if len(mirrors) >= self._MAX_MIRRORS:
            mirrors.pop(next(iter(mirrors)))
        mirrors[bucket] = _Mirror(1, {
            name: np.array(arr, copy=True)
            for name, arr in zip(host_inputs._fields, host_inputs)
            if name in protocol.DELTA_FIELDS})
        return out

    def solve(self, snap) -> Tuple[np.ndarray, np.ndarray]:
        """The batch_solver.solve twin over the wire: encode-side inputs
        from ``snap``, remote solve, gang post-pass — falling back to the
        in-process solve on ``self.device`` whenever the daemon can't take
        the wave."""
        if self._in_cooldown():
            if not self.fallback:
                raise SolverUnavailable("kube-solverd in unhealthy cooldown")
            self.fallback_waves += 1
            return solve_in_process(snap, device=self.device,
                                    mesh=self.fallback_mesh)
        pol = snap.policy or BatchPolicy()
        gangs = snap.has_gangs
        host = snapshot_to_host_inputs(snap)
        try:
            chosen, scores = self.solve_remote(host, pol, gangs)
        except SolverBusy:
            # BUSY is the designed overload response: reuse the encode the
            # wave already paid instead of re-deriving it while saturated
            self.busy_waves += 1
            if not self.fallback:
                raise
            return solve_in_process(snap, host=host, device=self.device,
                                    mesh=self.fallback_mesh)
        except (SolverUnavailable, protocol.SolverProtocolError):
            self._mark_unhealthy()
            if not self.fallback:
                raise
            self.fallback_waves += 1
            return solve_in_process(snap, host=host, device=self.device,
                                    mesh=self.fallback_mesh)
        self.remote_waves += 1
        self._mark_healthy()  # the daemon answered: cooldown resets
        if gangs:
            chosen = gang.apply_all_or_nothing(snap.pod_rid, chosen)
            scores = np.where(chosen < 0, np.int32(NEG), scores)
        return chosen, scores
