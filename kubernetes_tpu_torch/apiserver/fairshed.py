"""kube-fairshed: flow-classified priority & fairness admission.

Port of ``kubernetes_tpu/apiserver/fairshed.py``.

The r11-r14 records pin the overload failure mode: offered ~994/s
against ~490/s sustained turns into 37 s of *invisible* e2e backlog,
and under that pressure the control plane sheds blindly — the only 429
in the tree was the read-only port's token bucket, no client honored
Retry-After, and the scheduler's own reflector traffic queued behind
feeder create floods on the same GIL. This module is the API
priority-and-fairness layer (ref: the successor codebases' APF,
KEP-1040, borrowed shape; "Priority Matters", PAPERS.md, for the
band idea): every request is classified into a FLOW by
credential/user-agent/path, each flow gets an isolated max-inflight
budget and a bounded FIFO with a queue-wait deadline, and excess is
answered ``429 + Retry-After`` computed from the flow's MEASURED drain
rate — never a constant.

Flows (docs/design/apiserver-hotpath.md has the full table):

- ``system`` — the control plane's own traffic: scheduler binds
  (``bindings`` / ``bindings:batch``), component reflector list/watch
  (user-agent ``kube-scheduler``/``kubelet``/``kube-controller-manager``),
  and the unversioned observability endpoints (healthz, metrics,
  debug, version, validate). Structurally isolated: a system request
  only ever waits on other system requests — it is NEVER queued behind
  a lower band, which is the starvation-freedom invariant
  (``fairshed_system_shed_total`` must stay 0; the
  ``system_flow_shed_zero`` SLO rule watches it live).
- ``workload`` — user workload mutations: pod/resource writes from
  non-system clients (the churn feeders). The optional BACKLOG
  GOVERNOR lives here: when ``backlog_limit`` is set, pod creates past
  ``created - bound >= backlog_limit`` shed with a Retry-After derived
  from the measured bind drain rate, so the created-but-unbound queue
  — the 37 s invisible backlog — becomes a bounded, disclosed number.
- ``best-effort`` — observers, kubectl reads, event posts: the first
  band to shed, the last to matter.

Deterministic twins: the in-process seams
(``util/chaos.delay_if_armed("apiserver.dispatch.<flow>")`` in the
HTTP dispatch path) let tier-1 hold a band's inflight slots occupied
for an exact duration and prove system-flow starvation-freedom without
a live multi-process stack (tests/test_fairshed.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from kubernetes_tpu_torch.util import metrics as metrics_pkg

__all__ = ["SYSTEM", "WORKLOAD", "BEST_EFFORT", "FLOWS", "FlowConfig",
           "Shed", "FairShed", "classify", "route_info"]

SYSTEM = "system"
WORKLOAD = "workload"
BEST_EFFORT = "best-effort"
FLOWS = (SYSTEM, WORKLOAD, BEST_EFFORT)

# user-agent prefixes whose traffic IS the control plane: their
# reflector list/watches and status writes ride the system band
_SYSTEM_COMPONENTS = ("kube-scheduler", "kubelet", "kube-controller-manager",
                      "kube-proxy")
# unversioned endpoints that must survive overload: health probing and
# the observability pull paths (flightrec /debug/vars, /metrics, trace
# drains) are exactly what diagnoses a gray-failing server
_SYSTEM_HEADS = ("healthz", "version", "metrics", "validate", "debug")

_WRITE_METHODS = ("POST", "PUT", "PATCH", "DELETE")


def route_info(parts: Sequence[str]) -> Tuple[str, str, str]:
    """``(head, resource, subresource)`` from split path parts, by the
    same normalization the dispatcher applies (namespace scoping, the
    ``watch`` prefix, the ``bindings:batch`` verb suffix) — but without
    touching the registry: classification must stay O(path)."""
    head = parts[0] if parts else ""
    if head != "api" or len(parts) < 3:
        return head, "", ""
    rest = [("bindings" if seg == "bindings:batch" else seg)
            for seg in parts[2:]]
    if rest and rest[0] == "watch":
        rest = rest[1:]
    if rest and rest[0] == "namespaces" and len(rest) >= 3:
        rest = rest[2:]
    resource = rest[0] if rest else ""
    subresource = rest[2] if len(rest) > 2 else ""
    return head, resource, subresource


def classify(method: str, parts: Sequence[str],
             user_agent: Optional[str]) -> str:
    """Flow of one request, by path/credential/user-agent. Order:
    observability heads and the bind path are system no matter who
    asks; events are best-effort no matter who posts (diagnostics,
    not state — the async recorder already treats them as sheddable);
    component user-agents are system; remaining writes are workload;
    remaining reads are best-effort."""
    head, resource, subresource = route_info(parts)
    if head in _SYSTEM_HEADS:
        return SYSTEM
    if resource == "bindings" or subresource == "binding":
        return SYSTEM
    if resource == "events":
        return BEST_EFFORT
    ua = (user_agent or "").partition("/")[0]
    if ua in _SYSTEM_COMPONENTS:
        return SYSTEM
    if method in _WRITE_METHODS:
        return WORKLOAD
    return BEST_EFFORT


class FlowConfig:
    """One flow's budget: concurrent dispatches, queued waiters past
    that, and how long a waiter may park before it sheds."""

    __slots__ = ("max_inflight", "queue_limit", "queue_deadline_s")

    def __init__(self, max_inflight: int, queue_limit: int,
                 queue_deadline_s: float):
        assert max_inflight >= 1 and queue_limit >= 0
        self.max_inflight = max_inflight
        self.queue_limit = queue_limit
        self.queue_deadline_s = queue_deadline_s


# Defaults sized for the churn topology: the scheduler holds a handful
# of reflector streams + one commit leg (system), each feeder is one
# pipelined connection = one handler thread (workload), observers and
# kubectl are occasional (best-effort). Budgets are per PROCESS — an
# SO_REUSEPORT worker fleet multiplies them.
DEFAULT_FLOWS: Dict[str, FlowConfig] = {
    SYSTEM: FlowConfig(max_inflight=32, queue_limit=256,
                       queue_deadline_s=5.0),
    WORKLOAD: FlowConfig(max_inflight=16, queue_limit=128,
                         queue_deadline_s=1.0),
    BEST_EFFORT: FlowConfig(max_inflight=8, queue_limit=64,
                            queue_deadline_s=1.0),
}


class Shed(Exception):
    """Admission refused this request: the HTTP layer answers
    ``429 + Retry-After: <ceil(retry_after_s)>`` with the hint also in
    the Status's ``details.retryAfterSeconds`` so JSON clients see it."""

    def __init__(self, flow: str, reason: str, retry_after_s: float):
        super().__init__(f"{flow} flow shed ({reason}); "
                         f"retry after {retry_after_s:.1f}s")
        self.flow = flow
        self.reason = reason
        self.retry_after_s = retry_after_s


class _Waiter:
    __slots__ = ("event", "admitted", "t_enq")

    def __init__(self, t_enq: float):
        self.event = threading.Event()
        self.admitted = False
        self.t_enq = t_enq


class _Ticket:
    """One admitted request's slot; release is idempotent (the watch
    handler releases EARLY, at stream start, so a long-lived stream
    never pins an inflight slot; the route's finally releases again)."""

    __slots__ = ("_shed", "flow", "_released")

    def __init__(self, shed: "FairShed", flow: str):
        self._shed = shed
        self.flow = flow
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._shed._release(self.flow)

    def __enter__(self) -> "_Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# drain-rate measurement window: completions older than this no longer
# shape Retry-After hints (a stale burst must not promise a fast drain)
_DRAIN_WINDOW_S = 10.0
_DRAIN_SAMPLES = 2048
# Retry-After clamp: at least 1 s (an HTTP header carries whole
# seconds; 0 would be the constant-"1" non-answer this layer replaces),
# at most 30 s (past that the client should re-plan, not park)
_HINT_MIN_S = 1.0
_HINT_MAX_S = 30.0
_HINT_FALLBACK_S = 2.0   # no drain measured yet (cold server)


class FairShed:
    """Per-flow admission: isolated inflight budgets + bounded FIFO
    queues + measured-drain Retry-After, plus the optional workload
    backlog governor. One instance per APIServer; thread-safe."""

    def __init__(self, flows: Optional[Dict[str, FlowConfig]] = None,
                 backlog_limit: int = 0,
                 clock=time.monotonic, ledger=None):
        self._clock = clock
        self._lock = threading.Lock()
        self.flows: Dict[str, FlowConfig] = dict(DEFAULT_FLOWS)
        if flows:
            self.flows.update(flows)
        self._inflight: Dict[str, int] = {f: 0 for f in self.flows}
        self._queues: Dict[str, deque] = {
            # length is checked against queue_limit before append, so
            # maxlen (the thread-discipline bound) never silently evicts
            f: deque(maxlen=max(1, cfg.queue_limit))
            for f, cfg in self.flows.items()}
        # per-flow completion timestamps -> measured drain rate
        self._done: Dict[str, deque] = {
            f: deque(maxlen=_DRAIN_SAMPLES) for f in self.flows}
        # the workload backlog governor: pods created minus pods bound,
        # maintained by the write paths (note_pod_created /
        # note_pods_bound / note_pod_deleted). A single worker's local
        # counters are exact when that worker serves both creates and
        # binds; an SO_REUSEPORT fleet passes ``ledger`` (a
        # share.SharedLedger) — the cross-worker drain feed — so the
        # governor and the measured Retry-After hints stay exact at
        # ``--apiservers N`` (docs/design/apiserver-hotpath.md
        # §cross-worker).
        self.backlog_limit = int(backlog_limit)
        self._created = 0
        self._bound = 0
        self._bind_done: deque = deque(maxlen=_DRAIN_SAMPLES)
        self._ledger = ledger
        self._mx = metrics_pkg.fairshed_metrics()
        self._lmx = metrics_pkg.fairshed_ledger_metrics() \
            if ledger is not None else None
        if self._lmx is not None:
            self._lmx.workers.set(ledger.seg.nworkers)

    # -- accounting seams (the HTTP write paths call these) ---------------

    def note_pod_created(self) -> None:
        if self._ledger is not None:
            self._ledger.note_created()
            self._lmx.creates.inc()
        with self._lock:
            self._created += 1
            self._mx.backlog.set(self._backlog_locked())

    def note_pods_bound(self, n: int) -> None:
        if n <= 0:
            return
        if self._ledger is not None:
            self._ledger.note_bound(n)
            self._lmx.binds.inc(by=n)
        now = self._clock()
        with self._lock:
            self._bound += n
            for _ in range(min(n, _DRAIN_SAMPLES)):
                self._bind_done.append(now)
            self._mx.backlog.set(self._backlog_locked())

    def note_pod_deleted(self) -> None:
        """A deleted pod leaves the ledger. If it was still pending the
        decrement is exact; if it was bound this UNDER-counts the
        backlog (sheds later than truth — the availability-safe
        direction) instead of wedging a long-lived server at a phantom
        ceiling."""
        if self._ledger is not None:
            self._ledger.note_deleted()
            self._lmx.deletes.inc()
        with self._lock:
            self._created = max(self._bound, self._created - 1)
            self._mx.backlog.set(self._backlog_locked())

    def _backlog_locked(self) -> int:
        if self._ledger is not None:
            depth = self._ledger.backlog()
            self._lmx.backlog.set(depth)
            return depth
        return max(0, self._created - self._bound)

    @property
    def backlog(self) -> int:
        with self._lock:
            return self._backlog_locked()

    # -- drain rates ------------------------------------------------------

    @staticmethod
    def _rate(done: deque, now: float) -> float:
        """Completions/second over the trailing window; 0.0 = no data."""
        if len(done) < 2:
            return 0.0
        lo = now - _DRAIN_WINDOW_S
        # deque is time-ordered; count the in-window tail
        n = 0
        oldest = now
        for t in reversed(done):
            if t < lo:
                break
            n += 1
            oldest = t
        if n < 2:
            return 0.0
        span = max(1e-3, now - oldest)
        return n / span

    def drain_rate(self, flow: str) -> float:
        with self._lock:
            return self._rate(self._done[flow], self._clock())

    def bind_rate(self) -> float:
        if self._ledger is not None:
            return self._ledger.bind_rate(self._clock())
        with self._lock:
            return self._rate(self._bind_done, self._clock())

    def _hint(self, pending: float, rate: float) -> float:
        """Retry-After from a measured drain rate: time for ``pending``
        completions at ``rate``, clamped. A cold server (no rate yet)
        answers the fallback — still a number picked for the deployment,
        not the constant '1' the old sites hardcoded."""
        if rate <= 0.0:
            return _HINT_FALLBACK_S
        return min(_HINT_MAX_S, max(_HINT_MIN_S, pending / rate))

    # -- admission --------------------------------------------------------

    def admit(self, flow: str, pod_create: bool = False) -> _Ticket:
        """Admit or raise ``Shed``. Flows are fully isolated: a request
        waits only on ITS flow's inflight budget and FIFO position —
        system is structurally never queued behind lower bands."""
        cfg = self.flows[flow]
        now = self._clock()
        with self._lock:
            if pod_create and flow == WORKLOAD and self.backlog_limit:
                backlog = self._backlog_locked()
                if backlog >= self.backlog_limit:
                    if self._ledger is not None:
                        rate = self._ledger.bind_rate(now)
                    else:
                        rate = self._rate(self._bind_done, now)
                    hint = self._hint(backlog - self.backlog_limit + 1,
                                      rate)
                    self._shed_locked(flow, "backlog", hint)
                    raise Shed(flow, "backlog", hint)
            if self._inflight[flow] < cfg.max_inflight:
                self._inflight[flow] += 1
                self._mx.inflight.set(self._inflight[flow], flow)
                self._mx.admitted.inc(flow)
                self._mx.queue_wait.observe(0.0, flow)
                return _Ticket(self, flow)
            q = self._queues[flow]
            if len(q) >= cfg.queue_limit:
                hint = self._hint(len(q) + 1,
                                  self._rate(self._done[flow], now))
                self._shed_locked(flow, "queue_full", hint)
                raise Shed(flow, "queue_full", hint)
            w = _Waiter(now)
            q.append(w)
            self._mx.queued.set(len(q), flow)
        ok = w.event.wait(cfg.queue_deadline_s)
        with self._lock:
            if w.admitted:
                # released slot was handed to us (possibly racing the
                # deadline — a handed slot is always taken, never leaked)
                wait_s = self._clock() - w.t_enq
                self._mx.queue_wait.observe(wait_s, flow)
                self._mx.admitted.inc(flow)
                return _Ticket(self, flow)
            try:
                self._queues[flow].remove(w)
            except ValueError:
                pass
            self._mx.queued.set(len(self._queues[flow]), flow)
            hint = self._hint(len(self._queues[flow]) + 1,
                              self._rate(self._done[flow], self._clock()))
            self._shed_locked(flow, "timeout", hint)
        assert not ok or w.admitted  # event set implies a handoff
        raise Shed(flow, "timeout", hint)

    def _shed_locked(self, flow: str, reason: str, hint: float) -> None:
        self._mx.shed.inc(flow, reason)
        self._mx.retry_after.observe(hint, flow)
        if flow == SYSTEM:
            # the starvation-freedom invariant counter: any non-zero
            # value here is an isolation bug, and the overload record
            # contract requires it to read 0
            self._mx.system_shed.inc()

    def _release(self, flow: str) -> None:
        now = self._clock()
        with self._lock:
            self._done[flow].append(now)
            q = self._queues[flow]
            while q:
                w = q.popleft()
                self._mx.queued.set(len(q), flow)
                if not w.admitted:
                    # hand the slot over: inflight count is unchanged,
                    # the waiter owns it from here
                    w.admitted = True
                    w.event.set()
                    return
            self._inflight[flow] = max(0, self._inflight[flow] - 1)
            self._mx.inflight.set(self._inflight[flow], flow)

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            now = self._clock()
            out = {}
            for f in self.flows:
                out[f] = {"inflight": self._inflight[f],
                          "queued": len(self._queues[f]),
                          "drain_rate": self._rate(self._done[f], now)}
            out["backlog"] = {"depth": self._backlog_locked(),
                              "limit": self.backlog_limit,
                              "bind_rate":
                                  self._ledger.bind_rate(now)
                                  if self._ledger is not None
                                  else self._rate(self._bind_done, now)}
            return out
