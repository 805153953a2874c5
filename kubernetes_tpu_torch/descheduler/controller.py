"""The defrag wave loop (the descheduler's controller).

Strictly off the scheduler hot path: the controller is its own process
(cmd/descheduler.py) with its own client, LISTs truth per wave, solves
with models/defrag.py on the wave-loop thread, and commits migrations
through the Binding migration lane (from_host + pod_uid guards, atomic
evict-here + bind-there per item). Three structural throttles keep it
polite:

- a token bucket on waves (``qps``/``burst``, util/throttle semantics) —
  a wave with no token is declined, not queued;
- a pending-work check — while unbound pods exist the scheduler owns
  the cluster's churn budget, so the wave declines (``pending_work``)
  rather than racing the bind path for CAS wins;
- the solve's own move budget and acceptance gate (models/defrag.py).

A declined or conflicted wave is never an error: the next wave re-LISTs
truth and re-solves. Conflicts (per-item 409/404 from the commit guards)
are counted and the planned moves simply stay un-applied — no half-moved
pods, by the store transaction's contract.

Port of ``kubernetes_tpu/descheduler/controller.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models.defrag import DefragConfig, Move, defrag_wave
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.util.metrics import defrag_metrics
from kubernetes_tpu_torch.util.throttle import TokenBucketRateLimiter

__all__ = ["DeschedulerConfig", "WaveReport", "Descheduler"]


@dataclass(frozen=True)
class DeschedulerConfig:
    """Wave-loop knobs (cmd/descheduler.py flags map 1:1)."""

    period_s: float = 5.0          # wave loop tick
    qps: float = 0.2               # waves per second the bucket refills
    burst: int = 1                 # waves a quiet period may bank
    decline_on_pending: bool = True
    defrag: DefragConfig = field(default_factory=DefragConfig)


@dataclass
class WaveReport:
    """One wave's outcome — the record/metrics unit."""

    declined: str = ""             # rate_limited | pending_work | error | ""
    score_before: int = 0
    score_mandatory: int = 0
    score_after: int = 0
    proposed: int = 0
    committed: int = 0
    conflicts: int = 0             # per-item 409/404 at commit
    voluntary_dropped: bool = False
    nodes_drained: List[str] = field(default_factory=list)
    nodes_emptied: List[str] = field(default_factory=list)
    undrainable: int = 0           # cordoned residents that cannot move
    moves: List[Move] = field(default_factory=list)
    error: str = ""


class Descheduler:
    """The background wave loop over a client."""

    def __init__(self, client, config: Optional[DeschedulerConfig] = None,
                 metrics=None):
        self.client = client
        self.config = config or DeschedulerConfig()
        self.metrics = metrics or defrag_metrics()
        self.limiter = TokenBucketRateLimiter(self.config.qps,
                                              self.config.burst)
        self.encoder = IncrementalEncoder()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_report: Optional[WaveReport] = None

    # -- wave ---------------------------------------------------------------

    def _pending_pods(self) -> int:
        lst = self.client.pods(api.NamespaceAll).list(
            field_selector="spec.host=")
        return len(lst.items)

    def run_once(self, force: bool = False) -> WaveReport:
        """One wave: throttle -> LIST truth -> solve -> commit -> report.
        ``force`` skips the token bucket (tests, cmd --one-shot)."""
        rep = WaveReport()
        m = self.metrics
        if not force and not self.limiter.can_accept():
            rep.declined = "rate_limited"
            m.declined.inc("rate_limited")
            self.last_report = rep
            return rep
        try:
            if self.config.decline_on_pending and self._pending_pods():
                rep.declined = "pending_work"
                m.declined.inc("pending_work")
                self.last_report = rep
                return rep
            nodes = list(self.client.nodes().list().items)
            pods = [p for p in self.client.pods(api.NamespaceAll).list(
                field_selector="spec.host!=").items
                if p.status.phase not in (api.PodSucceeded, api.PodFailed)]
            services = list(self.client.services(
                api.NamespaceAll).list().items)
            t0 = time.thread_time()
            plan, cand, moves = defrag_wave(nodes, pods,
                                            services=services,
                                            cfg=self.config.defrag,
                                            encoder=self.encoder)
            m.wave_seconds.inc(by=time.thread_time() - t0)
            rep.score_before = plan.score_before
            rep.score_mandatory = plan.score_mandatory
            rep.score_after = plan.score_after
            rep.voluntary_dropped = plan.voluntary_dropped
            rep.undrainable = len(cand.undrainable)
            rep.proposed = len(moves)
            rep.moves = moves
            committed = self._commit(moves, rep)
            self._account_nodes(nodes, pods, committed, rep)
        except Exception as e:  # LIST/commit transport failures: next wave
            rep.declined = "error"
            rep.error = repr(e)
            m.declined.inc("error")
            self.last_report = rep
            return rep
        m.waves.inc()
        if rep.score_after > rep.score_mandatory:
            m.score_regressions.inc()  # structurally unreachable
        m.migrations.inc(by=rep.committed)
        m.conflicts.inc(by=rep.conflicts)
        m.nodes_drained.inc(by=len(rep.nodes_drained))
        m.nodes_emptied.inc(by=len(rep.nodes_emptied))
        # gauge AFTER commit: what the wave left behind, the monotone
        # series the SLO watchdog rides
        m.fragmentation_score.set(rep.score_after
                                  if rep.committed == rep.proposed
                                  else rep.score_before)
        self.last_report = rep
        return rep

    def _commit(self, moves: List[Move], rep: WaveReport) -> List[Move]:
        """Commit accepted moves namespace-by-namespace (the bind_batch
        authorization unit) as migration bindings. Per-item semantics:
        a 409/404 leaves exactly that pod un-moved."""
        by_ns: Dict[str, List[Move]] = {}
        for mv in moves:
            by_ns.setdefault(mv.namespace, []).append(mv)
        committed: List[Move] = []
        for ns in sorted(by_ns):
            batch = api.BindingList(items=[api.Binding(
                metadata=api.ObjectMeta(name=mv.name, namespace=ns),
                pod_name=mv.name, host=mv.target,
                from_host=mv.source, pod_uid=mv.uid)
                for mv in by_ns[ns]])
            res = self.client.pods(ns).bind_many(batch)
            for mv, r in zip(by_ns[ns], res.items):
                if r.error:
                    rep.conflicts += 1
                else:
                    rep.committed += 1
                    committed.append(mv)
        return committed

    @staticmethod
    def _account_nodes(nodes, pods, committed: List[Move],
                       rep: WaveReport) -> None:
        """Which nodes did the committed set actually empty? Computed
        from the LISTed truth the wave solved against, so a drain that
        lost one item to a 409 is honestly NOT drained."""
        moved = {mv.uid for mv in committed}
        left: Dict[str, int] = {n.metadata.name: 0 for n in nodes}
        for p in pods:
            if p.status.host in left and p.metadata.uid not in moved:
                left[p.status.host] += 1
        cordoned = {n.metadata.name for n in nodes if n.spec.unschedulable}
        touched = {mv.source for mv in committed}
        for name in sorted(touched):
            if left.get(name, 1) != 0:
                continue
            if name in cordoned:
                rep.nodes_drained.append(name)
            else:
                rep.nodes_emptied.append(name)

    # -- loop ---------------------------------------------------------------

    def run(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="descheduler-wave")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.period_s):
            self.run_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
