"""The "tpu-batch" scheduler profile — wave scheduling on the batch solver.

Port of the causal loop of ``kubernetes_tpu/scheduler/tpu_batch.py``. It
replaces the reference's one-pod-at-a-time loop
(plugin/pkg/scheduler/scheduler.go:87-90 ``util.Forever(scheduleOne)``)
with:

    drain a wave from the FIFO -> gang quorum gate -> encode the cluster
    (IncrementalEncoder: O(changed) deltas from the modeler's changelog)
    -> ONE solve (the CUDA kernel commit_solve on the card) -> replay the
    preempting placements into victim sets -> commit bindings (a
    preemptor's as an atomic evict+bind) -> assume pods

Decisions are bit-identical to running the serial scheduler over the same
wave, because the solver reproduces the serial sequential-commit
semantics inside one call. The Binding write path, backoff and error
handling and the assume/confirm modeler are the serial driver's
(scheduler/driver.py). Bind conflicts invalidate that pod only; the error
handler requeues it and the next wave re-solves against fresh state.

The scheduler runs on ``cuda`` unless the caller passes ``device="cpu"``
(the plain version of the kernel); without a card the default raises.

Preemption: a pod the solve placed by eviction gets its victims from the
incremental encoder's per-node registry (models/preempt.assign_victims)
and binds with them in one atomic evict+bind; the victims' deletes then
reach the encoder like any other delete. The full-encoder path (policies
with service affinity) has no registry to name victims from and requeues
such pods, as the reference does. A binder without ``bind_many`` commits
pod by pod (``scheduler_bind_fallback_total`` counts those waves).

Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item rather than replaced by a substitute: the pipelined loop
(``pipeline=True``), the shared solver daemon (``solver_addr``), the
device mesh (``mesh="on"``) and the boot prewarm (``prewarm=True``). A
wave that raises ``NotImplementedError`` is handed to the error handler
and the error propagates out of ``schedule_wave``, so the loop stops
instead of requeueing it forever. Unschedulable pods get
the generic ``FitError`` line (the diagnosis layer, models/explain.py, is
not ported), and the loop records no tracing spans.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from datetime import timezone
from typing import List, NamedTuple, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models import preempt as preempt_mod
from kubernetes_tpu_torch.models.batch_solver import (decisions_to_names,
                                                      resolve_device, solve)
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import batch_policy_from
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.scheduler.driver import (ConfigFactory,
                                                   SchedulerConfig)
from kubernetes_tpu_torch.scheduler.generic import FitError
from kubernetes_tpu_torch.util import metrics

__all__ = ["BatchScheduler"]

_log = logging.getLogger("kubernetes_tpu_torch.scheduler.tpu_batch")


class _WaveMetrics:
    """Per-wave instrumentation (the kubelet-metrics analog for the wave
    loop, ref: pkg/kubelet/metrics/metrics.go): encode, solve and commit
    seconds per wave, pods drained, full-list encoder syncs."""

    _singleton = None

    def __init__(self):
        reg = metrics.default_registry()
        buckets = (0.001, 0.0025, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5)
        self.encode = reg.histogram(
            "scheduler_wave_encode_seconds",
            "Snapshot encode time per wave", buckets=buckets)
        self.solve = reg.histogram(
            "scheduler_wave_solve_seconds",
            "Solver time per wave", buckets=buckets)
        self.commit = reg.histogram(
            "scheduler_wave_commit_seconds",
            "Bind + assume time per wave (the store round-trips)",
            buckets=buckets)
        self.pods = reg.counter(
            "scheduler_wave_pods_total", "Pods drained into waves")
        self.resyncs = reg.counter(
            "scheduler_wave_encode_resyncs_total",
            "Full-list encoder syncs (vs O(changed) delta waves)")
        self.bind_fallback = reg.counter(
            "scheduler_bind_fallback_total",
            "Waves committed through per-pod binder.bind because the "
            "binder lacks the bind_many seam (one round trip per pod)")
        # a recompile/re-encode cliff is a few slow waves among fast ones:
        # quantiles average it away, the running max cannot
        self.stall_max = reg.gauge(
            "scheduler_wave_stall_max_seconds",
            "Largest single-wave encode or solve stall since boot")
        self._stall_lock = threading.Lock()
        self._stall_max_v = 0.0

    def note_stall(self, dt: float) -> None:
        with self._stall_lock:
            if dt > self._stall_max_v:
                self._stall_max_v = dt
                self.stall_max.set(dt)


def _wave_metrics() -> _WaveMetrics:
    if _WaveMetrics._singleton is None:
        _WaveMetrics._singleton = _WaveMetrics()
    return _WaveMetrics._singleton


class _WaveDecisions(NamedTuple):
    """One wave's solve outcome: per-pod host names (None =
    unschedulable), the victim sets of preempting placements, the solve's
    start (the preempt-to-bind window opens there) and the raw outputs
    over the padded pod axis."""

    hosts: list
    victims: list           # aligned with hosts; None = normal placement
    t0: float               # perf_counter at the solve's start
    chosen: object          # [P] node indices (-1 = unschedulable)
    scores: object          # [P] winning scores (preempt score channel)


class BatchScheduler:
    """Wave-based driver over SchedulerConfig plumbing.

    ``batch_policy`` is the normalized form of the config's recorded
    provider / policy file (models/policy.batch_policy_from), so
    constructing this class for an unsupported configuration raises
    UnsupportedPolicy. ``device`` is where each wave solves: ``cuda``
    unless the caller names another; without a card the default raises."""

    def __init__(self, config: SchedulerConfig, factory: ConfigFactory,
                 client, wave_size: int = 1024, wave_linger_s: float = 0.02,
                 pipeline: Optional[bool] = None, device=None):
        self.config = config
        self.factory = factory
        self.client = client
        self.wave_size = wave_size
        self.wave_linger_s = wave_linger_s
        self.device = resolve_device(device)
        self.batch_policy = batch_policy_from(config.provider, config.policy)
        if config.solver_addr:
            raise NotImplementedError(
                "the shared solver daemon is not ported yet (ROADMAP Queue "
                "1: solver/service.py + cmd/solverd.py)")
        if config.pipeline if pipeline is None else pipeline:
            raise NotImplementedError(
                "the pipelined wave loop is not ported yet (ROADMAP Queue "
                "1: the pipelined loop)")
        if config.mesh == "on":
            raise NotImplementedError(
                "the device-mesh solve is not ported yet (ROADMAP Queue 1: "
                "parallel/mesh.py + solver/mesh_exec.py)")
        if config.prewarm:
            raise NotImplementedError(
                "the boot prewarm is not ported yet (ROADMAP Queue 1: "
                "cmd/scheduler.py); the kernel builds at its first launch")
        try:
            # delta-maintained node planes + sticky vocabularies: per-wave
            # encode cost is O(changed pods)
            self._encoder = IncrementalEncoder(self.batch_policy)
        except ValueError:
            # CheckServiceAffinity policies are arrival-order dependent;
            # full re-encode per wave stays authoritative
            self._encoder = None
        # modeler changelog cursor for the O(changed) wave path; None
        # until the first full sync establishes the resident planes
        self._delta_token = None
        # journal-replay resync: a cadence-gated copy-on-write checkpoint
        # of the encoder planes, paired with the modeler token it is
        # causal with. A resync restores it and replays the changelog
        # (O(missed events)) instead of re-encoding the cluster.
        self._sx = metrics.slipstream_metrics()
        self._ckpt = None            # (encoder state, modeler token)
        self._ckpt_waves = 0
        self.checkpoint_every = 4
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the NotImplementedError that stopped the loop thread, if any
        self.fault: Optional[BaseException] = None
        # pod-lifecycle latency: bind instants by uid, consumed when the
        # assigned-pods store delivers the bound pod back. Bounded — a pod
        # whose confirm never arrives must not leak the map.
        self._pod_lat = metrics.pod_latency_metrics()
        self._bind_t: "OrderedDict[str, float]" = OrderedDict()
        # deliveries that beat the arming loop (the bind committed before
        # bind_many returned): the observer stashes the instant here and
        # the arming loop consumes it
        self._obs_t: "OrderedDict[str, float]" = OrderedDict()
        self._bind_t_lock = threading.Lock()
        factory.scheduled_pods.subscribe(self._observe_scheduled)

    _BIND_T_MAX = 1 << 16

    def _observe_scheduled(self, pod) -> None:
        """Store.subscribe hook (delivery thread): the bound pod came back
        through the scheduler's own watch — the fan-out leg of its path."""
        try:
            uid = pod.metadata.uid
        except AttributeError:
            return
        now = time.monotonic()
        with self._bind_t_lock:
            t0 = self._bind_t.pop(uid, None)
            if t0 is None:
                # not armed (yet): a re-delivery, a foreign bind, or a
                # delivery that raced ahead of the arming loop
                self._obs_t[uid] = now
                while len(self._obs_t) > self._BIND_T_MAX:
                    self._obs_t.popitem(last=False)
                return
        self._pod_lat.watch_observe.observe(now - t0)

    # -- wave assembly ------------------------------------------------------
    def _drain_wave(self, timeout: Optional[float]) -> List[api.Pod]:
        pods: List[api.Pod] = [self.config.next_pod(timeout)]
        deadline = time.monotonic() + self.wave_linger_s
        while len(pods) < self.wave_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                pods.append(self.config.next_pod(remaining))
            except TimeoutError:
                break
        return pods

    def _make_get_existing(self):
        """Lazy memoized existing-pod list: materialized only when
        something needs it (gang quorum, encoder resync), so the
        steady-state delta path stays O(changed). The token is taken
        BEFORE the list it pairs with, so an event racing the list is
        re-delivered by the next delta (idempotent in the encoder)."""
        c = self.config
        memo: dict = {}

        def get_existing():
            if "list" not in memo:
                memo["token"] = c.modeler.token()
                memo["list"] = c.modeler.list()
            return memo["list"]

        get_existing.pre_token = lambda: memo.get("token")
        return get_existing

    def _prepare_wave(self, pods: List[api.Pod]):
        """Admission for a drained wave: node/service listing + gang
        quorum gate + gang-contiguous ordering. Returns (pending, nodes,
        services, get_existing), or None when the wave emptied (every pod
        was evented + handed to the error handler)."""
        c = self.config
        get_existing = self._make_get_existing()
        try:
            nodes = c.minion_lister.list().items
            services = self.factory.service_store.list()
            pending, starved = self._gate_gang_quorum(pods, get_existing)
        except Exception as e:
            for pod in pods:
                self._record(pod, "FailedScheduling",
                             "Error scheduling wave: %s", e)
                c.error(pod, e)
            return None
        for pod in starved:
            self._record(pod, "FailedScheduling",
                         "Pod group below min-members quorum")
            c.error(pod, FitError(pod, {}))
        if not pending:
            return None
        return gang.order_wave(pending), nodes, services, get_existing

    def _gate_gang_quorum(self, pods: List[api.Pod], get_existing
                          ) -> tuple[List[api.Pod], List[api.Pod]]:
        """Split the wave into (schedulable, quorum-failed): a gang whose
        membership is below its declared min-members fails its present
        members up front (requeue + backoff) instead of solving a partial
        group as if it were whole. Quorum is aggregated per group (max of
        the members' declarations) and counts already-placed members of
        the group from the cluster alongside the wave's."""
        present: dict = {}
        quorum: dict = {}
        for p in pods:
            k = gang.gang_key(p)
            if k is not None:
                present[k] = present.get(k, 0) + 1
                quorum[k] = max(quorum.get(k, 0), gang.gang_min_members(p))
        if not present or not any(quorum.values()):
            return list(pods), []  # gang-free wave: skip the O(cluster) scan
        for p in get_existing():
            k = gang.gang_key(p)
            if k in present and (p.status.host or p.spec.host):
                present[k] += 1
        ok: List[api.Pod] = []
        starved: List[api.Pod] = []
        for p in pods:
            k = gang.gang_key(p)
            if k is not None and present[k] < quorum[k]:
                starved.append(p)
            else:
                ok.append(p)
        return ok, starved

    # -- solving ------------------------------------------------------------
    def _encode_wave(self, nodes, pending, services, get_existing):
        t0 = time.perf_counter()
        if self._encoder is not None:
            snap = self._encode_incremental(nodes, pending, services,
                                            get_existing)
        else:
            snap = encode_snapshot(nodes, get_existing(), pending, services,
                                   policy=self.batch_policy)
        dt = time.perf_counter() - t0
        _wave_metrics().encode.observe(dt)
        _wave_metrics().note_stall(dt)
        return snap

    def _solve_snap(self, snap, n_pending: int) -> _WaveDecisions:
        """One wave's solve on ``self.device`` -> _WaveDecisions. Inside
        the kernel's domain this is one launch of commit_solve; the gang
        all-or-nothing post-pass is part of ``solve``. A placed pod whose
        score encodes a preemption threshold gets its victims from the
        incremental encoder's per-node registry: the deterministic replay
        of models/preempt.assign_victims (the reference's
        tpu_batch.py:477-499). The encoder changes only after this wave's
        decisions are read."""
        t0 = time.perf_counter()
        chosen, scores = solve(snap, device=self.device)
        dt = time.perf_counter() - t0
        _wave_metrics().solve.observe(dt)
        _wave_metrics().note_stall(dt)
        _wave_metrics().pods.inc(by=n_pending)
        hosts = decisions_to_names(snap, chosen)
        victims = [None] * len(hosts)
        if any(preempt_mod.is_preempt_score(int(s))
               for s in scores[:len(hosts)]):
            if self._encoder is not None:
                victims = preempt_mod.assign_victims(
                    chosen, scores, snap.band_prio, n_pods=len(hosts),
                    node_pods=self._encoder.resident_on)
            else:
                # the full-encoder path has no resident-pod registry to
                # name victims from: those pods go back to the queue
                if not getattr(self, "_warned_preempt_encoder", False):
                    self._warned_preempt_encoder = True
                    _log.warning(
                        "preemption decisions need the incremental "
                        "encoder's pod registry; requeueing preempting "
                        "pods (the policy forces the full encoder)")
                hosts = [None if preempt_mod.is_preempt_score(int(s))
                         else h for h, s in zip(hosts, scores)]
        return _WaveDecisions(hosts, victims, t0, chosen, scores)

    def _default_solve(self, nodes, get_existing, pending, services):
        snap = self._encode_wave(nodes, pending, services, get_existing)
        return self._solve_snap(snap, len(pending))

    def _encode_incremental(self, nodes, pending, services, get_existing):
        """O(changed + pending) when the modeler's changelog covers the
        gap from the encoder's own token; otherwise journal replay —
        restore the last checkpoint and replay the changelog over it,
        O(missed events) — and only when the journal cannot cover the gap
        either (no checkpoint yet, window exceeded, node/service planes
        changed) the full O(cluster) list sync, counted by reason
        (encoder_resync_full_total). The resync token is taken BEFORE the
        list it pairs with, so an event racing the list is re-delivered
        rather than lost (re-applying an upsert or remove is a no-op)."""
        if self._delta_token is not None:
            d = self.config.modeler.delta(self._delta_token)
            if d is not None:
                upserted, removed, token = d
                snap = self._encoder.encode_delta(nodes, upserted, removed,
                                                  pending, services)
                if snap is not None:
                    self._delta_token = token
                    self._maybe_checkpoint(token)
                    return snap
        snap, reason = self._replay_resync(nodes, pending, services)
        if snap is not None:
            return snap
        existing = get_existing()
        self._delta_token = get_existing.pre_token()
        _wave_metrics().resyncs.inc()
        self._sx.resync_full.inc(reason)
        snap = self._encoder.encode(nodes, existing, pending, services)
        self._maybe_checkpoint(self._delta_token)
        return snap

    def _maybe_checkpoint(self, token) -> None:
        """Cadence-gated encoder checkpoint at a clean, token-paired state
        (delta success or post-full-sync): every ``checkpoint_every``
        waves keeps the replay gap far inside the store changelog
        window."""
        self._ckpt_waves += 1
        if self._ckpt is not None and \
                self._ckpt_waves < self.checkpoint_every:
            return
        t0 = time.perf_counter()
        try:
            state = self._encoder.checkpoint()
        except ValueError:
            return  # nothing resident yet
        self._sx.checkpoint_s.observe(time.perf_counter() - t0)
        self._ckpt = (state, token)
        self._ckpt_waves = 0

    def _replay_resync(self, nodes, pending, services):
        """The journal-replay resync: restore the last checkpoint, then
        replay every store event since its token. Returns ``(snap,
        reason)``; snap is None when the journal could not cover the gap
        and the caller pays the full re-encode, counted under
        ``reason``."""
        if self._ckpt is None:
            return None, "no_checkpoint"
        state, ckpt_token = self._ckpt
        d = self.config.modeler.delta(ckpt_token)
        if d is None:
            return None, "window_exceeded"
        upserted, removed, token = d
        self._encoder.restore(state)
        snap = self._encoder.encode_delta(nodes, upserted, removed,
                                          pending, services)
        if snap is None:
            # node/service planes changed (or capacity overflow): the
            # full diff-walk re-establishes everything; the restored
            # planes are simply its starting point
            return None, "planes_changed"
        self._delta_token = token
        self._sx.resync_replay.inc()
        self._maybe_checkpoint(token)
        return snap, ""

    # -- commit -------------------------------------------------------------
    def _split_decisions(self, pending, decisions: _WaveDecisions):
        """(pod, host, victims) triples for placed pods (victims None for
        a normal placement); unschedulable pods are evented + handed to
        the error handler (backoff + requeue)."""
        c = self.config
        placed = []
        for pod, host, vict in zip(pending, decisions.hosts,
                                   decisions.victims):
            if host is None:
                err = FitError(pod, {})
                self._record(pod, "FailedScheduling",
                             "Error scheduling: %s", err)
                c.error(pod, err)
            else:
                placed.append((pod, host, vict))
        return placed

    def _commit_wave(self, placed, preempt_t0: Optional[float] = None):
        """Bind the wave's placements, event every outcome, assume the
        winners. Returns (outcomes, bound): outcomes[i] is None on
        success, else the bind error (aligned with ``placed``). A
        placement with victims commits as an atomic evict+bind
        (Binding.victims): the server deletes every victim and binds the
        pod in one step, or fails the item with 409; the victims' deletes
        then reach the encoder like any other. ``preempt_t0`` opens the
        preempt-to-bind window."""
        t_commit0 = time.perf_counter()
        c = self.config

        def mk_binding(pod, host, victims) -> api.Binding:
            refs = [api.ObjectReference(kind="Pod", namespace=v.namespace,
                                        name=v.name, uid=v.uid)
                    for v in victims] if victims else []
            return api.Binding(
                metadata=api.ObjectMeta(name=pod.metadata.name,
                                        namespace=pod.metadata.namespace),
                pod_name=pod.metadata.name, host=host, victims=refs)

        outcomes: List[Optional[Exception]] = [None] * len(placed)
        bind_many = getattr(c.binder, "bind_many", None)
        if bind_many is not None:
            # one transactional store pass per namespace for the wave's
            # bindings; per-pod CAS semantics are preserved — a lost race
            # invalidates only that pod, which requeues
            by_ns: dict = {}
            for idx, (pod, _host, _vict) in enumerate(placed):
                by_ns.setdefault(pod.metadata.namespace, []).append(idx)
            for ns, idxs in by_ns.items():
                blist = api.BindingList(items=[
                    mk_binding(*placed[i]) for i in idxs])
                try:
                    results = bind_many(ns, blist)
                    for i, r in zip(idxs, results.items):
                        if r.error:
                            err = RuntimeError(r.error)
                            err.code = r.code  # CAS-vs-other classification
                            outcomes[i] = err
                except Exception as e:
                    for i in idxs:
                        outcomes[i] = e
        else:
            # a binder without the batch seam: one bind per pod, as the
            # reference's fallback (tpu_batch.py:832-846)
            _wave_metrics().bind_fallback.inc()
            if not getattr(self, "_warned_bind_fallback", False):
                self._warned_bind_fallback = True
                _log.warning(
                    "binder %s has no bind_many: committing waves one bind "
                    "round trip per pod (scheduler_bind_fallback_total "
                    "counts the waves)", type(c.binder).__name__)
            for idx, triple in enumerate(placed):
                try:
                    c.binder.bind(mk_binding(*triple))
                except Exception as e:
                    outcomes[idx] = e

        # preemption outcome accounting (the scheduler_preemption_* family)
        pmx = None
        now_p = time.perf_counter()
        for (pod, _host, vict), err in zip(placed, outcomes):
            if not vict:
                continue
            if pmx is None:
                pmx = metrics.preemption_metrics()
            if err is None:
                pmx.attempts.inc()
                pmx.victims.inc(by=len(vict))
                p_prio = api.pod_priority(pod)
                bad = sum(1 for v in vict if v.priority >= p_prio)
                if bad:
                    pmx.higher_evictions.inc(by=bad)
                if preempt_t0 is not None:
                    pmx.bind_seconds.observe(max(0.0, now_p - preempt_t0))
            elif getattr(err, "code", None) == 409:
                # only a lost compare-and-swap counts as a conflict; other
                # failures stay visible as requeues
                pmx.conflicts.inc()

        bound = 0
        now_m = time.monotonic()
        now_w = time.time()
        for (pod, host, _vict), err in zip(placed, outcomes):
            if err is not None:
                # lost a CAS race: requeue; next wave sees fresh state
                self._record(pod, "FailedScheduling",
                             "Binding rejected: %s", err)
                c.error(pod, err)
                continue
            self._record(pod, "Scheduled", "Successfully assigned %s to %s",
                         pod.metadata.name, host)
            # value copy before mutating (the popped pod may be shared)
            cl = deep_clone(pod)
            cl.spec.host = host
            cl.status.host = host
            c.modeler.assume_pod(cl)
            bound += 1
            # pod-lifecycle latency: create -> bind committed, and arm the
            # bind -> watch-observe leg for the store hook
            ct = pod.metadata.creation_timestamp
            if ct is not None:
                ts = ct.timestamp() if ct.tzinfo is not None else \
                    ct.replace(tzinfo=timezone.utc).timestamp()
                self._pod_lat.e2e.observe(max(0.0, now_w - ts))
            with self._bind_t_lock:
                obs = self._obs_t.pop(pod.metadata.uid, None)
                if obs is None:
                    self._bind_t[pod.metadata.uid] = now_m
                    while len(self._bind_t) > self._BIND_T_MAX:
                        self._bind_t.popitem(last=False)
            if obs is not None:
                # the delivery beat this arming loop
                self._pod_lat.watch_observe.observe(max(0.0, obs - now_m))
        _wave_metrics().commit.observe(time.perf_counter() - t_commit0)
        return outcomes, bound

    def schedule_wave(self, timeout: Optional[float] = None) -> int:
        """Drain, solve, commit — the causal wave. Returns the number of
        pods bound. Raises TimeoutError when no pod arrived within
        ``timeout``, and NotImplementedError (after handing the wave to
        the error handler) when the wave needs a feature the port lacks."""
        c = self.config
        pods = self._drain_wave(timeout)
        prep = self._prepare_wave(pods)
        if prep is None:
            return 0
        pending, nodes, services, get_existing = prep
        try:
            # `existing` resolves lazily: the delta path never lists it
            decisions = self._default_solve(nodes, get_existing, pending,
                                            services)
        except Exception as e:
            # a failed solve must not drop the drained wave: hand every pod
            # to the error handler for backoff+requeue, like the serial
            # driver does per pod (scheduler.go:96-101)
            for pod in pending:
                self._record(pod, "FailedScheduling",
                             "Error scheduling wave: %s", e)
                c.error(pod, e)
            if isinstance(e, NotImplementedError):
                raise
            _log.warning("wave solve failed; %d pods requeued: %s",
                         len(pending), e)
            return 0

        placed = self._split_decisions(pending, decisions)
        if not placed:
            return 0
        _, bound = self._commit_wave(placed, decisions.t0)
        return bound

    # -- the loop -----------------------------------------------------------
    def run(self) -> "BatchScheduler":
        self._thread = threading.Thread(target=self._loop_causal,
                                        daemon=True,
                                        name="tpu-batch-scheduler")
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Stop the loop; with ``timeout``, wait that long for its thread
        to exit. Returns True once the thread is down (or never ran)."""
        self._stop.set()
        if self._thread is None:
            return True
        if timeout is not None:
            self._thread.join(timeout)
        return not self._thread.is_alive()

    def _loop_causal(self) -> None:
        # per-pod and per-wave failures are evented + requeued inside
        # schedule_wave; an exception escaping to here is an
        # infrastructure fault that must not spin silently, and a wave the
        # port cannot solve stops the loop
        errs = metrics.default_registry().counter(
            "scheduler_wave_loop_errors_total",
            "exceptions escaping the tpu-batch wave loop")
        while not self._stop.is_set():
            try:
                self.schedule_wave(timeout=0.2)
            except TimeoutError:
                continue
            except NotImplementedError as e:
                errs.inc()
                _log.error("wave loop stopped: %s", e)
                self.fault = e
                self._stop.set()
            except Exception:
                errs.inc()
                _log.exception("wave loop error (backing off 10ms)")
                time.sleep(0.01)

    def _record(self, pod, reason, fmt, *args):
        if self.config.recorder is not None:
            self.config.recorder.eventf(pod, reason, fmt, *args)
