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

Boot prewarm (``config.prewarm``, the binary's ``--prewarm``): off the
loop thread, once the node store fills, build and load the commit_solve
kernel and solve one exemplar wave over the live cluster, then set the
``compile_prewarm_ready`` gauge to 1, so the kernel never compiles inside
a load window. On the CPU there is nothing to build; the exemplar wave
runs the plain version.

Pipelined mode (``pipeline=True``, the binary's ``--pipeline``): the
reference's speculative double-buffered loop. Wave k's solve runs on a
side thread (``tpu-batch-solve``) while the loop thread drains wave k+1;
once wave k's decisions exist its bindings commit on a commit thread
(``tpu-batch-commit``) while the loop thread encodes wave k+1 against the
PREDICTED post-commit state (the encoder's resident planes plus wave k's
not-yet-committed placements) and dispatches its solve. When the commit
lands, the prediction is verified before anything of wave k+1 may
commit: every placed pod bound at its chosen host, and the modeler's
changelog holds exactly those events. Any divergence (a CAS-lost bind, a
foreign store delta, a changelog resync) discards the speculative solve
unseen, rolls the predicted rows back and re-encodes causally. Committed
decisions therefore equal the causal loop's; speculation changes when
work runs, never what state a decision was solved against
(``scheduler_pipeline_*`` counts waves, hits, invalidations by reason and
overlapped seconds). Waves with gang members encode causally. A policy
that forces the full encoder runs the causal loop, with a logged warning,
as in the reference.

Unschedulable pods get the reference's per-filter breakdown line in
their FailedScheduling event (models/explain.py: rate-limited, on the
loop thread only, on ``self.device``). With tracing on (util/tracing.py)
each wave is one trace of ``wave.drain/prepare/encode/solve/commit``
spans, in either loop.

The shared solver daemon (``solver=``, or ``config.solver_addr``, the
binary's ``--solver-addr``): each wave's solve goes to a kube-solverd
process through ``solver/client.RemoteSolver`` inside the ``wave.solve``
span, whose context rides the v3 frame; the daemon coalesces concurrent
waves of several schedulers into one launch. When the daemon is busy or
away the wave solves in this process on ``self.device``
(``config.solver_fallback="inprocess"``) or fails and requeues
(``"requeue"``). With a daemon, the boot prewarm builds nothing here: the
daemon prewarms its own launches, and the ready gauge reads 1 at once.

The device mesh (``config.mesh``, the binary's ``--mesh``): resolved
once by ``parallel.mesh.maybe_mesh`` — None on a host with one device
(``auto``) or ``off``, ``MeshUnavailable`` for ``on`` there. With a mesh,
waves at or above the mesh node floor solve through
``parallel.mesh.solve_sharded`` (one commit_solve launch for a wave inside
the kernel's domain, the sharded loop beyond it), and a daemon client's
in-process fallback uses the same mesh. A wave that raises
``NotImplementedError`` is handed to the error handler and the error
propagates out of ``schedule_wave``, so the loop stops instead of
requeueing it forever.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from datetime import timezone
from typing import List, NamedTuple, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.cache import meta_namespace_key_func
from kubernetes_tpu_torch.models import explain as explain_mod
from kubernetes_tpu_torch.models import gang
from kubernetes_tpu_torch.models import preempt as preempt_mod
from kubernetes_tpu_torch.models.batch_solver import (decisions_to_names,
                                                      resolve_device, solve)
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import BatchPolicy, batch_policy_from
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.parallel.mesh import maybe_mesh
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.scheduler.driver import (ConfigFactory,
                                                   SchedulerConfig)
from kubernetes_tpu_torch.scheduler.generic import FitError
from kubernetes_tpu_torch.util import metrics, tracing

__all__ = ["BatchScheduler"]

_log = logging.getLogger("kubernetes_tpu_torch.scheduler.tpu_batch")

# KTPU_DEBUG gates the journal-replay bit-identity check (same idiom as
# models/incremental._DEBUG_VERIFY_EVICT): after every replay resync the
# from-scratch diff-walk re-runs and the resident fingerprint must not
# move. Assumes a quiescent store between replay and walk (tests, debug
# runs).
_DEBUG_REPLAY = os.environ.get("KTPU_DEBUG", "") not in ("", "0")


def _assumed_clone(pod, host):
    """The post-bind copy the modeler assumes (and the pipelined loop's
    speculative encode predicts): a value copy with ``host`` set."""
    cl = deep_clone(pod)
    cl.spec.host = host
    cl.status.host = host
    return cl


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
        # where this process's own wave solves ran (a daemon's waves are
        # not counted here), and the commit_solve launches they made
        self.device_solves = reg.counter(
            "scheduler_wave_device_solves_total",
            "Waves solved in this process, by device", ("device",))
        self.kernel_launches = reg.counter(
            "scheduler_wave_kernel_launches_total",
            "commit_solve launches made by this process's wave solves")
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


class _PipelineMetrics:
    """The scheduler_pipeline_* family: speculative double-buffering
    effectiveness. hits/invalidations partition the speculated waves;
    overlap_seconds_total is the wall time of host work that ran under a
    solve or a commit instead of after it."""

    _singleton = None

    def __init__(self):
        reg = metrics.default_registry()
        self.waves = reg.counter(
            "scheduler_pipeline_waves_total",
            "Waves run by the pipelined loop")
        self.hits = reg.counter(
            "scheduler_pipeline_speculation_hits_total",
            "Speculative encodes verified and dispatched without re-encode")
        self.invalidations = reg.counter(
            "scheduler_pipeline_speculation_invalidations_total",
            "Speculative encodes invalidated before dispatch, by divergence "
            "reason", label_names=("reason",))
        self.unspeculated = reg.counter(
            "scheduler_pipeline_unspeculated_waves_total",
            "Next waves encoded causally without a speculation attempt "
            "(gang members present, or no resident delta state yet)")
        self.overlap = reg.counter(
            "scheduler_pipeline_overlap_seconds_total",
            "Wall seconds of drain/encode work overlapped with the solve "
            "and commit of the preceding wave")


def _pipeline_metrics() -> _PipelineMetrics:
    if _PipelineMetrics._singleton is None:
        _PipelineMetrics._singleton = _PipelineMetrics()
    return _PipelineMetrics._singleton


class _WaveDecisions(NamedTuple):
    """One wave's solve outcome: per-pod host names (None =
    unschedulable), the victim sets of preempting placements, the solve's
    start (the preempt-to-bind window opens there), and the solved
    snapshot with the raw outputs over the padded pod axis — references
    only, for the diagnosis of unschedulable rows (models/explain.py)."""

    hosts: list
    victims: list           # aligned with hosts; None = normal placement
    t0: float               # perf_counter at the solve's start
    snap: object            # ClusterSnapshot the solve consumed
    chosen: object          # [P] node indices (-1 = unschedulable)
    scores: object          # [P] winning scores (preempt score channel)


class _SpecResult(NamedTuple):
    """Outcome of a speculative encode (see BatchScheduler._speculate)."""

    snap: object           # ClusterSnapshot, or None when speculation failed
    pending: Optional[list]  # ordered wave pods (None when snap is None)
    applied: bool          # predicted rows were applied to the encoder
    reason: str            # "" on success, else the failure class
    encode_s: float


class _Inflight(NamedTuple):
    """Carry between pipelined cycles: the wave whose solve is running on
    the solve thread right now."""

    fut: object            # Future -> _WaveDecisions
    pending: list          # the wave's ordered pods (snap row order)
    tctx: object = None    # the wave's trace context (None = untraced)


class BatchScheduler:
    """Wave-based driver over SchedulerConfig plumbing.

    ``batch_policy`` is the normalized form of the configured provider /
    policy file (models/policy.batch_policy_from). When not given it is
    derived from the config's recorded provider and policy, so
    constructing this class for an unsupported configuration raises
    UnsupportedPolicy. ``device`` is where each wave solves: ``cuda``
    unless the caller names another; without a card the default raises.
    ``solver`` is a shared-solver client (``solver/client.RemoteSolver``);
    None builds one from ``config.solver_addr`` when that is set, and
    otherwise every wave solves in this process."""

    def __init__(self, config: SchedulerConfig, factory: ConfigFactory,
                 client, wave_size: int = 1024, wave_linger_s: float = 0.02,
                 batch_policy: Optional[BatchPolicy] = None,
                 pipeline: Optional[bool] = None, device=None, solver=None):
        self.config = config
        self.factory = factory
        self.client = client
        self.wave_size = wave_size
        self.wave_linger_s = wave_linger_s
        self.device = resolve_device(device)
        self.batch_policy = batch_policy or batch_policy_from(
            config.provider, config.policy)
        _wave_metrics()   # the scheduler_wave_* family scrapes from boot
        # shared-solver seam: an explicit client, or one built from the
        # config's recorded solver topology (--solver-addr); None solves
        # in-process
        if solver is None and config.solver_addr:
            from kubernetes_tpu_torch.solver.client import RemoteSolver
            solver = RemoteSolver(
                config.solver_addr,
                fallback=config.solver_fallback != "requeue",
                device=self.device)
        self.solver = solver
        # speculative double-buffered wave loop (module docstring); None
        # inherits the config's recorded --pipeline flag
        self.pipeline = bool(config.pipeline if pipeline is None
                             else pipeline)
        # in-process device-mesh solve (kube-scheduler --mesh): resolved
        # once — None when single-device or off
        self._mesh = maybe_mesh(config.mesh, config.pods_axis)
        if self.solver is not None and self._mesh is not None:
            # a daemon wave solves under the daemon's own --mesh; this
            # covers the in-process fallback when the daemon is away
            self.solver.fallback_mesh = self._mesh
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
        # rate-limited unschedulability diagnosis over the solved wave's
        # planes, consulted only when a wave returns unschedulable pods
        self._explainer = explain_mod.Explainer(device=self.device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the error that stopped the loop thread (a NotImplementedError
        # wave, a failed boot prewarm), if any
        self.fault: Optional[BaseException] = None
        # seconds the boot prewarm took, once it finished
        self.prewarm_s: Optional[float] = None
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
        """Up to ``wave_size`` pods from the queue, lingering
        ``wave_linger_s`` for more. A pod the queue hands out again while
        the wave drains (a relist re-adds every unbound pod, the popped
        ones too) is one pod: its newer copy takes the first one's place.
        Placed twice, it would take a second node's capacity in the solve
        and lose its second bind."""
        first = self.config.next_pod(timeout)
        pods = {meta_namespace_key_func(first): first}
        deadline = time.monotonic() + self.wave_linger_s
        while len(pods) < self.wave_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                pod = self.config.next_pod(remaining)
            except TimeoutError:
                break
            pods[meta_namespace_key_func(pod)] = pod
        return list(pods.values())

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

    def _gate_gang_quorum(self, pods: List[api.Pod], get_existing=()
                          ) -> tuple[List[api.Pod], List[api.Pod]]:
        """Split the wave into (schedulable, quorum-failed): a gang whose
        membership is below its declared min-members fails its present
        members up front (requeue + backoff) instead of solving a partial
        group as if it were whole. Quorum is aggregated per group (max of
        the members' declarations) and counts already-placed members of
        the group from the cluster alongside the wave's. ``get_existing`` is
        the cluster's pods or a callable returning them."""
        present: dict = {}
        quorum: dict = {}
        for p in pods:
            k = gang.gang_key(p)
            if k is not None:
                present[k] = present.get(k, 0) + 1
                quorum[k] = max(quorum.get(k, 0), gang.gang_min_members(p))
        if not present or not any(quorum.values()):
            return list(pods), []  # gang-free wave: skip the O(cluster) scan
        existing = get_existing() if callable(get_existing) else get_existing
        for p in existing:
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
    def _encode_wave(self, nodes, pending, services, get_existing,
                     tctx=None):
        t0 = time.perf_counter()
        with tracing.span("wave.encode", parent=tctx, pods=len(pending)):
            if self._encoder is not None:
                snap = self._encode_incremental(nodes, pending, services,
                                                get_existing)
            else:
                snap = encode_snapshot(nodes, get_existing(), pending,
                                       services, policy=self.batch_policy)
        dt = time.perf_counter() - t0
        _wave_metrics().encode.observe(dt)
        _wave_metrics().note_stall(dt)
        return snap

    def _solve_snap(self, snap, n_pending: int, tctx=None) -> _WaveDecisions:
        """One wave's solve on ``self.device``, or through ``self.solver``
        (the shared daemon) -> _WaveDecisions. Inside the kernel's domain
        this is one launch of commit_solve; the gang all-or-nothing
        post-pass is part of ``solve`` and ``RemoteSolver.solve``. Runs on the
        pipelined loop's solve thread too; ``tctx`` carries the wave's
        trace across that thread boundary. A placed pod whose score
        encodes a preemption threshold gets its victims from the
        incremental encoder's per-node registry: the deterministic replay
        of models/preempt.assign_victims (the reference's
        tpu_batch.py:477-499). The encoder changes only after this wave's
        decisions are read (the ordering of ``_pipelined_cycle``)."""
        t0 = time.perf_counter()
        with tracing.span("wave.solve", parent=tctx, pods=n_pending):
            if self.solver is not None:
                chosen, scores = self.solver.solve(snap)
            else:
                before = commit_solver.solve_commit.launches
                chosen, scores = solve(snap, device=self.device,
                                       mesh=self._mesh)
                _wave_metrics().device_solves.inc(self.device.type)
                _wave_metrics().kernel_launches.inc(
                    by=commit_solver.solve_commit.launches - before)
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
        return _WaveDecisions(hosts, victims, t0, snap, chosen, scores)

    def _default_solve(self, nodes, get_existing, pending, services,
                       tctx=None):
        snap = self._encode_wave(nodes, pending, services, get_existing,
                                 tctx=tctx)
        return self._solve_snap(snap, len(pending), tctx=tctx)

    def _encode_incremental(self, nodes, pending, services, get_existing):
        """O(changed + pending) when the modeler's changelog covers the
        gap from the encoder's own token; otherwise journal replay —
        restore the last checkpoint and replay the changelog over it,
        O(missed events) — and only when the journal cannot cover the gap
        either (no checkpoint yet, window exceeded, node/service planes
        changed) the full list sync, O(cluster), counted by reason
        (encoder_resync_full_total). A modeler without a changelog (no
        ``delta`` or no ``token``) takes the full list sync every wave,
        counted as ``no_changelog``, with no resync token and no
        checkpoint. The resync token is taken BEFORE the list it pairs
        with — ``get_existing``'s own pre-token where it records one,
        else the modeler's token read before the list — so an event
        racing the list is re-delivered rather than lost (re-applying an
        upsert or remove is a no-op)."""
        modeler = self.config.modeler
        can_replay = hasattr(modeler, "delta") and hasattr(modeler, "token")
        if self._delta_token is not None and hasattr(modeler, "delta"):
            d = modeler.delta(self._delta_token)
            if d is not None:
                upserted, removed, token = d
                snap = self._encoder.encode_delta(nodes, upserted, removed,
                                                  pending, services)
                if snap is not None:
                    self._delta_token = token
                    self._maybe_checkpoint(token)
                    return snap
        reason = "no_changelog"
        if can_replay:
            snap, reason = self._replay_resync(nodes, pending, services,
                                               get_existing)
            if snap is not None:
                return snap
        if hasattr(modeler, "token"):
            fallback_token = modeler.token()
            existing = get_existing()
            pre = getattr(get_existing, "pre_token", lambda: None)()
            self._delta_token = pre if pre is not None else fallback_token
            _wave_metrics().resyncs.inc()
        else:
            existing = get_existing()
        self._sx.resync_full.inc(reason)
        snap = self._encoder.encode(nodes, existing, pending, services)
        if self._delta_token is not None:
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

    def _replay_resync(self, nodes, pending, services, get_existing):
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
        if _DEBUG_REPLAY:
            self._debug_verify_replay(nodes, pending, services,
                                      get_existing)
        self._maybe_checkpoint(token)
        return snap, ""

    def _debug_verify_replay(self, nodes, pending, services,
                             get_existing) -> None:
        """KTPU_DEBUG bit-identity gate: the from-scratch diff-walk over
        the authoritative pod list must be a NO-OP on a correctly
        replayed state — same planes, same vocab order, same registry —
        so the resident fingerprint must not move across it."""
        before = self._encoder.resident_fingerprint()
        self._encoder.encode(nodes, get_existing(), pending, services)
        after = self._encoder.resident_fingerprint()
        assert before == after, (
            "kube-slipstream: journal replay diverged from the "
            "authoritative re-encode")

    # -- commit -------------------------------------------------------------
    def _split_decisions(self, pending, decisions: _WaveDecisions):
        """(pod, host, victims) triples for placed pods (victims None for
        a normal placement); unschedulable pods are evented + handed to
        the error handler (backoff + requeue). When some pod is
        unschedulable, the diagnosis layer (rate-limited, loop thread
        only — models/explain.Explainer) renders the per-filter breakdown
        into the FailedScheduling event in place of the empty FitError
        line. It runs HERE — after the solve result exists and before this
        wave's commit is submitted — so it never sits inside the pipelined
        solve/commit overlap. A declined diagnosis keeps the generic
        message; the error handed to the requeue path is the same."""
        c = self.config
        diag_msgs = {}
        n_unsched = sum(1 for h in decisions.hosts if h is None)
        if n_unsched:
            try:
                diag_msgs = self._explainer.diagnose_wave(
                    decisions.snap, decisions.chosen, decisions.scores,
                    n_unsched=n_unsched)
            except Exception:
                _log.exception("kube-explain diagnosis failed; falling "
                               "back to the generic FailedScheduling "
                               "message")
        placed = []
        for row, (pod, host, vict) in enumerate(zip(
                pending, decisions.hosts, decisions.victims)):
            if host is None:
                err = FitError(pod, {})
                msg = diag_msgs.get(row)
                if msg is not None:
                    self._record(pod, "FailedScheduling", "%s", msg)
                else:
                    self._record(pod, "FailedScheduling",
                                 "Error scheduling: %s", err)
                c.error(pod, err)
            else:
                placed.append((pod, host, vict))
        return placed

    def _commit_wave(self, placed, assumed: Optional[list] = None,
                     tctx=None, preempt_t0: Optional[float] = None):
        """Bind the wave's placements, event every outcome, assume the
        winners. ``assumed`` optionally supplies the post-bind clones,
        aligned with ``placed``: the pipelined loop shares them with its
        speculative encode so the encoder and the modeler account the
        IDENTICAL objects. Returns (outcomes, bound): outcomes[i] is None
        on success, else the bind error (aligned with ``placed``). A
        placement with victims commits as an atomic evict+bind
        (Binding.victims): the server deletes every victim and binds the
        pod in one step, or fails the item with 409; the victims' deletes
        then reach the encoder like any other. ``preempt_t0`` opens the
        preempt-to-bind window."""
        with tracing.span("wave.commit", parent=tctx, pods=len(placed)):
            return self._commit_wave_inner(placed, assumed, preempt_t0)

    def _commit_wave_inner(self, placed, assumed: Optional[list],
                           preempt_t0: Optional[float]):
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

        if assumed is None:
            # value copy before mutating (the popped pod may be shared)
            assumed = [_assumed_clone(pod, host) for pod, host, _v in placed]
        bound = 0
        now_m = time.monotonic()
        now_w = time.time()
        for (pod, host, _vict), cl, err in zip(placed, assumed, outcomes):
            if err is not None:
                # lost a CAS race: requeue; next wave sees fresh state
                self._record(pod, "FailedScheduling",
                             "Binding rejected: %s", err)
                c.error(pod, err)
                continue
            self._record(pod, "Scheduled", "Successfully assigned %s to %s",
                         pod.metadata.name, host)
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
        t_dr0 = time.monotonic_ns()
        pods = self._drain_wave(timeout)
        # one trace per wave: a bare root context the stage spans attach
        # to; drain and prepare are recorded once they ended
        tctx = tracing.new_ctx()
        tracing.record("wave.drain", t_dr0, time.monotonic_ns(),
                       parent=tctx, pods=len(pods))
        t_pr0 = time.monotonic_ns()
        prep = self._prepare_wave(pods)
        tracing.record("wave.prepare", t_pr0, time.monotonic_ns(),
                       parent=tctx)
        if prep is None:
            return 0
        pending, nodes, services, get_existing = prep
        try:
            # `existing` resolves lazily: the delta path never lists it
            decisions = self._default_solve(nodes, get_existing, pending,
                                            services, tctx=tctx)
        except Exception as e:
            self._fail_wave(pending, e)
            if isinstance(e, NotImplementedError):
                raise
            _log.warning("wave solve failed; %d pods requeued: %s",
                         len(pending), e)
            return 0

        placed = self._split_decisions(pending, decisions)
        if not placed:
            return 0
        _, bound = self._commit_wave(placed, tctx=tctx,
                                     preempt_t0=decisions.t0)
        return bound

    def _fail_wave(self, pods, err) -> None:
        """A failed solve must not drop the drained wave: hand every pod
        to the error handler for backoff+requeue, like the serial driver
        does per pod (scheduler.go:96-101)."""
        for pod in pods:
            self._record(pod, "FailedScheduling",
                         "Error scheduling wave: %s", err)
            self.config.error(pod, err)

    # -- the pipelined wave loop ----------------------------------------------
    def _speculate(self, pods: List[api.Pod], predicted: List[api.Pod],
                   tctx=None) -> _SpecResult:
        """Encode wave k+1 against the PREDICTED post-commit state: the
        encoder's resident planes plus wave k's not-yet-committed
        placements. Runs on the loop thread while the commit thread binds
        wave k — the commit path never touches the encoder, and this
        never reads the modeler (a half-committed view would be
        unverifiable)."""
        t0 = time.perf_counter()
        enc = self._encoder
        if any(enc.has_pod(p.metadata.uid) for p in predicted):
            # a predicted pod is already resident (e.g. a stale requeue of
            # a pod another scheduler bound — its CAS will lose): applying
            # would re-account the row and rollback could not restore it
            return _SpecResult(None, None, False, "resident_conflict",
                               time.perf_counter() - t0)
        try:
            nodes = self.config.minion_lister.list().items
            services = self.factory.service_store.list()
        except Exception:
            return _SpecResult(None, None, False, "lister_error",
                               time.perf_counter() - t0)
        pending = gang.order_wave(pods)  # identity: the wave is gang-free
        t_enc0 = time.monotonic_ns()
        snap = enc.encode_delta(nodes, predicted, [], pending, services)
        tracing.record("wave.encode", t_enc0, time.monotonic_ns(),
                       parent=tctx, pods=len(pending), speculative=True)
        if snap is None:
            # encode_delta declines before applying anything when the
            # node/service planes changed, but an overflow is detected
            # after the apply — has_pod says which happened
            applied = any(enc.has_pod(p.metadata.uid) for p in predicted)
            return _SpecResult(None, None, applied, "encoder_fallback",
                               time.perf_counter() - t0)
        _wave_metrics().encode.observe(time.perf_counter() - t0)
        return _SpecResult(snap, pending, True, "", time.perf_counter() - t0)

    def _verify_speculation(self, spec: _SpecResult, predicted, outcomes):
        """The divergence check: compare the prediction (every placed pod
        bound at its chosen host, nothing else changed) against what
        actually happened. Returns (reason, token, failed_uids):

        - ``""``: the prediction held exactly — the speculative encode
          (and the solve already in flight on it) is valid;
        - ``"bind_failed"``: the only divergence is CAS-lost/failed binds
          (or a speculative overflow) — O(changed) repair is possible;
        - ``"store_delta"`` / ``"resync"``: foreign interference (another
          scheduler's pod landed, a pod was removed, the changelog window
          was exceeded) — full causal re-encode required.
        """
        failed_uids = {cl.metadata.uid for cl, err in zip(predicted, outcomes)
                       if err is not None}
        ok_uids = {cl.metadata.uid for cl in predicted} - failed_uids
        d = self.config.modeler.delta(self._delta_token)
        if d is None:
            return "resync", None, failed_uids
        upserted, removed, token = d
        by_uid = {cl.metadata.uid: cl.status.host for cl in predicted}
        matched = set()
        for p in upserted:
            uid = p.metadata.uid
            if uid in ok_uids and by_uid.get(uid) == p.status.host:
                matched.add(uid)
                continue
            if self._encoder.is_noop_upsert(p):
                continue  # watch-confirm re-delivery of a resident pod
            return "store_delta", None, failed_uids
        if removed or matched != ok_uids:
            # a removal touches node capacity; a missing assume event
            # means the changelog raced — both are foreign interference
            return "store_delta", None, failed_uids
        if failed_uids or spec.snap is None:
            return "bind_failed", token, failed_uids
        return "", token, failed_uids

    def _dispatch_causal(self, pods, solve_pool, pm: _PipelineMetrics,
                         tctx=None) -> Optional[_Inflight]:
        """Prepare + causally encode + dispatch a wave (bootstrap, and the
        restart path after a divergence or an unspeculated wave). ``tctx``
        reuses a trace the caller already opened for these pods (the
        pipelined drain leg); None starts a fresh wave trace."""
        if not pods:
            return None
        if tctx is None:
            tctx = tracing.new_ctx()
        t_pr0 = time.monotonic_ns()
        prep = self._prepare_wave(pods)
        tracing.record("wave.prepare", t_pr0, time.monotonic_ns(),
                       parent=tctx)
        if prep is None:
            return None
        pending, nodes, services, get_existing = prep
        snap = self._encode_wave(nodes, pending, services, get_existing,
                                 tctx=tctx)
        pm.waves.inc()
        return _Inflight(solve_pool.submit(self._solve_snap, snap,
                                           len(pending), tctx),
                         pending, tctx)

    def _pipelined_cycle(self, inflight: Optional[_Inflight], solve_pool,
                         commit_pool, pm: _PipelineMetrics
                         ) -> Optional[_Inflight]:
        """One double-buffered wave. With wave k's solve in flight:

        1. drain wave k+1 (the linger rides the solve);
        2. collect wave k's decisions;
        3. start wave k's commit on the commit thread;
        4. speculatively encode wave k+1 against the predicted post-commit
           planes and dispatch its solve — both riding wave k's commit;
        5. when the commit lands, verify the prediction: a hit keeps the
           in-flight wave k+1 solve, a divergence discards it (its future
           is never read), rolls the predicted rows back, and re-encodes
           before re-dispatching.

        Committed decisions equal the causal loop's: speculation changes
        when work runs, never what state it sees."""
        c = self.config
        if inflight is None:
            # bootstrap / restart: nothing in flight, encode causally. An
            # empty queue is a normal idle tick, told apart HERE and not
            # by exception type in the loop: socket.timeout IS
            # TimeoutError, and a network timeout escaping a cycle must
            # never pass for an empty drain
            try:
                t_dr0 = time.monotonic_ns()
                pods = self._drain_wave(timeout=0.2)
            except TimeoutError:
                return None
            tctx = tracing.new_ctx()
            tracing.record("wave.drain", t_dr0, time.monotonic_ns(),
                           parent=tctx, pods=len(pods))
            return self._dispatch_causal(pods, solve_pool, pm, tctx=tctx)
        pending = inflight.pending
        # overlap 1: drain wave k+1 while wave k solves
        t0 = time.perf_counter()
        t_dr0 = time.monotonic_ns()
        next_pods: List[api.Pod] = []
        try:
            next_pods = self._drain_wave(timeout=self.wave_linger_s)
        except TimeoutError:
            pass
        drain_s = time.perf_counter() - t0
        # wave k+1's trace opens at its drain; every later leg (spec
        # encode, solve, commit — or the causal re-encode on divergence)
        # attaches to this context
        next_tctx = tracing.new_ctx() if next_pods else None
        if next_pods:
            tracing.record("wave.drain", t_dr0, time.monotonic_ns(),
                           parent=next_tctx, pods=len(next_pods))
        try:
            decisions = inflight.fut.result()
        except Exception as e:
            self._fail_wave(pending, e)
            if isinstance(e, NotImplementedError):
                self._fail_wave(next_pods, e)
                raise
            return self._dispatch_causal(next_pods, solve_pool, pm,
                                         tctx=next_tctx)
        solve_s = time.perf_counter() - t0
        pm.overlap.inc(by=min(drain_s, solve_s))
        placed = self._split_decisions(pending, decisions)
        if not placed:
            return self._dispatch_causal(next_pods, solve_pool, pm,
                                         tctx=next_tctx)
        # the predicted post-bind clones: shared verbatim between the
        # speculative encode and assume_pod, so a verified hit leaves the
        # encoder accounting the very objects the modeler holds
        predicted = [_assumed_clone(pod, host) for pod, host, _v in placed]
        # wave k's bindings commit on the commit thread; the speculative
        # encode (overlap 2) and wave k+1's solve (overlap 3) ride it
        t_c0 = time.perf_counter()
        commit_fut = commit_pool.submit(self._commit_wave, placed, predicted,
                                        inflight.tctx, decisions.t0)
        # a wave that evicts changes the cluster beyond its own binds
        # (victim deletions land in the changelog), so the predicted
        # post-commit state would always verify as divergent
        wave_evicts = any(vict for _pod, _host, vict in placed)
        spec = None
        next_fut = None
        if next_pods and self._delta_token is not None and \
                not wave_evicts and \
                not any(gang.gang_key(p) is not None for p in next_pods):
            spec = self._speculate(next_pods, predicted, tctx=next_tctx)
            if spec.snap is not None:
                next_fut = solve_pool.submit(self._solve_snap, spec.snap,
                                             len(spec.pending), next_tctx)
        elif next_pods:
            pm.unspeculated.inc()
        try:
            outcomes, _bound = commit_fut.result()
        except Exception as e:
            # infra fault mid-commit: roll the speculation back and force
            # a full resync — the encoder must not keep unverified rows.
            # The drained next wave would otherwise be stranded (popped
            # from the FIFO, never solved): hand it to the error handler,
            # which re-fetches and requeues still-unbound pods.
            if spec is not None and spec.applied:
                self._encoder.forget_pods(
                    [cl.metadata.uid for cl in predicted])
            self._delta_token = None
            self._fail_wave(next_pods, e)
            raise
        commit_s = time.perf_counter() - t_c0
        if spec is None:
            return self._dispatch_causal(next_pods, solve_pool, pm,
                                         tctx=next_tctx)
        pm.overlap.inc(by=min(commit_s, spec.encode_s))
        reason, token, failed_uids = self._verify_speculation(
            spec, predicted, outcomes)
        if not reason:
            # prediction held: wave k+1 is already solving on the exact
            # state the causal path would have encoded — a clean,
            # token-paired state, so it is also a checkpoint site
            self._delta_token = token
            self._maybe_checkpoint(token)
            pm.hits.inc()
            pm.waves.inc()
            return _Inflight(next_fut, spec.pending, next_tctx)
        # divergence: the in-flight speculative solve (if any) is
        # discarded — its results never commit
        if reason == "bind_failed" and spec.applied:
            # only this wave's own CAS losers (and/or an overflow)
            # diverged: roll back the losing rows and rebuild over the
            # corrected planes
            self._encoder.forget_pods(failed_uids)
            self._delta_token = token
            pm.invalidations.inc("bind_failed" if failed_uids
                                 else spec.reason or "encoder_fallback")
            pending2 = spec.pending if spec.pending is not None \
                else gang.order_wave(next_pods)
            try:
                nodes = c.minion_lister.list().items
                services = self.factory.service_store.list()
                snap2 = self._encoder.encode_delta(nodes, [], [], pending2,
                                                   services)
            except Exception:
                snap2 = None
            if snap2 is not None:
                pm.waves.inc()
                return _Inflight(solve_pool.submit(self._solve_snap, snap2,
                                                   len(pending2), next_tctx),
                                 pending2, next_tctx)
            return self._dispatch_causal(next_pods, solve_pool, pm,
                                         tctx=next_tctx)
        # foreign interference: exact rollback of every speculative row;
        # the un-advanced token re-delivers the actual events (this
        # wave's real binds included) to the causal encode below
        if spec.applied:
            self._encoder.forget_pods([cl.metadata.uid for cl in predicted])
        pm.invalidations.inc(reason or spec.reason or "speculation_failed")
        return self._dispatch_causal(next_pods, solve_pool, pm,
                                     tctx=next_tctx)

    # -- boot prewarm ---------------------------------------------------------
    def _prewarm_boot(self) -> None:
        """Wait for the node store to fill, build and load commit_solve,
        and solve one exemplar wave (the reference's ``_prewarm_boot``
        pads empty pods to the pod-axis floor) over the live nodes,
        services and bound pods on ``self.device``; then set
        compile_prewarm_ready. A failure stops the loop with ``fault``
        set: the kernel must not compile inside the load window instead."""
        t0 = time.perf_counter()
        nodes: list = []
        while not self._stop.is_set():
            nodes = self.config.minion_lister.list().items
            if nodes:
                break
            self._stop.wait(0.05)
        if not nodes:
            return
        try:
            if self.device.type == "cuda":
                from kubernetes_tpu_torch.ops import build
                build.build("commit_solve")
                commit_solver._lib()
            pending = [api.Pod(metadata=api.ObjectMeta(
                name=f"prewarm-{i}", namespace=api.NamespaceDefault))
                for i in range(min(64, self.wave_size))]
            snap = encode_snapshot(nodes, self.config.modeler.list(),
                                   pending, self.factory.service_store.list(),
                                   policy=self.batch_policy)
            solve(snap, device=self.device, mesh=self._mesh)
        except Exception as e:
            _log.exception("boot prewarm failed; stopping the wave loop")
            self.fault = e
            self._stop.set()
            return
        self.prewarm_s = time.perf_counter() - t0
        self._sx.prewarm_s.observe(self.prewarm_s)
        self._sx.prewarm_ready.set(1)

    # -- the loop -----------------------------------------------------------
    def run(self) -> "BatchScheduler":
        if self.config.prewarm and self.solver is not None:
            # the daemon builds and prewarms the launches; this worker
            # has nothing of its own to warm
            self._sx.prewarm_ready.set(1)
        elif self.config.prewarm:
            self._sx.prewarm_ready.set(0)
            threading.Thread(target=self._prewarm_boot, daemon=True,
                             name="tpu-batch-prewarm-boot").start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
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

    def _loop(self) -> None:
        if self.pipeline:
            # speculation needs the incremental encoder's delta planes
            if self._encoder is not None:
                return self._loop_pipelined()
            _log.warning("pipeline mode unavailable (policy needs the "
                         "order-dependent full encoder); falling back to "
                         "the causal wave loop")
        self._loop_causal()

    def _loop_errors(self):
        return metrics.default_registry().counter(
            "scheduler_wave_loop_errors_total",
            "exceptions escaping the tpu-batch wave loop")

    def _stop_on(self, err: NotImplementedError) -> None:
        """A wave the port cannot solve stops the loop with ``fault`` set
        instead of requeueing it forever."""
        _log.error("wave loop stopped: %s", err)
        self.fault = err
        self._stop.set()

    def _loop_causal(self) -> None:
        # per-pod and per-wave failures are evented + requeued inside
        # schedule_wave; an exception escaping to here is an
        # infrastructure fault that must not spin silently
        errs = self._loop_errors()
        while not self._stop.is_set():
            try:
                self.schedule_wave(timeout=0.2)
            except TimeoutError:
                continue
            except NotImplementedError as e:
                errs.inc()
                self._stop_on(e)
            except Exception:
                errs.inc()
                _log.exception("wave loop error (backing off 10ms)")
                time.sleep(0.01)

    def _loop_pipelined(self) -> None:
        import concurrent.futures as cf

        errs = self._loop_errors()
        pm = _pipeline_metrics()
        # the pool names are the Explainer's hot-thread guard
        solve_pool = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tpu-batch-solve")
        commit_pool = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tpu-batch-commit")
        inflight: Optional[_Inflight] = None
        try:
            while not self._stop.is_set():
                prev = inflight
                try:
                    inflight = self._pipelined_cycle(inflight, solve_pool,
                                                     commit_pool, pm)
                except NotImplementedError as e:
                    errs.inc()
                    self._stop_on(e)
                except Exception as e:
                    # TimeoutError included: the empty-queue drain timeout
                    # is handled INSIDE the cycle, so one here is a real
                    # fault and resets state like every other error —
                    # continuing with the consumed in-flight wave would
                    # commit it twice
                    errs.inc()
                    _log.exception(
                        "pipelined wave loop error (backing off 10ms)")
                    # heal: drop the speculation cursor (the next encode
                    # resyncs, clearing any unverified rows) and hand the
                    # in-flight wave's pods to the error handler — an
                    # already-bound pod re-fetches as scheduled and is not
                    # requeued, so this never double-schedules
                    self._delta_token = None
                    inflight = None
                    if prev is not None:
                        for pod in prev.pending:
                            try:
                                self.config.error(pod, e)
                            except Exception:
                                pass
                    time.sleep(0.01)
        finally:
            solve_pool.shutdown(wait=False)
            commit_pool.shutdown(wait=False)

    def _record(self, pod, reason, fmt, *args):
        if self.config.recorder is not None:
            self.config.recorder.eventf(pod, reason, fmt, *args)
