"""Prometheus-style counters, gauges and histograms.

Port of the registry of ``kubernetes_tpu/util/metrics.py`` (the
reference's Prometheus instrumentation seam, ref: pkg/apiserver/
apiserver.go:40-87, pkg/kubelet/metrics/metrics.go:31-84) trimmed to what
the scheduler binary writes: ``Counter``, ``Gauge``, ``Histogram``, the
``Registry`` and its Prometheus text exposition (``render_text``, the
binary's ``/metrics``), the encoder-resync counters and checkpoint
histogram of the journal-replay path, the prewarm's readiness gauge,
seconds and bucket counts and the solver daemon's mirrors of its
schedulers' resync counters (``SlipstreamMetrics``), the solver daemon's
delta-wire family (``SolverdDeltaMetrics``), the two pod-latency histograms
the commit and the bound-pod observer write (``PodLatencyMetrics``), the
preemption family of the commit (``PreemptionMetrics``), the async
event recorder's posted/dropped counters (``EventRecorderMetrics``), the
unschedulability-diagnosis family (``ExplainMetrics``), the apiserver's
request-latency buckets (``APISERVER_BUCKETS``; its request, watch
fan-out and batch-bind families live on each server's own registry, the
watch package's loss counters on the default one), kube-fairshed's
admission family (``FairshedMetrics``) and its cross-worker ledger
(``FairshedLedgerMetrics``), the durable store's WAL and recovery family
(``StoreWalMetrics``), the striped store's shard family
(``StoreShardMetrics``), the chaos supervisor's restart family
(``ChaosMetrics``), and the flight recorder: every series of the registry sampled into a bounded ring per
series, with a ``<name>:rate`` series per counter, served incrementally
at the binary's ``/debug/vars?since=<ns>`` (``FlightRecorder``,
``flightrec_arm`` ...).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "default_registry",
           "DEFAULT_BUCKETS", "POD_E2E_BUCKETS", "SlipstreamMetrics",
           "slipstream_metrics", "SolverdDeltaMetrics",
           "solverd_delta_metrics", "PodLatencyMetrics", "pod_latency_metrics",
           "PreemptionMetrics", "preemption_metrics",
           "EventRecorderMetrics", "event_recorder_metrics",
           "ExplainMetrics", "explain_metrics",
           "APISERVER_BUCKETS", "ChaosMetrics", "chaos_metrics",
           "FairshedMetrics", "fairshed_metrics",
           "FairshedLedgerMetrics", "fairshed_ledger_metrics",
           "StoreWalMetrics", "store_wal_metrics",
           "StoreShardMetrics", "store_shard_metrics",
           "SolverdMeshMetrics", "solverd_mesh_metrics",
           "SolverdSubmeshMetrics", "solverd_submesh_metrics",
           "DefragMetrics", "defrag_metrics",
           "FlightRecorder", "flightrec_arm", "flightrec_disarm",
           "flightrec_armed", "flightrec_watch", "flightrec_vars",
           "flightrec_sample_now", "flightrec"]

APISERVER_BUCKETS = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0)
# pod-lifecycle latency envelope: one wave in steady state, tens of
# seconds behind a burst
POD_E2E_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0)


def _escape(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(label_names: Sequence[str], label_values: Tuple[str, ...],
                extra: str = "") -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(label_names, label_values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    typ = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def total(self) -> float:
        """Sum across every label set (0.0 when nothing incremented)."""
        with self._lock:
            return sum(self._values.values())

    def by_label(self) -> Dict[Tuple[str, ...], float]:
        """Snapshot copy of {label values: count}."""
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.typ}"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(self.label_names, key)} "
                       f"{_num(v)}")
        return out

    def samples(self) -> List[Tuple[str, str, float]]:
        """Scalar time-series points for the flight recorder: one
        ``(series name incl. labels, type, value)`` per label set."""
        with self._lock:
            items = list(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        return [(self.name + _fmt_labels(self.label_names, key), self.typ, v)
                for key, v in items]


class Gauge(Counter):
    typ = "gauge"

    def set(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = float(value)

    def dec(self, *label_values: str, by: float = 1.0) -> None:
        self.inc(*label_values, by=-by)


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        # per label-set: (bucket counts, total count, sum)
        self._series: Dict[Tuple[str, ...], Tuple[List[int], int, float]] = {}

    def observe(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            counts, n, total = self._series.get(
                key, ([0] * len(self.buckets), 0, 0.0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._series[key] = (counts, n + 1, total + value)

    def sum(self, *label_values: str) -> float:
        with self._lock:
            s = self._series.get(tuple(str(v) for v in label_values))
        return s[2] if s else 0.0

    def count(self, *label_values: str) -> int:
        with self._lock:
            s = self._series.get(tuple(str(v) for v in label_values))
        return s[1] if s else 0

    def quantile(self, q: float, *label_values: str) -> Optional[float]:
        """Interpolation-free bucket quantile: the UPPER BOUND of the
        first bucket whose cumulative count reaches ``rank = q * n``.

        Semantics (the contract latency records in CHURN_MP_* rely on):

        - returns None when the series has no observations (an empty
          histogram has no quantiles, not 0.0);
        - always one of the configured bucket bounds — a conservative
          over-estimate of the true quantile, never an interpolated
          value between bounds (a single-bucket histogram therefore
          reports that bucket's bound for every in-range quantile);
        - returns +inf when the rank falls beyond the largest bounded
          bucket (observations overflowed the envelope — widen the
          buckets rather than trusting the number);
        - ``q`` is clamped to a minimum rank of one observation, so
          q=0 (or pathological tiny q) reports the first non-empty
          bucket instead of buckets[0] unconditionally.
        """
        s = self._series.get(tuple(str(v) for v in label_values))
        if not s or s[1] == 0:
            return None
        counts, n, _ = s
        rank = max(1.0, q * n)
        for i, b in enumerate(self.buckets):
            if counts[i] >= rank:
                return b
        return float("inf")

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.typ}"]
        with self._lock:
            items = sorted((k, (list(c), n, t))
                           for k, (c, n, t) in self._series.items())
        for key, (counts, n, total) in items:
            for b, c in zip(self.buckets, counts):
                le = 'le="' + _num(b) + '"'
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(self.label_names, key, le)} {c}")
            le_inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(self.label_names, key, le_inf)} {n}")
            out.append(f"{self.name}_sum"
                       f"{_fmt_labels(self.label_names, key)} {_num(total)}")
            out.append(f"{self.name}_count"
                       f"{_fmt_labels(self.label_names, key)} {n}")
        return out

    def samples(self) -> List[Tuple[str, str, float]]:
        """Flight-recorder series: cumulative bucket counts (type
        ``bucket``, no rate series derived for them) including the
        ``+Inf`` bucket, plus ``_sum``/``_count`` as counters."""
        with self._lock:
            items = [(k, (list(c), n, t))
                     for k, (c, n, t) in self._series.items()]
        out: List[Tuple[str, str, float]] = []
        for key, (counts, n, total) in items:
            for b, c in zip(self.buckets, counts):
                le = 'le="' + _num(b) + '"'
                out.append((f"{self.name}_bucket"
                            f"{_fmt_labels(self.label_names, key, le)}",
                            "bucket", float(c)))
            le_inf = 'le="+Inf"'
            out.append((f"{self.name}_bucket"
                        f"{_fmt_labels(self.label_names, key, le_inf)}",
                        "bucket", float(n)))
            out.append((f"{self.name}_sum"
                        f"{_fmt_labels(self.label_names, key)}",
                        "counter", float(total)))
            out.append((f"{self.name}_count"
                        f"{_fmt_labels(self.label_names, key)}",
                        "counter", float(n)))
        return out


class Registry:
    """Named metric registry (get-or-create by name); render_text() is the
    /metrics payload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def counter(self, name, help_="", label_names=()) -> Counter:
        return self._get_or_make(name, Counter, help_, label_names)

    def gauge(self, name, help_="", label_names=()) -> Gauge:
        return self._get_or_make(name, Gauge, help_, label_names)

    def histogram(self, name, help_="", label_names=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, Histogram, help_, label_names,
                                 buckets=buckets)

    def _get_or_make(self, name, cls, help_, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, label_names, **kw)
                self._metrics[name] = m
            if type(m) is not cls or m.label_names != tuple(label_names):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}{m.label_names}, requested "
                    f"{cls.__name__}{tuple(label_names)}")
            return m

    def render_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def sample(self) -> List[Tuple[str, str, float]]:
        """Every series in the registry as (name-with-labels, type,
        value) — one flight-recorder snapshot tick's raw material."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: List[Tuple[str, str, float]] = []
        for m in metrics:
            out.extend(m.samples())
        return out


_default = Registry()


def default_registry() -> Registry:
    return _default


class SolverdDeltaMetrics:
    """The ``solverd_delta_*`` family: delta-wire effectiveness of the
    solver daemon's resident plane cache (solver/service.py), exported
    from the daemon's /metrics beside its queue and coalescing series."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.hits = reg.counter(
            "solverd_delta_hits_total",
            "Solve frames whose resident planes arrived as row deltas "
            "and were applied to the daemon's cache")
        self.full_frames = reg.counter(
            "solverd_delta_full_frames_total",
            "Full-plane solve frames (cache establish/refresh, v1 "
            "clients, or post-resync re-sends)")
        self.resyncs = reg.counter(
            "solverd_delta_resyncs_total",
            "Delta frames refused pending a full resync, by reason",
            ("reason",))
        self.bytes_shipped = reg.counter(
            "solverd_delta_bytes_shipped_total",
            "Array bytes received on the wire for solve frames")
        self.bytes_saved = reg.counter(
            "solverd_delta_bytes_saved_total",
            "Array bytes NOT shipped because resident planes were "
            "reused (full reconstruction size minus wire size)")
        self.cache_entries = reg.gauge(
            "solverd_delta_cache_entries",
            "Live (worker, shape-bucket) resident plane cache entries")


def solverd_delta_metrics() -> SolverdDeltaMetrics:
    if SolverdDeltaMetrics._singleton is None:
        SolverdDeltaMetrics._singleton = SolverdDeltaMetrics()
    return SolverdDeltaMetrics._singleton


class SlipstreamMetrics:
    """The encoder-resync family of the journal-replay path
    (models/incremental.py checkpoint, scheduler/tpu_batch.py replay):
    replayed resyncs, full re-encodes by reason, checkpoint time; and the
    boot prewarm's seconds and readiness gauge."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.resync_replay = reg.counter(
            "encoder_resync_replay_total",
            "Encoder resyncs served by restoring the last checkpoint and "
            "replaying the modeler changelog (O(missed events))")
        self.resync_full = reg.counter(
            "encoder_resync_full_total",
            "Encoder resyncs that fell back to a full O(cluster) "
            "re-encode, by reason",
            ("reason",))
        self.checkpoint_s = reg.histogram(
            "encoder_checkpoint_seconds",
            "Wall time of IncrementalEncoder.checkpoint() (copy-on-write "
            "plane snapshot)",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25))
        self.prewarm_s = reg.histogram(
            "compile_prewarm_seconds",
            "Wall time of the boot prewarm: building and loading the "
            "solve kernel and one exemplar wave over the live cluster",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0))
        self.prewarm_ready = reg.gauge(
            "compile_prewarm_ready",
            "Boot prewarm done: the solve kernel built and one exemplar "
            "wave solved (1), or not yet (0); load windows gate on this")
        # solver/prewarm.py: buckets the daemon's prewarm thread launched
        # ahead of the live waves, and those still queued
        self.prewarm_total = reg.counter(
            "compile_prewarm_total",
            "Shape buckets launched off the wave loop by the prewarm "
            "thread (kernel built, one exemplar wave solved)")
        self.prewarm_pending = reg.gauge(
            "compile_prewarm_pending",
            "Prewarm targets queued but not yet launched")
        # solverd-side mirrors of the schedulers' resync counters,
        # piggybacked on solve headers ("enc") and summed per scheduler:
        # last-reported gauges, not daemon-local counters
        self.replay_reported = reg.gauge(
            "solverd_encoder_resync_replay_reported",
            "Sum of encoder_resync_replay_total last reported by each "
            "connected scheduler in its solve headers")
        self.full_reported = reg.gauge(
            "solverd_encoder_resync_full_reported",
            "Sum of encoder_resync_full_total last reported by each "
            "connected scheduler in its solve headers")


def slipstream_metrics() -> SlipstreamMetrics:
    if SlipstreamMetrics._singleton is None:
        SlipstreamMetrics._singleton = SlipstreamMetrics()
    return SlipstreamMetrics._singleton


class PodLatencyMetrics:
    """Pod-lifecycle latency observed by the wave scheduler: create ->
    bind committed, and bind committed -> the bound pod seen back through
    the scheduler's own watch stream."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.e2e = reg.histogram(
            "pod_e2e_scheduling_seconds",
            "Pod end-to-end scheduling latency: apiserver create "
            "(metadata.creationTimestamp) -> bind committed by the wave "
            "scheduler", buckets=POD_E2E_BUCKETS)
        self.watch_observe = reg.histogram(
            "pod_watch_observe_seconds",
            "Bind committed -> the bound pod observed back through the "
            "scheduler's own watch stream (the fan-out leg of the "
            "pod's path)", buckets=POD_E2E_BUCKETS)


def pod_latency_metrics() -> PodLatencyMetrics:
    if PodLatencyMetrics._singleton is None:
        PodLatencyMetrics._singleton = PodLatencyMetrics()
    return PodLatencyMetrics._singleton


class PreemptionMetrics:
    """The preemption family of the wave scheduler's commit
    (scheduler/tpu_batch.py). ``higher_evictions`` counts an invariant: a
    victim is always below its preemptor's priority, so any value above 0
    is a fault."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.attempts = reg.counter(
            "scheduler_preemption_attempts_total",
            "Pods the wave solver placed by preemption whose evict+bind "
            "committed")
        self.victims = reg.counter(
            "scheduler_preemption_victims_total",
            "Lower-priority pods evicted by committed preemptions")
        self.conflicts = reg.counter(
            "scheduler_preemption_conflicts_total",
            "Evict+bind items that lost their compare-and-swap (a 409; the "
            "pod requeues and the next wave sees the new state)")
        self.higher_evictions = reg.counter(
            "scheduler_preemption_higher_evictions_total",
            "Victims at equal or higher priority than their preemptor "
            "(must stay 0)")
        self.bind_seconds = reg.histogram(
            "scheduler_preemption_bind_seconds",
            "Preempt-to-bind latency: the wave's solve start -> the "
            "preempting pod's evict+bind committed",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))


def preemption_metrics() -> PreemptionMetrics:
    if PreemptionMetrics._singleton is None:
        PreemptionMetrics._singleton = PreemptionMetrics()
    return PreemptionMetrics._singleton


class SolverdMeshMetrics:
    """The ``solverd_mesh_*`` family — the device-mesh production solve
    (solver/mesh_exec.py): mesh topology, per-wave host->device transfer
    traffic split into delta-applies vs full re-establishes (resharding),
    the device-resident plane footprint (shard_memory_report), and the
    single-device parity probe that keeps the mesh path bit-identity
    evidence live in every run. Scraped into the CHURN_MP record's
    ``solverd.mesh`` section alongside the solve quantiles (the contract
    tests/test_bench_record.py enforces from r09 on). The
    ``parity_divergence_zero`` SLO rule binds to its divergence counter."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.devices = reg.gauge(
            "solverd_mesh_devices",
            "Devices in the solver mesh (0 = mesh dispatch disabled)")
        self.pods_axis = reg.gauge(
            "solverd_mesh_pods_axis", "Mesh 'pods' axis length")
        self.node_shards = reg.gauge(
            "solverd_mesh_node_shards",
            "Node-axis shards of the ACTIVE solve layout (1 = the "
            "measured dispatch chose the single-device submesh)")
        self.waves = reg.counter(
            "solverd_mesh_waves_total",
            "Waves solved through the mesh executor's device-resident "
            "path (vs the coalesced single-device path)")
        self.transfer_bytes = reg.counter(
            "solverd_mesh_transfer_bytes_total",
            "Host->device bytes moved per wave (delta-row scatters + "
            "per-wave pod planes)")
        self.reshard_bytes = reg.counter(
            "solverd_mesh_reshard_bytes_total",
            "Host->device bytes re-established for planes that SHOULD "
            "have been resident (cold buckets, evictions, out-of-order "
            "bases) — the number back-to-back waves must keep near zero")
        self.resident_bytes = reg.gauge(
            "solverd_mesh_resident_bytes",
            "Device-resident solver plane bytes across all cache entries")
        self.shard_bytes_per_device = reg.gauge(
            "solverd_mesh_shard_bytes_per_device",
            "shard_memory_report total for the newest resident bucket "
            "(planes + loop carry + static mask, per device)")
        self.solve_s = reg.histogram(
            "solverd_mesh_solve_seconds",
            "Mesh-executor solve wall time per wave",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0,
                     5.0, 10.0))
        self.single_probe_s = reg.histogram(
            "solverd_mesh_single_device_seconds",
            "Single-device probe solves of mesh-path waves (the in-run "
            "vs-single-device comparison the churn record carries)",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0,
                     5.0, 10.0))
        self.parity_checks = reg.counter(
            "solverd_mesh_parity_checks_total",
            "Mesh-path waves re-solved on one device and compared bitwise")
        self.parity_divergent = reg.counter(
            "solverd_mesh_parity_divergent_total",
            "Parity probes whose decisions diverged (must stay 0)")


def solverd_mesh_metrics() -> SolverdMeshMetrics:
    if SolverdMeshMetrics._singleton is None:
        SolverdMeshMetrics._singleton = SolverdMeshMetrics()
    return SolverdMeshMetrics._singleton


class SolverdSubmeshMetrics:
    """The ``solverd_submesh_*`` family — active sub-meshing
    (models/submesh.py): per-wave compaction of the node axis to the
    nodes that can possibly place the wave, before the plain loop. The
    kept/total counters disclose how much of the node axis each wave
    really touched; the parity counters keep the submesh-vs-full
    bit-identity evidence live in every run (divergence must stay 0 — the
    compaction is decision-preserving by construction, and the probe
    checks it)."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.waves = reg.counter(
            "solverd_submesh_waves_total",
            "Waves solved on a compacted node axis (vs full-plane)")
        self.full_waves = reg.counter(
            "solverd_submesh_full_waves_total",
            "Waves where compaction was skipped (kept fraction past the "
            "engage threshold, zero-req pods, or KTPU_SUBMESH=off)")
        self.nodes_kept = reg.counter(
            "solverd_submesh_nodes_kept_total",
            "Nodes surviving the keep mask, summed over submesh waves")
        self.nodes_total = reg.counter(
            "solverd_submesh_nodes_total",
            "Candidate nodes before compaction, summed over submesh waves")
        self.parity_checks = reg.counter(
            "solverd_submesh_parity_checks_total",
            "Submesh waves re-solved on the full plane and compared "
            "decision-for-decision")
        self.parity_divergent = reg.counter(
            "solverd_submesh_parity_divergent_total",
            "Submesh parity probes whose decisions diverged (must stay 0)")
        self.compact_s = reg.histogram(
            "solverd_submesh_compact_seconds",
            "Host-side keep-mask + plane-gather time per submesh wave",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5))


def solverd_submesh_metrics() -> SolverdSubmeshMetrics:
    if SolverdSubmeshMetrics._singleton is None:
        SolverdSubmeshMetrics._singleton = SolverdSubmeshMetrics()
    return SolverdSubmeshMetrics._singleton


class DefragMetrics:
    """kube-defrag instrumentation (descheduler/controller.py wave loop).
    Registered HERE so the metrics-sync vet rule binds the churn
    harness's ``fragmentation`` record section and the defrag SLO rules
    to the registry universe.

    ``fragmentation_score`` is the wave-level bin-packing score over the
    resident planes (lower = better packed; an empty node contributes 0,
    so emptying nodes IS the objective). Under an active descheduler it
    must never trend up — the ``fragmentation_score_monotone_under_defrag``
    SLO rule rides directly on this gauge. In the port the wave itself
    is ``models/defrag.py``; the loop that writes this family is
    ``descheduler/controller.py``."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.fragmentation_score = reg.gauge(
            "defrag_fragmentation_score",
            "Cluster fragmentation score at the last defrag wave "
            "(sum over non-empty nodes of free-permille across core "
            "dims; lower is better packed)")
        self.waves = reg.counter(
            "defrag_waves_total",
            "Defrag waves solved (a wave that proposes zero moves still "
            "counts — it observed the cluster and declined to act)")
        self.migrations = reg.counter(
            "defrag_migrations_total",
            "Pod migrations committed by defrag waves (atomic "
            "evict-here + bind-there items that applied)")
        self.conflicts = reg.counter(
            "defrag_conflicts_total",
            "Migration items that failed their commit guard (per-item "
            "409/404: the pod moved, changed uid, or vanished between "
            "proposal and commit; the next wave re-solves from truth)")
        self.declined = reg.counter(
            "defrag_declined_total",
            "Waves declined before solving, by reason (rate_limited / "
            "pending_work / error)", ("reason",))
        self.nodes_drained = reg.counter(
            "defrag_nodes_drained_total",
            "Cordoned nodes a wave fully emptied (every resident pod "
            "migrated off; the cordon-drain contract)")
        self.nodes_emptied = reg.counter(
            "defrag_nodes_emptied_total",
            "Non-cordoned nodes a wave voluntarily emptied (whole-node "
            "consolidations that committed)")
        self.wave_seconds = reg.counter(
            "defrag_wave_seconds_total",
            "CPU seconds spent solving defrag waves (thread_time on "
            "the wave-loop thread; strictly off the scheduler hot path)")
        self.score_regressions = reg.counter(
            "defrag_score_regressions_total",
            "Waves whose accepted move set scored WORSE than the "
            "mandatory-only outcome — MUST stay 0 (the acceptance gate "
            "drops any voluntary set that does not strictly improve the "
            "score; monotone-under-defrag is structural)")


def defrag_metrics() -> DefragMetrics:
    if DefragMetrics._singleton is None:
        DefragMetrics._singleton = DefragMetrics()
    return DefragMetrics._singleton


class EventRecorderMetrics:
    """client/record.AsyncEventRecorder visibility: events posted, and
    events shed by reason (rate_limited token-bucket rejections,
    shed_low_priority, queue_full drop-oldest shedding, post_failed
    apiserver write failures)."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.posted = reg.counter(
            "event_recorder_posted_total",
            "Events successfully written to the apiserver by the async "
            "recorder worker")
        self.dropped = reg.counter(
            "event_recorder_dropped_total",
            "Events shed by the async recorder, by reason "
            "(rate_limited / shed_low_priority / queue_full / post_failed)",
            ("reason",))


def event_recorder_metrics() -> EventRecorderMetrics:
    if EventRecorderMetrics._singleton is None:
        EventRecorderMetrics._singleton = EventRecorderMetrics()
    return EventRecorderMetrics._singleton


class ExplainMetrics:
    """Unschedulability diagnosis (models/explain.py, read by the wave
    scheduler's FailedScheduling path). The
    ``scheduler_unschedulable_total{reason=...}`` buckets (one per pod,
    its DOMINANT node-elimination reason; ``unexplained`` when diagnosis
    was skipped) always sum to ``scheduler_unschedulable_pods_total``."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.pods = reg.counter(
            "scheduler_unschedulable_pods_total",
            "Pods a solved wave returned unschedulable (each requeue "
            "that fails again counts again — this is the pending "
            "pressure signal, not a distinct-pod count)")
        self.reasons = reg.counter(
            "scheduler_unschedulable_total",
            "Unschedulable pods by dominant node-elimination reason "
            "('unexplained' = diagnosis skipped)", ("reason",))
        self.invocations = reg.counter(
            "scheduler_explain_invocations_total",
            "Waves diagnosed (rate-limited; a wave where every pod binds "
            "never invokes it)")
        self.seconds = reg.counter(
            "scheduler_explain_seconds_total",
            "CPU seconds spent in diagnosis (thread_time on the wave "
            "loop thread)")
        self.skipped = reg.counter(
            "scheduler_explain_skipped_total",
            "Waves with unschedulable pods whose diagnosis was declined, "
            "by reason (rate_limited / unsupported / hot_path / error)",
            ("reason",))


def explain_metrics() -> ExplainMetrics:
    if ExplainMetrics._singleton is None:
        ExplainMetrics._singleton = ExplainMetrics()
    return ExplainMetrics._singleton


class ChaosMetrics:
    """kube-chaos supervisor instrumentation: component kills/respawns
    and time-to-recovery, incremented by the churn harness's supervisor
    (hack/churn_mp.py) in its own process and pulled into the flightrec
    timeline through the harness's /debug/vars target — so the
    ``component_restart`` and ``recovery_time_ceiling`` SLO rules fire
    and resolve LIVE during the run, not in post-mortem."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.restarts = reg.counter(
            "component_restarts_total",
            "Control-plane child processes respawned by the chaos "
            "supervisor (scheduled kills and organic deaths alike; a "
            "clean run carries 0)")
        self.recovery_s = reg.histogram(
            "component_recovery_seconds",
            "Kill (or death detection) -> respawned child answering "
            "its readiness probe",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 45.0, 60.0))


def chaos_metrics() -> ChaosMetrics:
    if ChaosMetrics._singleton is None:
        ChaosMetrics._singleton = ChaosMetrics()
    return ChaosMetrics._singleton


class FairshedMetrics:
    """kube-fairshed instrumentation (apiserver/fairshed.py): per-flow
    admission, shedding, queue wait, and the workload backlog governor.
    Registered HERE so the metrics-sync vet rule binds the churn
    harness's ``fairshed`` record scrape and the
    ``system_flow_shed_zero`` SLO rule to the registry universe.

    ``fairshed_system_shed_total`` is an invariant counter: system-flow
    requests are structurally isolated from lower bands, so any
    non-zero value is an isolation bug — the overload record contract
    requires it to read 0."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.admitted = reg.counter(
            "request_admitted_total",
            "Requests admitted through fairshed, by flow", ("flow",))
        self.shed = reg.counter(
            "request_shed_total",
            "Requests answered 429 by fairshed, by flow and reason "
            "(queue_full / timeout / backlog)", ("flow", "reason"))
        self.queue_wait = reg.histogram(
            "request_queue_wait_seconds",
            "Admission queue wait per admitted request (0 = an "
            "inflight slot was free)", ("flow",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0))
        self.retry_after = reg.histogram(
            "request_retry_after_seconds",
            "Retry-After hints handed to shed requests (drain-rate "
            "derived, clamped 1-30 s)", ("flow",),
            buckets=(1.0, 2.0, 5.0, 10.0, 30.0))
        self.inflight = reg.gauge(
            "request_inflight",
            "Concurrent dispatches holding a fairshed slot", ("flow",))
        self.queued = reg.gauge(
            "request_queue_depth",
            "Waiters parked for an inflight slot", ("flow",))
        self.system_shed = reg.counter(
            "fairshed_system_shed_total",
            "System-flow requests shed — MUST stay 0 (structural "
            "isolation invariant; the system_flow_shed_zero SLO rule)")
        self.backlog = reg.gauge(
            "fairshed_backlog_depth",
            "Workload backlog governor: pods created minus pods bound "
            "as seen by this worker (sheds creates past the limit)")


def fairshed_metrics() -> FairshedMetrics:
    if FairshedMetrics._singleton is None:
        FairshedMetrics._singleton = FairshedMetrics()
    return FairshedMetrics._singleton


class StoreWalMetrics:
    """kube-chaos: the ``store_wal_*`` family — durability-path evidence
    from storage/durable.DurableStore, exported wherever the store
    lives (kube-store's --metrics-port, or the apiserver's /metrics
    merge when the store is in-process). Registered HERE so the churn
    harness's ``store`` record section and the metrics-sync vet rule
    bind to the registry universe.

    The group-commit invariant these numbers prove: ``records >= ops``
    would be the per-op seed behavior; after the fix one record carries
    a whole txn item, so an evict+bind wave moves ``ops`` up by the op
    count but ``records`` by the item count and ``group_commits`` (=
    physical write+flush passes) by ONE per batched verb call."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.records = reg.counter(
            "store_wal_records_total",
            "WAL records appended (one JSON line each; a txn record "
            "carries every op of one atomic item)")
        self.ops = reg.counter(
            "store_wal_ops_total",
            "Mutations persisted through the WAL (ops inside txn "
            "records included)")
        self.group_commits = reg.counter(
            "store_wal_group_commits_total",
            "Physical WAL write+flush passes (one per batched verb "
            "call — the N-fsyncs-per-wave fix's denominator)")
        self.fsyncs = reg.counter(
            "store_wal_fsyncs_total",
            "fsync(2) calls on the WAL (fsync=True stores only)")
        self.bytes_written = reg.counter(
            "store_wal_bytes_total", "Bytes appended to the WAL")
        self.compactions = reg.counter(
            "store_wal_compactions_total",
            "Snapshot+truncate compaction passes")
        self.wal_size = reg.gauge(
            "store_wal_size_bytes", "Live WAL file size after the last "
            "append or compaction")
        self.snapshot_size = reg.gauge(
            "store_snapshot_size_bytes",
            "snapshot.json size after the last compaction or recovery")
        self.recovery_s = reg.histogram(
            "store_recovery_seconds",
            "Wall time of one crash recovery (snapshot load + WAL "
            "replay)",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                     30.0, 60.0))
        self.replayed = reg.gauge(
            "store_recovery_replayed_records",
            "WAL records replayed by the most recent recovery")
        self.snapshot_age = reg.gauge(
            "store_recovery_snapshot_age_seconds",
            "Age of the snapshot loaded by the most recent recovery "
            "(0 when no snapshot existed)")
        self.torn_bytes = reg.counter(
            "store_wal_torn_bytes_total",
            "Bytes discarded as a torn/corrupt WAL tail across "
            "recoveries (a crash mid-append leaves at most one torn "
            "record; anything more is media corruption and is logged "
            "loudly)")


def store_wal_metrics() -> StoreWalMetrics:
    if StoreWalMetrics._singleton is None:
        StoreWalMetrics._singleton = StoreWalMetrics()
    return StoreWalMetrics._singleton


class StoreShardMetrics:
    """kube-stripe: the ``store_shard_*`` family — keyspace-sharding
    evidence from storage/stripestore.StripedStore, exported wherever
    the store lives. The numbers to read: a balanced ``shard`` label
    distribution on ``store_shard_ops_total`` means the namespace hash
    is spreading load; a skewed one means one tenant owns the cluster
    and the sharding buys nothing (which the record must disclose, not
    hide). Incremented OUTSIDE the shard/rev critical sections — the
    counter mutex must never appear inside a store lock's edge set."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.ops = reg.counter(
            "store_shard_ops_total",
            "Store mutations committed, by owning shard id ('cross' "
            "for multi-shard batched verbs)", ("shard",))
        self.shard_count = reg.gauge(
            "store_shards",
            "Configured shard count of the live striped store (absent/"
            "0 means the unsharded MemStore twin)")


def store_shard_metrics() -> StoreShardMetrics:
    if StoreShardMetrics._singleton is None:
        StoreShardMetrics._singleton = StoreShardMetrics()
    return StoreShardMetrics._singleton


class FairshedLedgerMetrics:
    """The ``fairshed_ledger_*`` family — the cross-worker drain feed
    (apiserver/share.SharedLedger): this worker's contributions to the
    shared created/bound/deleted counters plus the GLOBAL backlog the
    governor actually gates on. Only registered on servers wired with a
    share segment; single-worker servers keep the local
    ``fairshed_backlog_depth`` ledger alone."""

    _singleton = None

    def __init__(self, registry: Optional[Registry] = None):
        reg = registry or default_registry()
        self.creates = reg.counter(
            "fairshed_ledger_creates_total",
            "Pod creates this worker published into the shared ledger")
        self.binds = reg.counter(
            "fairshed_ledger_binds_total",
            "Pod binds this worker published into the shared ledger")
        self.deletes = reg.counter(
            "fairshed_ledger_deletes_total",
            "Pending-pod deletes this worker published into the shared "
            "ledger (bound-pod deletes are clamped out, as locally)")
        self.backlog = reg.gauge(
            "fairshed_ledger_backlog_depth",
            "GLOBAL workload backlog (sum of created minus bound minus "
            "pending-deleted across every worker's ledger block)")
        self.workers = reg.gauge(
            "fairshed_ledger_workers",
            "Worker blocks in the attached share segment")


def fairshed_ledger_metrics() -> FairshedLedgerMetrics:
    if FairshedLedgerMetrics._singleton is None:
        FairshedLedgerMetrics._singleton = FairshedLedgerMetrics()
    return FairshedLedgerMetrics._singleton


# -- the flight recorder: continuous in-process metric time-series ----------
#
# /metrics answers "what is the value NOW"; the flight recorder snapshots
# every Registry series into a per-process fixed-size ring of
# (monotonic_ns, value) samples at a configurable period (default 1 s),
# derives a ``<name>:rate`` series for every counter, and serves the rings
# incrementally at ``GET /debug/vars?since=<ns>``. Lazily armed (a process
# that never samples pays one module-global branch and allocates
# nothing); sampling is a pull from a dedicated thread, so no metric
# writer is ever blocked; eviction is bounded and counted.

_FLIGHTREC_CAPACITY = 512          # ring slots per series (~8.5 min at 1 s)
_FLIGHTREC_PERIOD_S = 1.0


class _SeriesRing:
    """Fixed-size (t_ns, value) ring for one series. The single sampler
    thread writes; readers walk newest->oldest under the recorder lock."""

    __slots__ = ("typ", "t", "v", "n", "cap")

    def __init__(self, typ: str, cap: int):
        self.typ = typ
        self.cap = cap
        self.t = [0] * cap
        self.v = [0.0] * cap
        self.n = 0              # samples ever written; n-cap evicted

    def put(self, t_ns: int, value: float) -> None:
        i = self.n % self.cap
        self.t[i] = t_ns
        self.v[i] = value
        self.n += 1

    def since(self, since_ns: int) -> List[List[float]]:
        """Samples with t > since_ns, oldest first. Walks backward from
        the newest slot, so an incremental pull is O(new samples)."""
        out: List[List[float]] = []
        live = min(self.n, self.cap)
        for k in range(live):
            i = (self.n - 1 - k) % self.cap
            if self.t[i] <= since_ns:
                break
            out.append([self.t[i], self.v[i]])
        out.reverse()
        return out

    @property
    def evicted(self) -> int:
        return max(0, self.n - self.cap)


class FlightRecorder:
    """Samples every watched Registry (plus per-process built-ins: RSS,
    CPU seconds, tracing span loss) into per-series rings."""

    def __init__(self, service: str = "",
                 period_s: float = _FLIGHTREC_PERIOD_S,
                 capacity: int = _FLIGHTREC_CAPACITY):
        self.service = service or f"pid{os.getpid()}"
        self.period_s = period_s
        self.capacity = capacity
        self._rings: Dict[str, _SeriesRing] = {}
        self._prev: Dict[str, Tuple[int, float]] = {}
        self._lock = threading.Lock()
        self._registries: List[Registry] = [default_registry()]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FlightRecorder":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="flightrec-sampler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def watch(self, registry: Registry) -> None:
        """Add a non-default registry to the sampled set."""
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_now()
            except Exception:
                pass  # a torn registry mutation must not kill sampling
            self._stop.wait(self.period_s)

    # -- sampling ----------------------------------------------------------
    def _process_samples(self) -> List[Tuple[str, str, float]]:
        """Per-process built-ins no Registry carries: resident set size,
        cumulative CPU seconds (rate = core share), and the span ring's
        unread-loss estimate."""
        from kubernetes_tpu_torch.util import tracing

        out: List[Tuple[str, str, float]] = []
        try:
            with open("/proc/self/statm") as fh:
                rss_pages = int(fh.read().split()[1])
            out.append(("process_resident_bytes", "gauge",
                        float(rss_pages * os.sysconf("SC_PAGE_SIZE"))))
        except (OSError, IndexError, ValueError):
            pass
        out.append(("process_cpu_seconds_total", "counter",
                    float(time.process_time())))
        loss = tracing.loss_peek()
        if loss is not None:
            out.append(("tracing_spans_dropped", "gauge", float(loss)))
        return out

    def sample_now(self) -> int:
        """One snapshot tick (the sampler thread's body; tests and the
        arm path call it directly). Returns the series count touched."""
        t_ns = time.monotonic_ns()
        with self._lock:
            regs = list(self._registries)
        points: List[Tuple[str, str, float]] = []
        for reg in regs:
            points.extend(reg.sample())
        points.extend(self._process_samples())
        with self._lock:
            for name, typ, val in points:
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = _SeriesRing(typ, self.capacity)
                ring.put(t_ns, val)
                if typ == "counter":
                    prev = self._prev.get(name)
                    self._prev[name] = (t_ns, val)
                    if prev is not None and t_ns > prev[0]:
                        rate = (val - prev[1]) / ((t_ns - prev[0]) / 1e9)
                        rname = name + ":rate"
                        rring = self._rings.get(rname)
                        if rring is None:
                            rring = self._rings[rname] = _SeriesRing(
                                "rate", self.capacity)
                        # counters are monotone; a reset (restart) shows
                        # as a clamped-to-zero rate, never a negative one
                        rring.put(t_ns, max(0.0, rate))
        return len(points)

    # -- the /debug/vars payload ------------------------------------------
    def vars_payload(self, since_ns: int = 0) -> Dict[str, object]:
        """The ``GET /debug/vars?since=<ns>`` body: this process's shard
        of samples newer than the caller's cursor. The cursor lives with
        the caller (the newest ``t`` it saw), so concurrent pullers never
        disturb each other and a re-pull is idempotent."""
        with self._lock:
            series = {}
            evicted = 0
            for name, ring in self._rings.items():
                pts = ring.since(since_ns)
                evicted += ring.evicted
                if pts:
                    series[name] = {"type": ring.typ, "samples": pts}
        return {"armed": True, "service": self.service, "pid": os.getpid(),
                "period_s": self.period_s, "capacity": self.capacity,
                "t_ns": time.monotonic_ns(), "evicted": evicted,
                "series": series}


# module-global fast path: one load + one branch when never armed, the
# same shape as tracing._on
_flightrec: Optional[FlightRecorder] = None


def flightrec() -> Optional[FlightRecorder]:
    return _flightrec


def flightrec_armed() -> bool:
    return _flightrec is not None


def flightrec_arm(service: str = "", period_s: float = _FLIGHTREC_PERIOD_S,
                  capacity: int = _FLIGHTREC_CAPACITY,
                  sample: bool = True) -> FlightRecorder:
    """Arm the per-process flight recorder (idempotent; the ring arrays
    are allocated HERE, so a never-sampled process pays nothing at
    import). ``sample=True`` takes an immediate first snapshot so the
    first cursor pull is never empty."""
    global _flightrec
    if _flightrec is None:
        _flightrec = FlightRecorder(service=service, period_s=period_s,
                                    capacity=capacity)
        if sample:
            _flightrec.sample_now()
        _flightrec.start()
    elif service and _flightrec.service.startswith("pid"):
        _flightrec.service = service
    return _flightrec


def flightrec_disarm() -> None:
    global _flightrec
    if _flightrec is not None:
        _flightrec.stop()
        _flightrec = None


def flightrec_watch(registry: Registry) -> None:
    if _flightrec is not None:
        _flightrec.watch(registry)


def flightrec_sample_now() -> int:
    return _flightrec.sample_now() if _flightrec is not None else 0


def flightrec_vars(since_ns: int = 0) -> Dict[str, object]:
    """/debug/vars body; a disarmed process answers with a marker (no
    shard yet), not an error."""
    if _flightrec is None:
        return {"armed": False, "service": f"pid{os.getpid()}",
                "pid": os.getpid(), "t_ns": time.monotonic_ns(),
                "series": {}}
    return _flightrec.vars_payload(since_ns)
