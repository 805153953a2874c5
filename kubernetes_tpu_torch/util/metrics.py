"""Prometheus-style counters, gauges and histograms.

Port of the registry of ``kubernetes_tpu/util/metrics.py`` (the
reference's Prometheus instrumentation seam, ref: pkg/apiserver/
apiserver.go:40-87, pkg/kubelet/metrics/metrics.go:31-84) trimmed to what
the wave loop writes: ``Counter``, ``Gauge``, ``Histogram``, the
``Registry``, the encoder-resync counters and checkpoint histogram of the
journal-replay path (``SlipstreamMetrics``), the two pod-latency
histograms the commit and the bound-pod observer write
(``PodLatencyMetrics``) and the preemption family of the commit
(``PreemptionMetrics``). The text exposition comes with the scheduler
binary's ``/metrics``; the prewarm family is not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "default_registry",
           "DEFAULT_BUCKETS", "POD_E2E_BUCKETS", "SlipstreamMetrics",
           "slipstream_metrics", "PodLatencyMetrics", "pod_latency_metrics",
           "PreemptionMetrics", "preemption_metrics"]

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0)
# pod-lifecycle latency envelope: one wave in steady state, tens of
# seconds behind a burst
POD_E2E_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0)


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def total(self) -> float:
        """Sum across every label set (0.0 when nothing incremented)."""
        with self._lock:
            return sum(self._values.values())


class Gauge(Counter):
    def set(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
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


class Registry:
    """Named metric registry (get-or-create by name)."""

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


_default = Registry()


def default_registry() -> Registry:
    return _default


class SlipstreamMetrics:
    """The encoder-resync family of the journal-replay path
    (models/incremental.py checkpoint, scheduler/tpu_batch.py replay):
    replayed resyncs, full re-encodes by reason, checkpoint time."""

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
