"""Prometheus-style counters, gauges and histograms.

Port of the registry of ``kubernetes_tpu/util/metrics.py`` (the
reference's Prometheus instrumentation seam, ref: pkg/apiserver/
apiserver.go:40-87, pkg/kubelet/metrics/metrics.go:31-84) trimmed to what
the scheduler binary writes: ``Counter``, ``Gauge``, ``Histogram``, the
``Registry`` and its Prometheus text exposition (``render_text``, the
binary's ``/metrics``), the encoder-resync counters and checkpoint
histogram of the journal-replay path and the boot prewarm's readiness
gauge and seconds (``SlipstreamMetrics``), the two pod-latency histograms
the commit and the bound-pod observer write (``PodLatencyMetrics``), the
preemption family of the commit (``PreemptionMetrics``) and the async
event recorder's posted/dropped counters (``EventRecorderMetrics``). The
flight recorder's sampling (``/debug/vars``) is not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "default_registry",
           "DEFAULT_BUCKETS", "POD_E2E_BUCKETS", "SlipstreamMetrics",
           "slipstream_metrics", "PodLatencyMetrics", "pod_latency_metrics",
           "PreemptionMetrics", "preemption_metrics",
           "EventRecorderMetrics", "event_recorder_metrics"]

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


class Gauge(Counter):
    typ = "gauge"

    def set(self, value: float, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = float(value)


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


_default = Registry()


def default_registry() -> Registry:
    return _default


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
