"""Event recording (ref: pkg/client/record/event.go + events_cache.go).

Port of ``kubernetes_tpu/client/record.py``: ``EventRecorder.eventf``
posts Events about objects to the API; repeated identical events are
compressed client-side by bumping ``count`` and ``last_timestamp`` instead
of creating new objects (ref: docs/design/event_compression.md,
events_cache.go). ``AsyncEventRecorder`` posts from a worker thread
behind a bounded queue and a qps/burst token bucket, the scheduler
binary's recorder (ref: event.go:53 StartRecording).
"""

from __future__ import annotations

import datetime
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.util import metrics

__all__ = ["EventRecorder", "AsyncEventRecorder"]


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)


class EventRecorder:
    # LRU bound on the compression cache (ref: events_cache.go — the
    # reference caches a bounded window too). The key embeds the full
    # message, and under 50k-pod churn every FailedScheduling/Scheduled
    # message embeds a distinct pod name: unbounded, the cache grew one
    # entry per pod FOREVER — a guaranteed leak in exactly the processes
    # (scheduler, kubelet) that live for the whole run. Evicting an
    # entry only costs compression: the next identical event posts fresh
    # instead of bumping count.
    _CACHE_MAX = 4096

    def __init__(self, client, source: api.EventSource,
                 max_cache: int = _CACHE_MAX):
        self.client = client
        self.source = source
        self._lock = threading.Lock()
        self._max_cache = max_cache
        # compression key -> last written Event (ref: events_cache.go caches
        # the full object so the bump is a single update round-trip);
        # LRU via OrderedDict move-to-end on hit, evict-oldest on insert
        self._cache: "OrderedDict[Tuple, api.Event]" = OrderedDict()

    def _cache_put(self, key: Tuple, ev: api.Event) -> None:
        with self._lock:
            self._cache[key] = ev
            self._cache.move_to_end(key)
            while len(self._cache) > self._max_cache:
                self._cache.popitem(last=False)

    def _ref(self, obj: Any) -> api.ObjectReference:
        m = obj.metadata
        return api.ObjectReference(
            kind=getattr(obj, "kind", type(obj).__name__), namespace=m.namespace,
            name=m.name, uid=m.uid, resource_version=m.resource_version)

    def eventf(self, obj: Any, reason: str, message_fmt: str, *args) -> Optional[api.Event]:
        """ref: event.go Eventf — fire-and-forget; never raises."""
        message = message_fmt % args if args else message_fmt
        ref = self._ref(obj)
        key = (ref.kind, ref.namespace, ref.name, ref.uid, reason, message,
               self.source.component, self.source.host)
        now = _now()
        try:
            with self._lock:
                cached = self._cache.get(key)
                if cached is not None:
                    self._cache.move_to_end(key)
            if cached is not None:
                # compression: bump count + lastTimestamp on the cached event
                try:
                    cached.count += 1
                    cached.last_timestamp = now
                    ev_client = self.client.events(cached.metadata.namespace)
                    out = ev_client.update(cached)
                    self._cache_put(key, out)
                    return out
                except Exception:
                    # the cached event expired (events carry a TTL) or raced:
                    # drop the poisoned entry and record a fresh event
                    with self._lock:
                        self._cache.pop(key, None)
            ev = api.Event(
                metadata=api.ObjectMeta(
                    generate_name=f"{ref.name}." if ref.name else "event.",
                    namespace=ref.namespace or api.NamespaceDefault),
                involved_object=ref, reason=reason, message=message,
                source=self.source, first_timestamp=now, last_timestamp=now, count=1)
            out = self.client.events(ev.metadata.namespace).create(ev)
            self._cache_put(key, out)
            return out
        except Exception:
            return None  # event recording must never break the caller


class AsyncEventRecorder:
    """Background-posting wrapper around EventRecorder.

    ref: pkg/client/record/event.go:53 — the reference's Eventf pushes
    into a Broadcaster and StartRecording posts from a goroutine, so
    recording never stalls a control loop on an apiserver round-trip.
    ``eventf`` enqueues and returns immediately; a worker thread drains
    through the wrapped recorder (keeping its dedup/compression cache).
    The queue is bounded and drop-oldest: under an event storm the
    control loop keeps running and old events are shed, never the loop
    blocked (events are best-effort diagnostics, not state)."""

    # Priority-aware shedding: when the queue is full or the --event-qps
    # bucket runs dry, SUCCESS chatter sheds before diagnostics, so a
    # shed event is never a FailedScheduling while a Scheduled could go
    # instead. These reasons are the routine per-pod success events (the
    # scheduler's Scheduled, the kubelet's lifecycle ticks); any other
    # reason is high priority and is only ever dropped when no
    # low-priority victim exists.
    LOW_PRIORITY_REASONS = frozenset(
        {"Scheduled", "Pulled", "Created", "Started"})

    def __init__(self, recorder: EventRecorder, max_queue: int = 4096,
                 qps: float = 0.0, burst: int = 100):
        self.recorder = recorder
        self._q: "deque" = deque(maxlen=max_queue)
        self._cond = threading.Condition()
        self._stopped = False
        self._in_flight = 0   # popped but not yet posted
        # optional client-side rate limit: events are best-effort
        # diagnostics, and a scheduler binding 1k pods/s would otherwise
        # emit 1k API writes/s of "Scheduled" events — the successor
        # codebase caps this the same way (--event-qps, default 50, in
        # kubelet/scheduler component config; the v0 reference predates
        # it, shipping only count compression). qps<=0 disables.
        self._qps = qps
        self._tokens = float(burst)
        self._burst = float(burst)
        # priority reserve: the token headroom low-priority events may
        # not touch (so the last tokens always go to diagnostics).
        # burst=1 keeps no reserve — a bucket that small cannot spare one.
        self._reserve = min(1.0, max(0.0, float(burst) - 1.0))
        self._last = time.monotonic()
        # `dropped` counts rate-limit drops only; the registered counter
        # family is the observable surface — event_recorder_posted_total /
        # event_recorder_dropped_total{reason} feed /metrics
        self.dropped = 0
        self._mx = metrics.event_recorder_metrics()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="event-recorder")
        self._worker.start()

    def _admit(self, low_priority: bool) -> bool:
        """Token-bucket admission with a priority reserve: low-priority
        events need ``1 + reserve`` tokens, high-priority need 1 — so
        as the bucket drains, Scheduled chatter sheds FIRST while the
        remaining tokens stay available for diagnostics. A dry bucket
        still caps everything (the --event-qps contract holds for a
        pure-diagnostics storm too)."""
        if self._qps <= 0:
            return True
        now = time.monotonic()
        self._tokens = min(self._burst,
                           self._tokens + (now - self._last) * self._qps)
        self._last = now
        need = 1.0 + (self._reserve if low_priority else 0.0)
        if self._tokens < need:
            self.dropped += 1
            # a low-priority event turned away while the reserve kept
            # tokens for diagnostics is a PRIORITY shed; a drop that
            # would have hit any reason is plain rate limiting
            self._mx.dropped.inc("shed_low_priority"
                                 if low_priority and self._tokens >= 1.0
                                 else "rate_limited")
            return False
        self._tokens -= 1.0
        return True

    def eventf(self, obj: Any, reason: str, message_fmt: str, *args) -> None:
        low = reason in self.LOW_PRIORITY_REASONS
        with self._cond:
            if self._stopped or not self._admit(low):
                return
            q = self._q
            if q.maxlen is not None and len(q) == q.maxlen:
                # priority-aware shedding at the bound: drop Scheduled
                # before FailedScheduling. If the OLDEST entry is
                # already low priority, this is the legacy drop-oldest
                # (reason queue_full); priority only earns its bucket
                # when it changes the outcome — evicting a deeper low
                # to protect queued diagnostics, or refusing a
                # low-priority arrival so queued diagnostics survive.
                if q[0][1] in self.LOW_PRIORITY_REASONS:
                    q.popleft()
                    self._mx.dropped.inc("queue_full")
                else:
                    victim = next((i for i in range(len(q))
                                   if q[i][1] in self.LOW_PRIORITY_REASONS),
                                  None)
                    if victim is not None:
                        del q[victim]
                        self._mx.dropped.inc("shed_low_priority")
                    elif low:
                        # queue is all diagnostics: the arriving
                        # success event is the one that sheds
                        self._mx.dropped.inc("shed_low_priority")
                        return
                    else:
                        q.popleft()
                        self._mx.dropped.inc("queue_full")
            q.append((obj, reason, message_fmt, args))
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._q:
                    return
                obj, reason, fmt, args = self._q.popleft()
                self._in_flight = 1
            try:
                out = self.recorder.eventf(obj, reason, fmt, *args)
                if out is not None:
                    self._mx.posted.inc()
                else:
                    # EventRecorder.eventf never raises; None means the
                    # apiserver write failed — a loss, disclosed
                    self._mx.dropped.inc("post_failed")
            finally:
                with self._cond:
                    self._in_flight = 0

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until everything enqueued so far has POSTED — queue empty
        alone is not enough, the worker may hold a popped item mid-post."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._q and not self._in_flight:
                    return True
            time.sleep(0.005)
        return False

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._worker.join(timeout=2.0)
