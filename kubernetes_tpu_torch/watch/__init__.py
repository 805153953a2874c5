"""Watch primitives (ref: pkg/watch/).

Port of ``kubernetes_tpu/watch/__init__.py``.

``Watcher`` is the consumer handle (ref: watch.Interface — a result channel
plus Stop). ``Broadcaster`` fans one event stream out to many watchers
(ref: pkg/watch/mux.go:63-143).

Bounded-lag mode (``lag_limit``): the apiserver's fan-out path must never
let one slow watch connection grow an unbounded queue of encoded state.
A watcher constructed with ``lag_limit`` sheds load in two stages when
its consumer falls behind:

1. **coalescing** — once the queue is at the bound, a new event is merged
   into the newest queued event for the same key when the supplied
   ``coalesce`` function can prove the two are a contiguous
   modify-chain (v1->v2 + v2->v3 becomes v1->v3). The consumer still
   sees every key's latest state, just fewer intermediate revisions.
2. **drop-to-resync** — when coalescing cannot absorb the event, the
   queue is discarded wholesale and the consumer receives one ERROR
   event followed by end-of-stream (the bookmark-style "you lagged out"
   marker). Clients handle it with the Reflector contract: re-list and
   re-watch from the fresh resourceVersion.

Both degradations are counted (``watch_events_coalesced_total``,
``watch_lag_resyncs_total``) so fan-out loss is observable, never
silent; plain bounded watchers that overflow count
``watch_events_dropped_total`` and log once per watcher.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional

__all__ = ["ADDED", "MODIFIED", "DELETED", "ERROR", "Event", "Watcher",
           "Broadcaster"]

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"

_log = logging.getLogger("kubernetes_tpu_torch.watch")


@dataclass
class Event:
    type: str
    object: Any


_SENTINEL = object()


class _WatchMetrics:
    """Process-wide fan-out loss counters (default registry; the apiserver
    merges the default registry into its /metrics payload)."""

    _singleton = None

    def __init__(self):
        from kubernetes_tpu_torch.util import metrics as metrics_pkg
        reg = metrics_pkg.default_registry()
        self.dropped = reg.counter(
            "watch_events_dropped_total",
            "Watch events dropped on a full bounded watcher queue")
        self.coalesced = reg.counter(
            "watch_events_coalesced_total",
            "Watch events merged into a queued same-key event on a "
            "lagging watcher")
        self.lag_resyncs = reg.counter(
            "watch_lag_resyncs_total",
            "Watchers dropped to resync (ERROR + end-of-stream) after "
            "exceeding their lag bound")


def _watch_metrics() -> _WatchMetrics:
    if _WatchMetrics._singleton is None:
        _WatchMetrics._singleton = _WatchMetrics()
    return _WatchMetrics._singleton


class Watcher:
    """A stream of watch Events. Iterate it, or poll with next_event().

    ref: pkg/watch/watch.go Interface — ResultChan() + Stop().
    """

    def __init__(self, maxsize: int = 0, on_stop=None,
                 lag_limit: Optional[int] = None,
                 coalesce: Optional[Callable[[Event, Event],
                                             Optional[Event]]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stopped = threading.Event()
        self._on_stop = on_stop
        self._lag_limit = lag_limit
        self._coalesce = coalesce
        self._lagged = False
        self._warned_drop = False

    # producer side -------------------------------------------------------
    def send(self, event: Event, timeout: Optional[float] = None) -> bool:
        if self._stopped.is_set():
            return False
        if self._lag_limit is not None \
                and self._q.qsize() >= self._lag_limit:
            if self._coalesce is not None and self._try_coalesce(event):
                return True
            self.drop_to_resync()
            return False
        try:
            self._q.put(event, timeout=timeout)
            return True
        except queue.Full:
            self._count_drop()
            return False

    def _count_drop(self) -> None:
        _watch_metrics().dropped.inc()
        if not self._warned_drop:
            self._warned_drop = True
            _log.warning(
                "watcher queue full (maxsize=%d): dropping event(s); "
                "further drops on this watcher are counted in "
                "watch_events_dropped_total without logging",
                self._q.maxsize)

    # Coalescing only runs once a watcher is AT its lag bound, and the
    # producer calls it from the store's notify path (under the store
    # lock) — so the backward scan for a same-key predecessor is depth-
    # bounded: an unbounded scan of a 64k-deep queue per write would let
    # one stuck watcher serialize every store mutation behind it. A
    # predecessor deeper than this is a cold key on a hopeless watcher;
    # giving up degrades to drop-to-resync, which is where that watcher
    # is headed anyway.
    _COALESCE_SCAN_MAX = 256

    def _try_coalesce(self, event: Event) -> bool:
        """Merge ``event`` into the newest queued event for the same key.
        The coalesce function proves chain contiguity itself (by comparing
        store indices), so only one queued event can possibly merge."""
        merged = None
        with self._q.mutex:
            dq = self._q.queue
            lo = max(-1, len(dq) - 1 - self._COALESCE_SCAN_MAX)
            for i in range(len(dq) - 1, lo, -1):
                old = dq[i]
                if old is _SENTINEL:
                    continue
                merged = self._coalesce(old, event)
                if merged is not None:
                    del dq[i]
                    dq.append(merged)
                    break
        if merged is None:
            return False
        _watch_metrics().coalesced.inc()
        return True

    def drop_to_resync(self) -> None:
        """Bounded-lag overflow: discard everything queued, deliver one
        ERROR event (object=None — the transport layers substitute their
        own 410 Expired payload), end the stream. The consumer re-lists
        (the Reflector contract, ref: pkg/client/cache/reflector.go:83)."""
        if self._stopped.is_set():
            return
        self._lagged = True
        self._stopped.set()
        _watch_metrics().lag_resyncs.inc()
        _log.warning("watcher exceeded lag bound (%s queued): dropping to "
                     "resync", self._lag_limit)
        with self._q.mutex:
            self._q.queue.clear()
            self._q.queue.append(Event(ERROR, None))
            self._q.queue.append(_SENTINEL)
            self._q.not_empty.notify_all()

    @property
    def lagged(self) -> bool:
        """True once this watcher was dropped to resync."""
        return self._lagged

    def close(self) -> None:
        """End of stream: consumers see StopIteration after draining."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        # Never block here: a full bounded queue would deadlock stop(). The
        # stream is ending, so dropping one queued event to make room for the
        # sentinel is safe.
        while True:
            try:
                self._q.put_nowait(_SENTINEL)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._count_drop()
                except queue.Empty:
                    pass

    # consumer side -------------------------------------------------------
    def stop(self) -> None:
        """Consumer is done (ref: watch.Interface.Stop)."""
        cb, self._on_stop = self._on_stop, None
        self.close()
        if cb:
            cb(self)

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event or None on end-of-stream; raises queue.Empty on timeout."""
        ev = self._q.get(timeout=timeout)
        if ev is _SENTINEL:
            self._q.put(_SENTINEL)  # keep the stream terminated for others
            return None
        return ev

    def next_batch(self, max_items: int = 128,
                   timeout: Optional[float] = None,
                   linger: float = 0.0) -> Optional[List[Event]]:
        """Block for one event, then greedily drain up to ``max_items``
        without blocking — the fan-out writer's unit of work (one write
        syscall per batch instead of one per event). ``linger`` sleeps
        that long after the first event before draining: at a steady
        event rate this turns one wakeup + one write PER EVENT per
        watcher into one per batch — the difference between N watchers
        costing N condition-wakeup/GIL-handoff/syscall storms and N
        cheap byte copies (a few ms of delivery latency is invisible
        next to the scheduler's wave cadence). Returns None on
        end-of-stream; raises queue.Empty on timeout like next_event."""
        ev = self._q.get(timeout=timeout)
        if ev is _SENTINEL:
            self._q.put(_SENTINEL)
            return None
        out = [ev]
        # linger only when the queue is shallow: its purpose is to let a
        # TRICKLE accumulate into one write. When a backlog already fills
        # the batch, sleeping would cap drain throughput at
        # max_items/linger and a fast consumer could be paced into the
        # lag bound by its own writer.
        if linger > 0.0 and not self._stopped.is_set() \
                and self._q.qsize() < max_items:
            time.sleep(linger)
        while len(out) < max_items:
            try:
                ev = self._q.get_nowait()
            except queue.Empty:
                break
            if ev is _SENTINEL:
                self._q.put(_SENTINEL)
                break
            out.append(ev)
        return out

    def __iter__(self) -> Iterator[Event]:
        while True:
            ev = self._q.get()
            if ev is _SENTINEL:
                self._q.put(_SENTINEL)
                return
            yield ev


class Broadcaster:
    """Distributes events to many watchers (ref: pkg/watch/mux.go).

    Watchers that fall behind beyond ``queue_length`` block the broadcast
    (the reference's WaitIfChannelFull behavior) so no event is lost.
    """

    def __init__(self, queue_length: int = 25):
        self._lock = threading.Lock()
        self._watchers: set = set()
        self._queue_length = queue_length
        self._closed = False

    def watch(self) -> Watcher:
        with self._lock:
            if self._closed:
                raise RuntimeError("broadcaster is shut down")
            w = Watcher(maxsize=self._queue_length, on_stop=self._forget)
            self._watchers.add(w)
            return w

    def _forget(self, w: Watcher) -> None:
        with self._lock:
            self._watchers.discard(w)

    def action(self, event_type: str, obj: Any) -> None:
        ev = Event(event_type, obj)
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.send(ev)

    def shutdown(self) -> None:
        with self._lock:
            watchers, self._watchers = list(self._watchers), set()
            self._closed = True
        for w in watchers:
            w.close()
