"""Event recording (ref: pkg/client/record/event.go + events_cache.go).

Port of ``kubernetes_tpu/client/record.py``'s ``EventRecorder``:
``eventf`` posts Events about objects to the API; repeated identical
events are compressed client-side by bumping ``count`` and
``last_timestamp`` instead of creating new objects
(ref: docs/design/event_compression.md, events_cache.go). The
background-posting ``AsyncEventRecorder`` comes with the scheduler
binary.
"""

from __future__ import annotations

import datetime
import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

from kubernetes_tpu_torch.api import types as api

__all__ = ["EventRecorder"]


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
