"""StoreHelper — typed CRUD over the versioned KV.

Port of ``kubernetes_tpu/storage/helper.py``.

Rebuild of the reference's EtcdHelper (ref: pkg/tools/etcd_helper.go:36-345 +
etcd_helper_watch.go:64-95): encodes/decodes API objects with the runtime
Scheme, maps the store's modified_index to ObjectMeta.resource_version, and
provides the read-modify-CAS ``atomic_update`` loop every registry and
controller relies on for optimistic concurrency.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from kubernetes_tpu_torch.runtime.clone import deep_clone
from typing import Any, Callable, Optional, Type

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.api import errors
from kubernetes_tpu_torch.api.meta import accessor
from kubernetes_tpu_torch.storage.memstore import (
    ErrCASConflict,
    ErrIndexOutdated,
    ErrKeyExists,
    ErrKeyNotFound,
    MemStore,
)

__all__ = ["StoreHelper", "parse_watch_resource_version"]


def parse_watch_resource_version(rv: str) -> int:
    """ref: pkg/tools/etcd_helper_watch.go:47-57 ParseWatchResourceVersion —
    '' or '0' means "from now"; otherwise watch resumes after rv."""
    if not rv or rv == "0":
        return 0
    try:
        return int(rv)
    except ValueError:
        raise errors.new_invalid("", rv, [ValueError(f"invalid resourceVersion {rv!r}")])


class StoreHelper:
    # (key, modified_index) -> decoded object. A stored revision is
    # immutable, so its decode is too: lists re-reading a stable cluster
    # and watch pumps fanning one event out to several watchers hit the
    # cache and pay a dict lookup instead of a full codec decode (~170us)
    # — the difference between 250 and 1000 pods/s of churn through the
    # live stack. Bounded FIFO.
    #
    # READ-SHARING CONTRACT: list and watch return the CACHED objects
    # themselves, not copies (the per-read deep_clone was ~13 clones per
    # churned pod — the single largest per-pod CPU item). Safe because
    # bulk/stream consumers only enumerate or encode: the HTTP path
    # serializes to wire bytes, the in-process transport deep-clones both
    # directions (client/client.py InProcessTransport._copy), and
    # controllers build fresh objects from what they read. The only
    # in-tree mutation of a served bulk read is master._stamp_self_links,
    # which writes the same deterministic string every time (idempotent).
    # SINGLE-object reads (extract_obj/delete_obj) stay isolated: the
    # get-mutate-set idiom is legitimate there and they are off the churn
    # hot path. atomic_update isolates before calling update_fn; the
    # DELETED-event resourceVersion rewrite clones explicitly.
    #
    # Sized to hold a full-shape churn working set (50k pods): at 8192 a
    # pod created early in the run was evicted by the time its bind
    # committed, so every batched bind paid a cold decode + the bind
    # event's prev_kv decode — two full codec passes back on the hot
    # path the cache exists to remove.
    _DECODE_CACHE_MAX = 65536

    def __init__(self, store: MemStore, scheme):
        self.store = store
        self.scheme = scheme
        self._decode_cache: "OrderedDict" = OrderedDict()
        self._decode_lock = threading.Lock()
        self._linkers: list = []  # (key prefix, decorate_fn)

    def register_linker(self, prefix: str, fn) -> None:
        """Register a decorator run ONCE per cached revision at decode time
        (the master registers selfLink stamping per resource prefix). With
        shared reads, decoration must happen before the object becomes
        visible — a post-read stamp would mutate an object other readers
        (watch pumps, concurrent lists) already see, making wire output
        order-dependent."""
        self._linkers.append((prefix if prefix.endswith("/") else prefix + "/",
                              fn))

    # -- encode/decode ------------------------------------------------------
    def _decode(self, kv, isolate: bool = False) -> Any:
        ck = (kv.key, kv.modified_index)
        # a lock-free read, as in GenericRegistry._attrs: a list decodes
        # every object of its kind, and concurrent lists convoyed on a
        # lock taken per object
        cached = self._decode_cache.get(ck)
        if cached is None:
            cached = self.scheme.decode(kv.value)
            accessor.set_resource_version(cached, str(kv.modified_index))
            for prefix, fn in self._linkers:
                if kv.key.startswith(prefix):
                    fn(cached)
                    break
            with self._decode_lock:
                self._decode_cache[ck] = cached
                while len(self._decode_cache) > self._DECODE_CACHE_MAX:
                    self._decode_cache.popitem(last=False)
        return deep_clone(cached) if isolate else cached

    def _encode(self, obj) -> str:
        # resourceVersion is storage metadata, not payload: clear before
        # encoding, like the reference (etcd_helper.go:236 Versioner).
        rv = accessor.resource_version(obj)
        accessor.set_resource_version(obj, "")
        try:
            return self.scheme.encode(obj)
        finally:
            accessor.set_resource_version(obj, rv)

    # -- CRUD ---------------------------------------------------------------
    def create_obj(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        """ref: etcd_helper.go:205 CreateObj."""
        try:
            kv = self.store.create(key, self._encode(obj), ttl=ttl)
        except ErrKeyExists:
            raise errors.new_already_exists(accessor.kind(obj), accessor.name(obj))
        # decorate the caller's object in place, like the reference
        # (etcd_helper.go CreateObj leaves the passed runtime.Object as
        # the result); nothing stored aliases it — the store holds bytes
        accessor.set_resource_version(obj, str(kv.modified_index))
        return obj

    def set_obj(self, key: str, obj: Any, ttl: Optional[float] = None) -> Any:
        """Write; CAS on the object's resourceVersion when set
        (ref: etcd_helper.go:236 SetObj)."""
        rv = accessor.resource_version(obj)
        try:
            if rv:
                kv = self.store.compare_and_swap(key, self._encode(obj), int(rv), ttl=ttl)
            else:
                kv = self.store.set(key, self._encode(obj), ttl=ttl)
        except ErrCASConflict:
            raise errors.new_conflict(accessor.kind(obj), accessor.name(obj))
        except ErrKeyNotFound:
            raise errors.new_not_found(accessor.kind(obj), accessor.name(obj))
        accessor.set_resource_version(obj, str(kv.modified_index))
        return obj

    def extract_obj(self, key: str, kind: str = "", name: str = "") -> Any:
        """ref: etcd_helper.go:144 ExtractObj."""
        try:
            kv = self.store.get(key)
        except ErrKeyNotFound:
            raise errors.new_not_found(kind or "resource", name or key)
        return self._decode(kv, isolate=True)

    def extract_to_list(self, prefix: str, list_type: Type) -> Any:
        """ref: etcd_helper.go:78 ExtractToList — items + list resourceVersion."""
        kvs, index = self.store.list(prefix)
        lst = list_type()
        lst.items = [self._decode(kv) for kv in kvs]
        lst.metadata.resource_version = str(index)
        return lst

    def delete_obj(self, key: str, kind: str = "", name: str = "") -> Any:
        try:
            prev = self.store.delete(key)
        except ErrKeyNotFound:
            raise errors.new_not_found(kind or "resource", name or key)
        return self._decode(prev, isolate=True)

    def atomic_update(self, key: str, obj_type: Type,
                      update_fn: Callable[[Any], Any],
                      ignore_not_found: bool = False,
                      ttl: Optional[float] = None,
                      max_retries: int = 100) -> Any:
        """Read-modify-CAS loop (ref: etcd_helper.go:311-345 AtomicUpdate).

        ``update_fn`` receives the current object (or a fresh ``obj_type()``
        when absent and ignore_not_found) and returns the desired object; on
        CAS conflict the loop re-reads and retries. This is THE concurrency
        primitive: the scheduler's bind path, status updates, and quota
        decrements all go through it.
        """
        for _ in range(max_retries):
            try:
                kv = self.store.get(key)
                # isolate: update_fn mutates what it is handed
                current = self._decode(kv, isolate=True)
                prev_index: Optional[int] = kv.modified_index
            except ErrKeyNotFound:
                if not ignore_not_found:
                    raise errors.new_not_found(obj_type.__name__, key)
                current = obj_type()
                prev_index = None
            desired = update_fn(current)
            encoded = self._encode(desired)
            try:
                if prev_index is None:
                    kv = self.store.create(key, encoded, ttl=ttl)
                else:
                    kv = self.store.compare_and_swap(key, encoded, prev_index, ttl=ttl)
            except (ErrCASConflict, ErrKeyExists, ErrKeyNotFound):
                continue  # re-read and retry
            # desired is already private (isolated decode above)
            accessor.set_resource_version(desired, str(kv.modified_index))
            return desired
        raise errors.new_conflict(obj_type.__name__, key, "too many CAS retries")

    def atomic_update_many(self, obj_type: Type,
                           updates: "list[tuple[str, Callable[[Any], Any]]]",
                           max_retries: int = 100) -> list:
        """Batched read-modify-CAS over many keys — the wave-commit path
        (SURVEY §7 hard part (e)): one get_many + one compare_and_swap_many
        per round instead of two store round-trips per object. Each key is
        independent (no all-or-nothing): the result list carries, per slot,
        the updated object or the errors.StatusError that update raised /
        the key's terminal store error. CAS-conflicted slots re-read and
        retry, exactly like atomic_update, without holding back the rest.
        """
        results: list = [None] * len(updates)
        live = list(range(len(updates)))
        for _ in range(max_retries):
            if not live:
                return results
            kvs = self.store.get_many([updates[i][0] for i in live])
            batch = []            # (slot, key, encoded, prev_index)
            for i, kv in zip(live, kvs):
                key, fn = updates[i]
                if kv is None:
                    results[i] = errors.new_not_found(
                        obj_type.__name__, key.rsplit("/", 1)[-1])
                    continue
                try:
                    desired = fn(self._decode(kv, isolate=True))
                except errors.StatusError as e:
                    results[i] = e
                    continue
                batch.append((i, key, self._encode(desired), desired,
                              kv.modified_index))
            outcomes = self.store.compare_and_swap_many(
                [(key, enc, prev) for _, key, enc, _, prev in batch])
            live = []
            for (i, key, _enc, desired, _prev), oc in zip(batch, outcomes):
                if isinstance(oc, ErrCASConflict):
                    live.append(i)        # lost a race: re-read and retry
                elif isinstance(oc, ErrKeyNotFound):
                    results[i] = errors.new_not_found(
                        obj_type.__name__, key.rsplit("/", 1)[-1])
                elif isinstance(oc, Exception):
                    results[i] = errors.new_internal_error(str(oc))
                else:
                    accessor.set_resource_version(desired,
                                                  str(oc.modified_index))
                    results[i] = desired
        for i in live:
            results[i] = errors.new_conflict(obj_type.__name__, updates[i][0],
                                             "too many CAS retries")
        return results

    def atomic_bind_evict_many(self, obj_type: Type,
                               items: "list[tuple]",
                               max_retries: int = 100) -> list:
        """kube-preempt's commit primitive: per item, delete every victim
        AND apply the pod update in ONE store transaction (MemStore
        .txn_many) — all-or-nothing per item, items independent. Each
        item is ``(pod_key, update_fn, victims)`` with victims a list of
        ``(victim_key, expected_uid)``; a victim whose uid no longer
        matches is a 409 (the world moved — the caller must re-solve),
        while an already-absent victim counts as evicted. CAS conflicts
        re-read and retry like atomic_update_many."""
        results: list = [None] * len(items)
        live = list(range(len(items)))
        for _ in range(max_retries):
            if not live:
                return results
            txn = []       # (slot, cas_ops, delete_ops, desired)
            for i in live:
                pod_key, fn, victims = items[i]
                try:
                    kv = self.store.get(pod_key)
                except ErrKeyNotFound:
                    results[i] = errors.new_not_found(
                        obj_type.__name__, pod_key.rsplit("/", 1)[-1])
                    continue
                try:
                    desired = fn(self._decode(kv, isolate=True))
                except errors.StatusError as e:
                    results[i] = e
                    continue
                vkeys = [vk for vk, _uid in victims]
                vkvs = self.store.get_many(vkeys)
                deletes = []
                bad = None
                for (vk, want_uid), vkv in zip(victims, vkvs):
                    if vkv is None:
                        continue  # already gone: eviction's goal state
                    if want_uid:
                        have = accessor.uid(self._decode(vkv))
                        if have != want_uid:
                            bad = errors.new_conflict(
                                obj_type.__name__,
                                vk.rsplit("/", 1)[-1],
                                f"victim {vk.rsplit('/', 1)[-1]} uid "
                                f"changed (have {have!r}, want "
                                f"{want_uid!r}) — re-solve required")
                            break
                    deletes.append((vk, vkv.modified_index))
                if bad is not None:
                    results[i] = bad
                    continue
                txn.append((i, [(pod_key, self._encode(desired),
                                 kv.modified_index)], deletes, desired))
            if not txn:
                live = []
                return results
            outcomes = self.store.txn_many(
                [(cas, dels) for _i, cas, dels, _d in txn])
            live = []
            for (i, _cas, _dels, desired), oc in zip(txn, outcomes):
                if isinstance(oc, (ErrCASConflict, ErrKeyNotFound)):
                    live.append(i)   # raced: re-read and retry
                elif isinstance(oc, Exception):
                    results[i] = errors.new_internal_error(str(oc))
                else:
                    accessor.set_resource_version(
                        desired, str(oc[0].modified_index))
                    results[i] = desired
        for i in live:
            results[i] = errors.new_conflict(obj_type.__name__,
                                             items[i][0],
                                             "too many CAS retries")
        return results

    # -- watch --------------------------------------------------------------
    def watch_raw(self, prefix: str, resource_version: str = "",
                  recursive: bool = True,
                  lag_limit: Optional[int] = None) -> watchpkg.Watcher:
        """Raw StoreEvent watch — the encode-once fan-out seam. The HTTP
        layer pulls StoreEvents on its OWN connection thread and maps each
        through translate_event + the apiserver's frame-bytes cache, so
        fanning one store mutation to N watchers costs one decode + one
        encode total instead of a pump thread and a re-encode per watcher.
        ``lag_limit`` bounds the per-watcher queue (see MemStore.watch)."""
        from_index = parse_watch_resource_version(resource_version)
        try:
            return self.store.watch(prefix, from_index=from_index,
                                    recursive=recursive, lag_limit=lag_limit)
        except ErrIndexOutdated as e:
            # Surface as an API-level 410 so clients above the store boundary
            # (Reflector, HTTP clients) share one expired-watch contract.
            raise errors.new_expired(str(e))

    def translate_event_fast(self, ev: watchpkg.Event):
        """Unfiltered translate: ``(event type, resourceVersion, obj_thunk)``
        with NO decode at all — the event type falls out of the store
        action, the resourceVersion out of the store index, and the
        object is only materialized (via the shared decode cache) if the
        apiserver's frame cache actually misses. This is the observer
        fan-out fast path: a cache-hit delivery touches no codec."""
        sev = ev.object
        a = sev.action
        if a == "create":
            return (watchpkg.ADDED, str(sev.kv.modified_index),
                    lambda: self._decode(sev.kv))
        if a in ("set", "compareAndSwap"):
            t = watchpkg.MODIFIED if sev.prev_kv is not None else watchpkg.ADDED
            return (t, str(sev.kv.modified_index),
                    lambda: self._decode(sev.kv))
        if a in ("delete", "expire"):
            if sev.prev_kv is None:
                return None

            def thunk():
                prev_out = deep_clone(self._decode(sev.prev_kv))
                # deleted object carries the deletion resourceVersion
                accessor.set_resource_version(prev_out, str(sev.index))
                return prev_out

            return (watchpkg.DELETED, str(sev.index), thunk)
        return None

    def translate_event(self, ev: watchpkg.Event,
                        filter_fn: Optional[Callable[[Any], bool]] = None
                        ) -> Optional[watchpkg.Event]:
        """Map one raw store Event to its API-level watch Event, or None
        when the object is outside ``filter_fn``. Factored from the watch
        pump so the HTTP byte-writer path and the threaded pump share one
        translation (and one decode cache). Like the reference's
        etcdWatcher filter, an object transitioning out of the filter
        emits DELETED and into it emits ADDED. Raises on undecodable
        payloads — callers surface an ERROR event and keep going."""
        sev = ev.object
        cur = self._decode(sev.kv) if sev.kv else None
        prev = self._decode(sev.prev_kv) if sev.prev_kv else None
        cur_ok = cur is not None and (filter_fn is None or filter_fn(cur))
        prev_ok = prev is not None and (filter_fn is None or filter_fn(prev))
        if sev.action in ("create",):
            if cur_ok:
                return watchpkg.Event(watchpkg.ADDED, cur)
        elif sev.action in ("set", "compareAndSwap"):
            if cur_ok and prev_ok:
                return watchpkg.Event(watchpkg.MODIFIED, cur)
            if cur_ok:
                return watchpkg.Event(watchpkg.ADDED, cur)
            if prev_ok:
                # fell out of the filter: deliver the *new* state like
                # the reference (etcd_helper_watch.go sendModify)
                return watchpkg.Event(watchpkg.DELETED, cur)
        elif sev.action in ("delete", "expire"):
            if prev_ok:
                # clone: the deletion-rv rewrite below must not
                # mutate the shared cached revision
                prev_out = deep_clone(prev)
                # deleted object carries the deletion resourceVersion
                accessor.set_resource_version(prev_out, str(sev.index))
                return watchpkg.Event(watchpkg.DELETED, prev_out)
        return None

    def watch(self, prefix: str, resource_version: str = "",
              filter_fn: Optional[Callable[[Any], bool]] = None,
              recursive: bool = True,
              lag_limit: Optional[int] = None) -> watchpkg.Watcher:
        """Decoded object watch (ref: etcd_helper_watch.go:64-95 WatchList).

        Store events become ADDED/MODIFIED/DELETED watch.Events carrying API
        objects (translate_event). A bounded watcher that lags out delivers
        one ERROR Event carrying a 410 Expired Status, then ends — the
        Reflector re-lists.
        """
        src = self.watch_raw(prefix, resource_version, recursive=recursive,
                             lag_limit=lag_limit)
        out = watchpkg.Watcher(on_stop=lambda _w: src.stop())

        def pump():
            for ev in src:
                if ev.type == watchpkg.ERROR and ev.object is None:
                    # bounded-lag drop-to-resync marker from the store
                    out.send(watchpkg.Event(
                        watchpkg.ERROR,
                        errors.new_expired("watch lag bound exceeded; "
                                           "re-list required").status))
                    break
                try:
                    tev = self.translate_event(ev, filter_fn)
                except Exception as e:  # undecodable payload: surface, keep going
                    out.send(watchpkg.Event(
                        watchpkg.ERROR, errors.new_internal_error(str(e)).status))
                    continue
                if tev is not None:
                    out.send(tev)
            out.close()

        t = threading.Thread(target=pump, daemon=True, name=f"watch-{prefix}")
        t.start()
        return out
