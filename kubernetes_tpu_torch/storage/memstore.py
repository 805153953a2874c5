"""MemStore — the versioned KV at the bottom of the stack.

Port of ``kubernetes_tpu/storage/memstore.py``.

Rebuild of the reference's persistence layer contract (etcd v2 as used by
pkg/tools/etcd_helper.go): a key/value tree with

- a single monotonically increasing **index**; every mutation gets one and
  stamps the key's ``modified_index`` (etcd ModifiedIndex — the basis of all
  resourceVersion semantics, ref: pkg/tools/etcd_helper_watch.go:47-57);
- **compare-and-swap** on that index (ref: etcd CompareAndSwap, used by
  EtcdHelper.AtomicUpdate, pkg/tools/etcd_helper.go:311-345);
- **watch from an index**, recursively over a prefix, served from a bounded
  in-memory event history (etcd keeps a 1000-event window; same here), with
  "index outdated" errors past the window;
- **TTL** per key (events use it, ref: pkg/registry/event seconds-to-live).

It is deliberately also the test double: like the reference's FakeEtcdClient
(pkg/tools/fake_etcd_client.go:42-67) it supports scriptable error injection
per (op, key) so registry/controller tests can exercise failure paths.

The store is process-local and thread-safe. A networked deployment puts the
apiserver in front of it (components never share the store directly —
DESIGN.md:40's invariant), so single-process ownership is the same model the
reference has: only the apiserver talks to etcd.
"""

from __future__ import annotations

import bisect
import heapq
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch import watch as watchpkg

__all__ = ["MemStore", "KV", "StoreEvent", "StoreError", "ErrKeyExists",
           "ErrKeyNotFound", "ErrCASConflict", "ErrIndexOutdated",
           "ErrInjected", "ErrTooManyRequests"]


class StoreError(Exception):
    pass


class ErrKeyExists(StoreError):
    pass


class ErrKeyNotFound(StoreError):
    pass


class ErrCASConflict(StoreError):
    pass


class ErrIndexOutdated(StoreError):
    """Watch index fell out of the history window (etcd error 401)."""


class ErrInjected(StoreError):
    """Raised by scripted error injection in tests."""


class ErrTooManyRequests(StoreError):
    """The store server SHED this op before executing it (kube-fairshed:
    StoreServer max_inflight overload valve). ``retry_after_s`` is the
    server's measured-drain hint; a resend can never double-apply —
    nothing ran. RemoteStore honors the hint transparently."""

    def __init__(self, message: str = "store overloaded",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class KV:
    key: str
    value: str
    created_index: int
    modified_index: int
    expiration: Optional[float] = None  # monotonic deadline

    @property
    def resource_version(self) -> int:
        return self.modified_index


@dataclass
class StoreEvent:
    """One mutation, as seen by watchers (etcd watch response analog)."""

    action: str  # "create" | "set" | "compareAndSwap" | "delete" | "expire"
    key: str
    index: int
    kv: Optional[KV] = None       # post-state (None for delete/expire)
    prev_kv: Optional[KV] = None  # pre-state (None for create)


class MemStore:
    HISTORY_WINDOW = 1000

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Condition()
        self._data: Dict[str, KV] = {}
        # sorted key index: list(prefix) is a bisect range scan instead of
        # an O(cluster) sort+filter — at 50k pods a per-create admission
        # LIST otherwise dominates the apiserver's create path
        self._keys: List[str] = []
        # expiry heap: only TTL'd keys are swept, so the common no-TTL op
        # costs O(1) instead of a full-store scan (entries may be stale
        # after rewrites; validated against the live KV when popped)
        self._ttl_heap: List[Tuple[float, str]] = []
        # Index 0 is RESERVED as the "from now" watch token (rv '0'/'' —
        # parse_watch_resource_version). Starting the store at 1 means an
        # empty-store LIST returns 1, a true resume token: watch(1)
        # replays any write that raced between the list and the watch
        # registration. Starting at 0 had a lost-event window at cluster
        # bootstrap — list on the fresh store returned 0, watch(0) meant
        # "from now", and a write landing between them vanished (found by
        # hack/test.sh --race: the reflector-into-FIFO probe timing out
        # with the pump parked on an empty raw queue).
        self._index = 1
        self._history: List[StoreEvent] = []
        self._clock = clock
        # test error injection: (op, key) -> exception to raise, one-shot list
        self._inject: Dict[Tuple[str, str], List[Exception]] = {}
        self._watchers: List[Tuple[str, bool, watchpkg.Watcher]] = []

    # -- error injection (FakeEtcdClient analog) ---------------------------
    def inject_error(self, op: str, key: str, exc: Exception, times: int = 1) -> None:
        self._inject.setdefault((op, key), []).extend([exc] * times)

    def _maybe_raise(self, op: str, key: str) -> None:
        q = self._inject.get((op, key))
        if q:
            raise q.pop(0)

    # -- internals ---------------------------------------------------------
    def _expired(self, kv: KV) -> bool:
        return kv.expiration is not None and self._clock() >= kv.expiration

    def _insert_key_locked(self, key: str) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)

    def _remove_key_locked(self, key: str) -> None:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            del self._keys[i]

    def _sweep_locked(self) -> None:
        if not self._ttl_heap:
            return
        now = self._clock()
        while self._ttl_heap and self._ttl_heap[0][0] <= now:
            _, k = heapq.heappop(self._ttl_heap)
            kv = self._data.get(k)
            if kv is None or kv.expiration is None or kv.expiration > now:
                continue  # rewritten since this heap entry; still alive
            self._remove_key_locked(k)
            del self._data[k]
            self._index += 1
            self._record_locked(StoreEvent("expire", k, self._index, None, kv))

    def _record_locked(self, ev: StoreEvent) -> None:
        self._history.append(ev)
        if len(self._history) > self.HISTORY_WINDOW:
            del self._history[: len(self._history) - self.HISTORY_WINDOW]
        for prefix, recursive, w in list(self._watchers):
            if w.stopped:
                self._watchers.remove((prefix, recursive, w))
                continue
            if _match(ev.key, prefix, recursive):
                w.send(watchpkg.Event(ev.action, ev))

    # -- transaction/group persistence hooks --------------------------------
    # No-ops here; DurableStore overrides them to group-commit the WAL.
    # The batched verbs bracket their apply phases so a persistent store
    # can (a) make each txn item ATOMIC on disk — every op of one
    # evict+bind lands in ONE WAL record, so a crash can never resurrect
    # half a transaction on replay — and (b) write the whole call's
    # records in one append+flush instead of one flush per op (the
    # N-fsyncs-per-wave group commit).

    def _txn_begin_locked(self) -> None:
        """A batched verb's apply phase begins (lock held)."""

    def _txn_boundary_locked(self) -> None:
        """One atomic unit's ops are complete (lock held): everything
        recorded since the last boundary must persist all-or-nothing."""

    def _txn_commit_locked(self) -> None:
        """The batched verb is done (lock held): persist every sealed
        unit with one physical write+flush."""

    # -- reads -------------------------------------------------------------
    @property
    def index(self) -> int:
        with self._lock:
            return self._index

    def get(self, key: str) -> KV:
        with self._lock:
            self._maybe_raise("get", key)
            self._sweep_locked()
            kv = self._data.get(key)
            if kv is None:
                raise ErrKeyNotFound(key)
            return kv

    def get_many(self, keys: List[str]) -> List[Optional[KV]]:
        """Read several keys under one lock acquisition (None = absent).
        Honors the same scripted "get" fault injection as get() so chaos
        tests exercise the batched path identically."""
        with self._lock:
            for k in keys:
                self._maybe_raise("get", k)
            self._sweep_locked()
            return [self._data.get(k) for k in keys]

    def list(self, prefix: str) -> Tuple[List[KV], int]:
        """All KVs under prefix (recursive) + the store index at read time."""
        with self._lock:
            self._maybe_raise("list", prefix)
            self._sweep_locked()
            if prefix and not prefix.endswith("/"):
                prefix = prefix + "/"
            keys, data = self._keys, self._data
            i = bisect.bisect_left(keys, prefix)
            # the keys under "a/b/" end before "a/b0" ('0' follows '/'):
            # one slice, not a startswith test per key, since every other
            # request waits on this lock while a list of every pod holds it
            j = (bisect.bisect_left(keys, prefix[:-1] + "0", i) if prefix
                 else len(keys))
            return [data[k] for k in keys[i:j]], self._index

    # -- writes ------------------------------------------------------------
    def create(self, key: str, value: str, ttl: Optional[float] = None) -> KV:
        with self._lock:
            self._maybe_raise("create", key)
            self._sweep_locked()
            if key in self._data:
                raise ErrKeyExists(key)
            self._index += 1
            kv = KV(key, value, self._index, self._index,
                    self._clock() + ttl if ttl else None)
            self._insert_key_locked(key)
            self._data[key] = kv
            if kv.expiration is not None:
                heapq.heappush(self._ttl_heap, (kv.expiration, key))
            self._record_locked(StoreEvent("create", key, self._index, kv, None))
            return kv

    def set(self, key: str, value: str, ttl: Optional[float] = None) -> KV:
        """Unconditional write (create or replace)."""
        with self._lock:
            self._maybe_raise("set", key)
            self._sweep_locked()
            prev = self._data.get(key)
            self._index += 1
            kv = KV(key, value, prev.created_index if prev else self._index,
                    self._index, self._clock() + ttl if ttl else None)
            self._insert_key_locked(key)
            self._data[key] = kv
            if kv.expiration is not None:
                heapq.heappush(self._ttl_heap, (kv.expiration, key))
            self._record_locked(
                StoreEvent("set" if prev else "create", key, self._index, kv, prev))
            return kv

    def compare_and_swap(self, key: str, value: str, prev_index: int,
                         ttl: Optional[float] = None) -> KV:
        """Write iff the key's modified_index is exactly prev_index
        (ref: etcd CompareAndSwap; pkg/tools/etcd_helper.go:330)."""
        with self._lock:
            self._maybe_raise("compare_and_swap", key)
            self._sweep_locked()
            prev = self._data.get(key)
            if prev is None:
                raise ErrKeyNotFound(key)
            if prev.modified_index != prev_index:
                raise ErrCASConflict(
                    f"{key}: index mismatch (have {prev.modified_index}, want {prev_index})")
            self._index += 1
            kv = KV(key, value, prev.created_index, self._index,
                    self._clock() + ttl if ttl else None)
            self._data[key] = kv
            if kv.expiration is not None:
                heapq.heappush(self._ttl_heap, (kv.expiration, key))
            self._record_locked(StoreEvent("compareAndSwap", key, self._index, kv, prev))
            return kv

    def compare_and_swap_many(self, items: List[Tuple[str, str, int]]
                              ) -> List[object]:
        """Batched CAS: each (key, value, prev_index) is applied
        independently under ONE lock acquisition — the wave-commit
        primitive (SURVEY §7 hard part (e): 10k binds landing in one wave
        must not pay 10k lock round-trips). Per-item outcomes are returned
        positionally (KV on success, StoreError on conflict/missing) so a
        lost race invalidates only that item, exactly as the serial CAS
        would; every success gets its own index + watch event in order."""
        out: List[object] = []
        with self._lock:
            self._sweep_locked()
            self._txn_begin_locked()
            try:
                for key, value, prev_index in items:
                    try:
                        self._maybe_raise("compare_and_swap", key)
                    except StoreError as e:
                        out.append(e)
                        continue
                    prev = self._data.get(key)
                    if prev is None:
                        out.append(ErrKeyNotFound(key))
                        continue
                    if prev.modified_index != prev_index:
                        out.append(ErrCASConflict(
                            f"{key}: index mismatch (have "
                            f"{prev.modified_index}, want {prev_index})"))
                        continue
                    self._index += 1
                    kv = KV(key, value, prev.created_index, self._index, None)
                    self._data[key] = kv
                    self._record_locked(StoreEvent(
                        "compareAndSwap", key, self._index, kv, prev))
                    # each CAS is its own atomic unit (per-op records on
                    # disk, exactly as the serial verb writes them); the
                    # commit below still flushes the wave ONCE
                    self._txn_boundary_locked()
                    out.append(kv)
            finally:
                self._txn_commit_locked()
        return out

    def txn_many(self, items: List[Tuple[List[Tuple[str, str, int]],
                                         List[Tuple[str, int]]]]
                 ) -> List[object]:
        """Per-item all-or-nothing transactions under ONE lock acquisition
        — the evict+bind commit primitive (kube-preempt). Each item is
        ``(cas_ops, delete_ops)``: cas_ops are (key, value, prev_index)
        writes, delete_ops are (key, prev_index) compare-and-deletes.
        EVERY guard in an item is validated before ANY of its ops apply;
        the first failing guard aborts the whole item (its outcome is the
        StoreError) and later items still run independently. Outcomes are
        positional: the list of written KVs on success (cas order then
        delete order carries no KVs — deletes return nothing), a
        StoreError otherwise. Watch events are recorded per applied op in
        order, exactly as the serial verbs would."""
        out: List[object] = []
        with self._lock:
            self._sweep_locked()
            self._txn_begin_locked()
            try:
                self._txn_many_locked(items, out)
            finally:
                self._txn_commit_locked()
        return out

    def _txn_many_locked(self, items, out: List[object]) -> None:
        for cas_ops, delete_ops in items:
            err: Optional[StoreError] = None
            for key, _value, prev_index in cas_ops:
                try:
                    self._maybe_raise("compare_and_swap", key)
                except StoreError as e:
                    err = e
                    break
                prev = self._data.get(key)
                if prev is None:
                    err = ErrKeyNotFound(key)
                    break
                if prev.modified_index != prev_index:
                    err = ErrCASConflict(
                        f"{key}: index mismatch (have "
                        f"{prev.modified_index}, want {prev_index})")
                    break
            if err is None:
                for key, prev_index in delete_ops:
                    try:
                        self._maybe_raise("delete", key)
                    except StoreError as e:
                        err = e
                        break
                    prev = self._data.get(key)
                    if prev is None:
                        err = ErrKeyNotFound(key)
                        break
                    if prev.modified_index != prev_index:
                        err = ErrCASConflict(
                            f"{key}: index mismatch (have "
                            f"{prev.modified_index}, want {prev_index})")
                        break
            if err is not None:
                out.append(err)
                continue
            written: List[KV] = []
            for key, value, _prev_index in cas_ops:
                prev = self._data[key]
                self._index += 1
                kv = KV(key, value, prev.created_index, self._index,
                        None)
                self._data[key] = kv
                self._record_locked(StoreEvent(
                    "compareAndSwap", key, self._index, kv, prev))
                written.append(kv)
            for key, _prev_index in delete_ops:
                prev = self._data[key]
                del self._data[key]
                self._remove_key_locked(key)
                self._index += 1
                self._record_locked(StoreEvent(
                    "delete", key, self._index, None, prev))
            out.append(written)
            # seal the item: its ops persist as ONE atomic WAL record
            self._txn_boundary_locked()

    def delete(self, key: str, prev_index: Optional[int] = None) -> KV:
        with self._lock:
            self._maybe_raise("delete", key)
            self._sweep_locked()
            prev = self._data.get(key)
            if prev is None:
                raise ErrKeyNotFound(key)
            if prev_index is not None and prev.modified_index != prev_index:
                raise ErrCASConflict(
                    f"{key}: index mismatch (have {prev.modified_index}, want {prev_index})")
            del self._data[key]
            self._remove_key_locked(key)
            self._index += 1
            self._record_locked(StoreEvent("delete", key, self._index, None, prev))
            return prev

    # -- watch -------------------------------------------------------------
    def watch(self, prefix: str, from_index: int = 0,
              recursive: bool = True,
              lag_limit: Optional[int] = None) -> watchpkg.Watcher:
        """Stream StoreEvents for keys under prefix with index > from_index.

        from_index == 0 means "from now" (ref: ParseWatchResourceVersion,
        pkg/tools/etcd_helper_watch.go:47-57: rv 0 watches from current state;
        rv N resumes after N). History replay past the window raises
        ErrIndexOutdated, which clients handle by relisting (the Reflector
        contract, ref: pkg/client/cache/reflector.go:83).

        ``lag_limit`` bounds how far a consumer may fall behind: past the
        bound, modify events for one key coalesce (latest state still
        delivered) and anything uncoalescible drops the watcher to resync
        — one ERROR event, then end-of-stream (see watch.Watcher). The
        default (None) keeps the historical unbounded queue for
        in-process consumers that are trusted to drain.
        """
        with self._lock:
            self._maybe_raise("watch", prefix)
            if from_index:
                oldest_replayable = self._history[0].index if self._history else self._index + 1
                if from_index + 1 < oldest_replayable and from_index < self._index:
                    # asked to replay events that are gone
                    raise ErrIndexOutdated(
                        f"requested index {from_index} is outside the history window")
            w = watchpkg.Watcher(
                lag_limit=lag_limit,
                coalesce=_coalesce_store_events if lag_limit else None)
            if from_index:
                for ev in self._history:
                    if ev.index > from_index and _match(ev.key, prefix, recursive):
                        w.send(watchpkg.Event(ev.action, ev))
            self._watchers.append((prefix, recursive, w))
            return w


def _coalesce_store_events(old: watchpkg.Event,
                           new: watchpkg.Event) -> Optional[watchpkg.Event]:
    """Merge two queued mutations of ONE key into a single modify event
    preserving the prev->cur chain: (v1->v2) + (v2->v3) becomes (v1->v3),
    proven contiguous by the store indices, so filter-transition logic
    downstream (helper.translate_event) still sees the true endpoints.
    Creates/deletes never merge — their presence transitions must be
    delivered (or the watcher resyncs)."""
    osev, nsev = old.object, new.object
    if not isinstance(osev, StoreEvent) or not isinstance(nsev, StoreEvent):
        return None
    if (osev.key != nsev.key
            or osev.action not in ("set", "compareAndSwap")
            or nsev.action not in ("set", "compareAndSwap")):
        return None
    if osev.kv is None or nsev.prev_kv is None \
            or osev.kv.modified_index != nsev.prev_kv.modified_index:
        return None  # not contiguous (interleaved delete/recreate)
    return watchpkg.Event(nsev.action, StoreEvent(
        nsev.action, nsev.key, nsev.index, nsev.kv, osev.prev_kv))


def _match(key: str, prefix: str, recursive: bool) -> bool:
    if not recursive:
        return key == prefix
    if prefix and not prefix.endswith("/"):
        prefix = prefix + "/"
    return key.startswith(prefix) or key == prefix.rstrip("/")
