"""StripedStore — the keyspace-sharded MemStore twin (kube-stripe).

Port of ``kubernetes_tpu/storage/stripestore.py``.

Every write in the cluster used to serialize behind MemStore's single
global lock, and watch fan-out to every subscribed watcher ran INSIDE
that critical section (memstore.py `_record_locked`) — the etcd-shaped
wall ROADMAP item 2 names. StripedStore splits the hot host-side state
into S shards (default 8, power of two) while keeping the ONE invariant
everything above the store depends on: a single, dense, totally-ordered
revision counter.

Shard map
    shard(key) = crc32(namespace component) & (S - 1)

where the namespace component of ``/registry/pods/default/web-1`` is
segment 2 (``default``) — so a per-namespace ``txn_many`` evict+bind
batch, and every key one 3+-segment prefix can match, stays on ONE
shard. Keys with fewer than three segments hash their last segment.

Each shard owns its lock, sorted key index, TTL heap, bounded history
ring, and watcher list. The revision counter lives under a separate
``_rev_lock`` acquired INSIDE a shard lock; because every event is
assigned its index, appended to its shard's history ring, persisted
(durable subclass), and delivered to root-prefix watchers under that one
lock, ``_index`` remains a total order across shards — watch resume
tokens, the frame cache's ``(rv, version)`` keys, and share.py seeding
are untouched. Per-shard watcher lists mean a pod storm fans out under
its own shard's lock only; watchers of unrelated namespaces never wait.

Lock discipline (the canonical order — docs/design/invariants.md):

    shard[i].lock (ascending shard id) -> _rev_lock -> watcher queues

Cross-shard ops (root-prefix LIST/watch, cross-namespace txn_many)
acquire every involved shard lock in ascending shard id, then the rev
lock per event. locksmith must record zero cycles; under KTPU_RACE the
shard locks are locksmith-named per shard id so the measured edge table
shows the ascending discipline instead of hiding same-site edges.

Deliberate, documented divergences from MemStore (everything else is
gated bit-identical by tests/test_storeshard.py):

- TTL sweep is per-shard: an op sweeps the shard(s) it touches, so a
  TTL'd key on an untouched shard expires when that shard is next
  touched (MemStore sweeps the world on every op). Expiry was always
  clock-dependent; no client observes order beyond the revision stamp.
- History retention is per-shard (S rings of HISTORY_WINDOW), so a
  resume token may be replayable striped where the global window had
  already evicted it — staleness is still enforced per shard: a
  ``watch(rv)`` with rv below a shard's evicted floor raises
  ErrIndexOutdated (the 410 Expired/re-list contract), never a silent
  gap.
"""

from __future__ import annotations

import bisect
import heapq
import json
import logging
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch import watch as watchpkg
from kubernetes_tpu_torch.storage.memstore import (
    KV, StoreEvent, StoreError, ErrKeyExists, ErrKeyNotFound,
    ErrCASConflict, ErrIndexOutdated, _coalesce_store_events, _match)
from kubernetes_tpu_torch.storage.durable import _parses, _SNAP, _WAL
from kubernetes_tpu_torch.util import chaos
from kubernetes_tpu_torch.util import locksmith
from kubernetes_tpu_torch.util import metrics as metrics_pkg

__all__ = ["StripedStore", "DurableStripedStore", "shard_of_key"]

_log = logging.getLogger("kubernetes_tpu_torch.storage.stripestore")


def _ns_token(key: str) -> str:
    """The shard-stable component: segment 2 of a registry key
    (``/registry/pods/<ns>/<name>`` -> ``<ns>``), else the last
    segment — chosen so every key a 3+-segment prefix can match shares
    the token with the prefix itself."""
    parts = [p for p in key.split("/") if p]
    if len(parts) >= 3:
        return parts[2]
    return parts[-1] if parts else ""


def shard_of_key(key: str, shards: int) -> int:
    return zlib.crc32(_ns_token(key).encode("utf-8")) & (shards - 1)


def _new_lock(name: str):
    # Under locksmith arming, threading.Lock() would be tracked anyway —
    # but every shard lock would share ONE creation site, and edges()
    # excludes same-site pairs, hiding exactly the shard[i] -> shard[j]
    # edges the race round must measure. Name each lock explicitly.
    if locksmith.armed():
        return locksmith.wrap(name)
    return threading.Lock()


class _Shard:
    __slots__ = ("sid", "lock", "data", "keys", "ttl_heap", "history",
                 "evicted_through", "watchers")

    def __init__(self, sid: int):
        self.sid = sid
        self.lock = _new_lock(f"stripestore.shard[{sid}]")
        self.data: Dict[str, KV] = {}
        self.keys: List[str] = []
        self.ttl_heap: List[Tuple[float, str]] = []
        self.history: List[StoreEvent] = []
        # newest revision known to be trimmed out of this shard's ring:
        # a resume token below this floor has lost events -> 410
        self.evicted_through = 0
        self.watchers: List[Tuple[str, bool, watchpkg.Watcher]] = []


class StripedStore:
    """Keyspace-sharded store, bit-identical to MemStore as its S=1
    twin (revision sequence, per-watcher frame order, list results) —
    the contract tests/test_storeshard.py enforces."""

    HISTORY_WINDOW = 1000

    def __init__(self, shards: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if shards < 1 or (shards & (shards - 1)) != 0:
            raise ValueError(f"shards must be a power of two, got {shards}")
        self.shards = shards
        self._mask = shards - 1
        self._shards = [_Shard(i) for i in range(shards)]
        self._rev_lock = _new_lock("stripestore.rev")
        # Index 0 is RESERVED as the "from now" watch token; starting at
        # 1 keeps the empty-store LIST a true resume token (memstore.py
        # bootstrap lost-event note). Guarded by _rev_lock.
        self._index = 1
        # oldest-coverage floor for staleness when rings alone can't
        # answer (snapshot recovery without full history)
        self._replay_floor = 0
        self._root_watchers: List[Tuple[str, bool, watchpkg.Watcher]] = []
        self._clock = clock
        self._inject: Dict[Tuple[str, str], List[Exception]] = {}
        self._mx = metrics_pkg.store_shard_metrics()
        self._mx.shard_count.set(shards)

    # -- error injection (FakeEtcdClient analog) ---------------------------
    def inject_error(self, op: str, key: str, exc: Exception,
                     times: int = 1) -> None:
        self._inject.setdefault((op, key), []).extend([exc] * times)

    def _maybe_raise(self, op: str, key: str) -> None:
        # callers always hold the key's shard lock (or the rev lock for
        # root-prefix watch), so per-key consumption is serialized
        q = self._inject.get((op, key))
        if q:
            raise q.pop(0)

    # -- shard resolution --------------------------------------------------
    def _sid_of(self, key: str) -> int:
        return zlib.crc32(_ns_token(key).encode("utf-8")) & self._mask

    def _shard_of(self, key: str) -> _Shard:
        return self._shards[self._sid_of(key)]

    def _sids_for_prefix(self, prefix: str,
                         recursive: bool) -> Optional[List[int]]:
        """Shard ids a prefix can touch; None means every shard (root).
        A 3+-segment recursive prefix pins the namespace token, so every
        matching key shares its shard."""
        if not recursive:
            return [self._sid_of(prefix)]
        parts = [p for p in prefix.split("/") if p]
        if len(parts) >= 3:
            return [zlib.crc32(parts[2].encode("utf-8")) & self._mask]
        return None

    def _acquire(self, sids) -> None:
        # THE lock discipline: ascending shard id, always
        for sid in sids:
            self._shards[sid].lock.acquire()

    def _release(self, sids) -> None:
        for sid in reversed(sids):
            self._shards[sid].lock.release()

    # -- internals (caller holds the shard's lock) -------------------------
    def _insert_key_shard_locked(self, sh: _Shard, key: str) -> None:
        if key not in sh.data:
            bisect.insort(sh.keys, key)

    def _remove_key_shard_locked(self, sh: _Shard, key: str) -> None:
        i = bisect.bisect_left(sh.keys, key)
        if i < len(sh.keys) and sh.keys[i] == key:
            del sh.keys[i]

    def _commit_shard_locked(self, sh: _Shard, action: str, key: str,
                             prev: Optional[KV], build
                             ) -> Tuple[Optional[KV], StoreEvent]:
        """Assign the next revision, build the KV at that revision
        (``build(rev) -> KV``, or None for delete/expire), record into
        the shard's ring, persist, and fan out to root watchers — ONE
        rev-lock critical section, which is what keeps ``_index`` a
        total order across shards AND keeps root-watcher frames in
        revision order (assignment and delivery can never interleave
        between two writers). The caller — still holding the shard
        lock — then mutates shard data and delivers to the shard's own
        watchers via _deliver_shard_locked."""
        with self._rev_lock:
            self._index += 1
            kv = build(self._index) if build is not None else None
            ev = StoreEvent(action, key, self._index, kv, prev)
            sh.history.append(ev)
            if len(sh.history) > self.HISTORY_WINDOW:
                drop = len(sh.history) - self.HISTORY_WINDOW
                sh.evicted_through = sh.history[drop - 1].index
                del sh.history[:drop]
            self._persist_rev_locked(ev, sh.sid)
            for ent in list(self._root_watchers):
                prefix, recursive, w = ent
                if w.stopped:
                    self._root_watchers.remove(ent)
                    continue
                if _match(key, prefix, recursive):
                    w.send(watchpkg.Event(ev.action, ev))
        return kv, ev

    def _deliver_shard_locked(self, sh: _Shard, ev: StoreEvent) -> None:
        """Fan out to this shard's own watchers — under the shard lock
        only, never the rev lock: a pod storm here blocks its own
        namespace shard, not the cluster."""
        for ent in list(sh.watchers):
            prefix, recursive, w = ent
            if w.stopped:
                sh.watchers.remove(ent)
                continue
            if _match(ev.key, prefix, recursive):
                w.send(watchpkg.Event(ev.action, ev))

    def _sweep_shard_locked(self, sh: _Shard) -> None:
        if not sh.ttl_heap:
            return
        now = self._clock()
        while sh.ttl_heap and sh.ttl_heap[0][0] <= now:
            _, k = heapq.heappop(sh.ttl_heap)
            kv = sh.data.get(k)
            if kv is None or kv.expiration is None or kv.expiration > now:
                continue  # rewritten since this heap entry; still alive
            self._remove_key_shard_locked(sh, k)
            del sh.data[k]
            _, ev = self._commit_shard_locked(sh, "expire", k, kv, None)
            self._deliver_shard_locked(sh, ev)

    # -- persistence / txn hooks (DurableStripedStore overrides) -----------
    def _persist_rev_locked(self, ev: StoreEvent, sid: int) -> None:
        """Called under the rev lock for every event, in index order."""

    def _txn_begin(self) -> None:
        """A batched verb's apply phase begins (its shard locks held)."""

    def _txn_boundary(self) -> None:
        """One atomic unit's ops are complete: everything persisted
        since the last boundary must land all-or-nothing."""

    def _txn_commit(self) -> None:
        """The batched verb is done: flush every sealed unit once."""

    def _after_op(self) -> None:
        """Post-verb hook, called with NO locks held (lazy compaction
        in the durable subclass — compaction needs every shard lock, so
        it can never run inside a partially-locked write path)."""

    # -- reads -------------------------------------------------------------
    @property
    def index(self) -> int:
        with self._rev_lock:
            return self._index

    def get(self, key: str) -> KV:
        sh = self._shard_of(key)
        with sh.lock:
            self._maybe_raise("get", key)
            self._sweep_shard_locked(sh)
            kv = sh.data.get(key)
            if kv is None:
                raise ErrKeyNotFound(key)
        self._after_op()
        return kv

    def get_many(self, keys: List[str]) -> List[Optional[KV]]:
        sids = sorted({self._sid_of(k) for k in keys})
        self._acquire(sids)
        try:
            for k in keys:
                self._maybe_raise("get", k)
            for sid in sids:
                self._sweep_shard_locked(self._shards[sid])
            out = [self._shard_of(k).data.get(k) for k in keys]
        finally:
            self._release(sids)
        self._after_op()
        return out

    def list(self, prefix: str) -> Tuple[List[KV], int]:
        """All KVs under prefix (recursive), key-ascending exactly like
        MemStore (list bytes are part of the bit-identity gate), + the
        store index at read time. A 3+-segment prefix scans one shard;
        a root prefix scans all shards (ascending) and merges by key."""
        sids = self._sids_for_prefix(prefix, True)
        if sids is None:
            sids = list(range(self.shards))
        norm = prefix + "/" if prefix and not prefix.endswith("/") else prefix
        self._acquire(sids)
        try:
            self._maybe_raise("list", prefix)
            runs: List[List[KV]] = []
            for sid in sids:
                sh = self._shards[sid]
                self._sweep_shard_locked(sh)
                i = bisect.bisect_left(sh.keys, norm)
                run: List[KV] = []
                keys = sh.keys
                while i < len(keys) and keys[i].startswith(norm):
                    run.append(sh.data[keys[i]])
                    i += 1
                if run:
                    runs.append(run)
            with self._rev_lock:
                idx = self._index
        finally:
            self._release(sids)
        self._after_op()
        if len(runs) == 1:
            return runs[0], idx
        return list(heapq.merge(*runs, key=lambda kv: kv.key)), idx

    # -- writes ------------------------------------------------------------
    def create(self, key: str, value: str, ttl: Optional[float] = None) -> KV:
        sh = self._shard_of(key)
        with sh.lock:
            self._maybe_raise("create", key)
            self._sweep_shard_locked(sh)
            if key in sh.data:
                raise ErrKeyExists(key)
            exp = self._clock() + ttl if ttl else None
            kv, ev = self._commit_shard_locked(
                sh, "create", key, None,
                lambda rev: KV(key, value, rev, rev, exp))
            self._insert_key_shard_locked(sh, key)
            sh.data[key] = kv
            if exp is not None:
                heapq.heappush(sh.ttl_heap, (exp, key))
            self._deliver_shard_locked(sh, ev)
        self._count(sh.sid, 1)
        self._after_op()
        return kv

    def set(self, key: str, value: str, ttl: Optional[float] = None) -> KV:
        """Unconditional write (create or replace)."""
        sh = self._shard_of(key)
        with sh.lock:
            self._maybe_raise("set", key)
            self._sweep_shard_locked(sh)
            prev = sh.data.get(key)
            exp = self._clock() + ttl if ttl else None
            kv, ev = self._commit_shard_locked(
                sh, "set" if prev else "create", key, prev,
                lambda rev: KV(key, value,
                               prev.created_index if prev else rev,
                               rev, exp))
            self._insert_key_shard_locked(sh, key)
            sh.data[key] = kv
            if exp is not None:
                heapq.heappush(sh.ttl_heap, (exp, key))
            self._deliver_shard_locked(sh, ev)
        self._count(sh.sid, 1)
        self._after_op()
        return kv

    def compare_and_swap(self, key: str, value: str, prev_index: int,
                         ttl: Optional[float] = None) -> KV:
        sh = self._shard_of(key)
        with sh.lock:
            self._maybe_raise("compare_and_swap", key)
            self._sweep_shard_locked(sh)
            prev = sh.data.get(key)
            if prev is None:
                raise ErrKeyNotFound(key)
            if prev.modified_index != prev_index:
                raise ErrCASConflict(
                    f"{key}: index mismatch (have {prev.modified_index}, "
                    f"want {prev_index})")
            exp = self._clock() + ttl if ttl else None
            kv, ev = self._commit_shard_locked(
                sh, "compareAndSwap", key, prev,
                lambda rev: KV(key, value, prev.created_index, rev, exp))
            sh.data[key] = kv
            if exp is not None:
                heapq.heappush(sh.ttl_heap, (exp, key))
            self._deliver_shard_locked(sh, ev)
        self._count(sh.sid, 1)
        self._after_op()
        return kv

    def delete(self, key: str, prev_index: Optional[int] = None) -> KV:
        sh = self._shard_of(key)
        with sh.lock:
            self._maybe_raise("delete", key)
            self._sweep_shard_locked(sh)
            prev = sh.data.get(key)
            if prev is None:
                raise ErrKeyNotFound(key)
            if prev_index is not None and prev.modified_index != prev_index:
                raise ErrCASConflict(
                    f"{key}: index mismatch (have {prev.modified_index}, "
                    f"want {prev_index})")
            del sh.data[key]
            self._remove_key_shard_locked(sh, key)
            _, ev = self._commit_shard_locked(sh, "delete", key, prev, None)
            self._deliver_shard_locked(sh, ev)
        self._count(sh.sid, 1)
        self._after_op()
        return prev

    def compare_and_swap_many(self, items: List[Tuple[str, str, int]]
                              ) -> List[object]:
        """Batched CAS under ONE acquisition of every involved shard
        lock (ascending): per-item outcomes positional, every success
        its own revision + watch event in order — the wave-commit
        primitive, semantics identical to MemStore's."""
        out: List[object] = []
        sids = sorted({self._sid_of(k) for k, _v, _p in items})
        self._acquire(sids)
        try:
            for sid in sids:
                self._sweep_shard_locked(self._shards[sid])
            self._txn_begin()
            try:
                for key, value, prev_index in items:
                    sh = self._shard_of(key)
                    try:
                        self._maybe_raise("compare_and_swap", key)
                    except StoreError as e:
                        out.append(e)
                        continue
                    prev = sh.data.get(key)
                    if prev is None:
                        out.append(ErrKeyNotFound(key))
                        continue
                    if prev.modified_index != prev_index:
                        out.append(ErrCASConflict(
                            f"{key}: index mismatch (have "
                            f"{prev.modified_index}, want {prev_index})"))
                        continue
                    kv, ev = self._commit_shard_locked(
                        sh, "compareAndSwap", key, prev,
                        lambda rev, k=key, v=value, p=prev: KV(
                            k, v, p.created_index, rev, None))
                    sh.data[key] = kv
                    self._deliver_shard_locked(sh, ev)
                    self._txn_boundary()
                    out.append(kv)
            finally:
                self._txn_commit()
        finally:
            self._release(sids)
        self._count(sids[0] if len(sids) == 1 else -1, len(items))
        self._after_op()
        return out

    def txn_many(self, items: List[Tuple[List[Tuple[str, str, int]],
                                         List[Tuple[str, int]]]]
                 ) -> List[object]:
        """Per-item all-or-nothing transactions (the evict+bind commit
        primitive) under ONE acquisition of every involved shard lock,
        ascending. Cross-shard items stay atomic: every guard of an item
        is validated while ALL its shards are held, so no concurrent
        writer can invalidate a guard between validation and apply."""
        out: List[object] = []
        sids = set()
        for cas_ops, delete_ops in items:
            for key, _v, _p in cas_ops:
                sids.add(self._sid_of(key))
            for key, _p in delete_ops:
                sids.add(self._sid_of(key))
        sids = sorted(sids)
        self._acquire(sids)
        try:
            for sid in sids:
                self._sweep_shard_locked(self._shards[sid])
            self._txn_begin()
            try:
                self._txn_many_shards_locked(items, out)
            finally:
                self._txn_commit()
        finally:
            self._release(sids)
        self._count(sids[0] if len(sids) == 1 else -1, len(items))
        self._after_op()
        return out

    def _txn_many_shards_locked(self, items, out: List[object]) -> None:
        for cas_ops, delete_ops in items:
            err: Optional[StoreError] = None
            for key, _value, prev_index in cas_ops:
                try:
                    self._maybe_raise("compare_and_swap", key)
                except StoreError as e:
                    err = e
                    break
                prev = self._shard_of(key).data.get(key)
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
                    prev = self._shard_of(key).data.get(key)
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
                sh = self._shard_of(key)
                prev = sh.data[key]
                kv, ev = self._commit_shard_locked(
                    sh, "compareAndSwap", key, prev,
                    lambda rev, k=key, v=value, p=prev: KV(
                        k, v, p.created_index, rev, None))
                sh.data[key] = kv
                self._deliver_shard_locked(sh, ev)
                written.append(kv)
            for key, _prev_index in delete_ops:
                sh = self._shard_of(key)
                prev = sh.data[key]
                del sh.data[key]
                self._remove_key_shard_locked(sh, key)
                _, ev = self._commit_shard_locked(
                    sh, "delete", key, prev, None)
                self._deliver_shard_locked(sh, ev)
            out.append(written)
            # seal the item: its ops persist as ONE atomic WAL record
            self._txn_boundary()

    # -- watch -------------------------------------------------------------
    def watch(self, prefix: str, from_index: int = 0,
              recursive: bool = True,
              lag_limit: Optional[int] = None) -> watchpkg.Watcher:
        """Stream StoreEvents for keys under prefix with index >
        from_index — MemStore's contract, enforced per shard:

        - a 3+-segment (or non-recursive) prefix registers on its ONE
          shard; replay and staleness come from that shard's ring, and
          live fan-out runs under that shard's lock only;
        - a root prefix registers on the global list; replay is the
          revision-ordered merge of every shard's ring, staleness is
          checked against EVERY shard's evicted floor (a gap in any
          shard the prefix spans is a gap in the merged stream), and
          live fan-out runs under the rev lock — which is exactly what
          makes the merged stream revision-ordered.

        A resume token below a relevant shard's evicted floor raises
        ErrIndexOutdated -> the 410 Expired/re-list Reflector path,
        never a silent skip.
        """
        sids = self._sids_for_prefix(prefix, recursive)
        if sids is not None and len(sids) == 1:
            sh = self._shards[sids[0]]
            with sh.lock:
                self._maybe_raise("watch", prefix)
                if from_index:
                    floor = max(sh.evicted_through, self._replay_floor)
                    if from_index < floor:
                        raise ErrIndexOutdated(
                            f"requested index {from_index} is outside the "
                            f"history window of shard {sh.sid}")
                w = watchpkg.Watcher(
                    lag_limit=lag_limit,
                    coalesce=_coalesce_store_events if lag_limit else None)
                if from_index:
                    for ev in sh.history:
                        if ev.index > from_index and _match(
                                ev.key, prefix, recursive):
                            w.send(watchpkg.Event(ev.action, ev))
                sh.watchers.append((prefix, recursive, w))
                return w
        # root prefix: register under the rev lock — ring appends happen
        # under it too, so replay-then-register has no lost-event gap
        with self._rev_lock:
            self._maybe_raise("watch", prefix)
            if from_index:
                floor = max([self._replay_floor]
                            + [sh.evicted_through for sh in self._shards])
                if from_index < floor and from_index < self._index:
                    raise ErrIndexOutdated(
                        f"requested index {from_index} is outside the "
                        f"history window")
            w = watchpkg.Watcher(
                lag_limit=lag_limit,
                coalesce=_coalesce_store_events if lag_limit else None)
            if from_index:
                for ev in heapq.merge(
                        *(sh.history for sh in self._shards),
                        key=lambda e: e.index):
                    if ev.index > from_index and _match(
                            ev.key, prefix, recursive):
                        w.send(watchpkg.Event(ev.action, ev))
            self._root_watchers.append((prefix, recursive, w))
            return w

    # -- disclosure --------------------------------------------------------
    def shard_stats(self) -> dict:
        """Per-shard occupancy for records/healthz (locks taken briefly,
        ascending)."""
        keys, watchers = [], []
        for sh in self._shards:
            with sh.lock:
                keys.append(len(sh.keys))
                watchers.append(len(sh.watchers))
        with self._rev_lock:
            root = len(self._root_watchers)
            idx = self._index
        return {"shards": self.shards, "index": idx, "keys": keys,
                "shard_watchers": watchers, "root_watchers": root}

    def _count(self, sid: int, n: int) -> None:
        # metrics OUTSIDE every store lock: the counter has its own
        # mutex and must never appear inside the shard/rev sections
        self._mx.ops.inc("cross" if sid < 0 else str(sid), by=n)


class DurableStripedStore(StripedStore):
    """StripedStore persisted by the SAME WAL + snapshot format as
    DurableStore (storage/durable.py) — byte-compatible both ways, plus
    a shard tag (``"s"``) on each WAL entry so replay tooling can
    attribute records without rehashing keys.

    The rev lock serializes every WAL append, so WAL order is revision
    order for serial verbs; a batched verb buffers its item's entries
    thread-locally (other shards' writers keep appending their own
    records meanwhile) and seals each atomic item into ONE record at the
    boundary, flushing the whole call once at commit — group commit,
    unchanged. Replay is order-insensitive across interleaved records
    because a batch holds all its shard locks for its whole apply phase:
    no interleaved record can touch a batch's keys, and per-key index
    order is preserved.

    Compaction needs every shard lock (snapshot = merged global state),
    so it can't run inside `_wal_append_rev_locked` like DurableStore's;
    the append marks compaction pending and `_after_op` — called with no
    locks held — takes all shard locks ascending + the rev lock and
    compacts there.
    """

    def __init__(self, directory: str, shards: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 fsync: bool = False, compact_every: int = 10_000):
        super().__init__(shards=shards, clock=clock)
        self._dir = directory
        self._wall = wall_clock
        self._fsync = fsync
        self._compact_every = compact_every
        self._compact_pending = False
        self._wal_records = 0
        self._wal_bytes = 0
        self._wal_f = None  # set after recovery; persist no-ops until
        self._txn_tls = threading.local()
        self._wmx = metrics_pkg.store_wal_metrics()
        os.makedirs(directory, exist_ok=True)
        self._recover()
        self._wal_f = open(os.path.join(directory, _WAL), "a",
                           encoding="utf-8")
        self._wal_bytes = os.path.getsize(os.path.join(directory, _WAL))
        self._wmx.wal_size.set(self._wal_bytes)
        self._wal_records = self._recovered_records
        if self._wal_records >= self._compact_every:
            self.compact()

    # -- wall-clock TTL rebasing (DurableStore contract) -------------------
    def _exp_to_wall(self, exp_mono: Optional[float]) -> Optional[float]:
        if exp_mono is None:
            return None
        return self._wall() + (exp_mono - self._clock())

    def _exp_from_wall(self, exp_wall: Optional[float]) -> Optional[float]:
        if exp_wall is None:
            return None
        return self._clock() + (exp_wall - self._wall())

    def _entry_of(self, ev: StoreEvent, sid: int) -> dict:
        entry = {"a": ev.action, "k": ev.key, "i": ev.index, "s": sid}
        if ev.kv is not None:
            entry["v"] = ev.kv.value
            entry["c"] = ev.kv.created_index
            if ev.kv.expiration is not None:
                entry["e"] = self._exp_to_wall(ev.kv.expiration)
        return entry

    # -- persistence hooks --------------------------------------------------
    def _persist_rev_locked(self, ev: StoreEvent, sid: int) -> None:
        if self._wal_f is None:
            return  # replaying recovery
        entry = self._entry_of(ev, sid)
        buf = getattr(self._txn_tls, "buf", None)
        if buf is not None:
            # this thread is inside a batched verb: buffer; the boundary
            # seals the item into one record, the commit flushes once
            buf.append(entry)
            self._txn_tls.ops += 1
            return
        self._wal_append_rev_locked([json.dumps(entry)], ops=1)

    def _txn_begin(self) -> None:
        if self._wal_f is None:
            return
        self._txn_tls.buf = []
        self._txn_tls.lines = []
        self._txn_tls.ops = 0

    def _txn_boundary(self) -> None:
        buf = getattr(self._txn_tls, "buf", None)
        if not buf:
            return  # outside a batch, or the item recorded nothing
        line = json.dumps(buf[0]) if len(buf) == 1 \
            else json.dumps({"txn": buf})
        self._txn_tls.lines.append(line)
        self._txn_tls.buf = []

    def _txn_commit(self) -> None:
        if getattr(self._txn_tls, "buf", None) is None:
            return
        self._txn_boundary()  # seal a dangling unit defensively
        lines, ops = self._txn_tls.lines, self._txn_tls.ops
        self._txn_tls.buf = None
        self._txn_tls.lines = []
        self._txn_tls.ops = 0
        if lines:
            with self._rev_lock:
                self._wal_append_rev_locked(lines, ops=ops)

    def _wal_append_rev_locked(self, lines: List[str], ops: int) -> None:
        """The ONLY writer of WAL bytes, always under the rev lock —
        one write+flush(+fsync) per call. Chaos crash points keep the
        exact seam names DurableStore uses so the WAL atomicity tests
        exercise both stores identically."""
        chaos.crash_if_armed("durable.wal_append.pre")
        data = "\n".join(lines) + "\n"
        self._wal_f.write(data)
        self._wal_f.flush()
        if self._fsync:
            os.fsync(self._wal_f.fileno())
            self._wmx.fsyncs.inc()
        chaos.crash_if_armed("durable.wal_append.post")
        self._wal_records += len(lines)
        self._wal_bytes += len(data)
        self._wmx.records.inc(by=len(lines))
        self._wmx.ops.inc(by=ops)
        self._wmx.group_commits.inc()
        self._wmx.bytes_written.inc(by=len(data))
        self._wmx.wal_size.set(self._wal_bytes)
        if self._wal_records >= self._compact_every:
            self._compact_pending = True

    def _after_op(self) -> None:
        if self._compact_pending and self._wal_f is not None:
            self.compact()

    # -- snapshot / compaction ---------------------------------------------
    def _kv_dict(self, kv: Optional[KV]) -> Optional[dict]:
        if kv is None:
            return None
        d = {"k": kv.key, "v": kv.value, "c": kv.created_index,
             "m": kv.modified_index}
        if kv.expiration is not None:
            d["e"] = self._exp_to_wall(kv.expiration)
        return d

    def _kv_from_dict(self, d: Optional[dict]) -> Optional[KV]:
        if d is None:
            return None
        return KV(d["k"], d["v"], d["c"], d["m"],
                  self._exp_from_wall(d.get("e")))

    def compact(self) -> None:
        """Force a snapshot + WAL truncation. Takes every shard lock
        ascending, then the rev lock — the canonical order."""
        sids = list(range(self.shards))
        self._acquire(sids)
        try:
            with self._rev_lock:
                self._compact_all_locked()
                self._compact_pending = False
        finally:
            self._release(sids)

    def _compact_all_locked(self) -> None:
        """Caller holds every shard lock + the rev lock. The snapshot is
        the merged global state — key-ascending kvs, revision-ordered
        history — so it is byte-compatible with DurableStore's."""
        snap = {
            "index": self._index,
            "kvs": [self._kv_dict(kv) for kv in heapq.merge(
                *([sh.data[k] for k in sh.keys] for sh in self._shards),
                key=lambda kv: kv.key)],
            "history": [
                {"a": ev.action, "k": ev.key, "i": ev.index,
                 "kv": self._kv_dict(ev.kv), "pv": self._kv_dict(ev.prev_kv)}
                for ev in heapq.merge(
                    *(sh.history for sh in self._shards),
                    key=lambda e: e.index)
            ],
        }
        tmp = os.path.join(self._dir, _SNAP + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, _SNAP))
        self._wal_f.close()
        self._wal_f = open(os.path.join(self._dir, _WAL), "w",
                           encoding="utf-8")
        self._wal_records = 0
        self._wal_bytes = 0
        self._wmx.compactions.inc()
        self._wmx.wal_size.set(0)
        self._wmx.snapshot_size.set(
            os.path.getsize(os.path.join(self._dir, _SNAP)))

    # -- recovery -----------------------------------------------------------
    def _apply_entry(self, d: dict) -> None:
        """Recovery-time replay of one WAL/txn entry into its shard
        (constructor context: single-threaded, no locks)."""
        idx = d["i"]
        key = d["k"]
        action = d["a"]
        sh = self._shard_of(key)
        prev = sh.data.get(key)
        if action in ("delete", "expire"):
            if prev is not None:
                self._remove_key_shard_locked(sh, key)
                del sh.data[key]
            kv = None
        else:
            kv = KV(key, d.get("v", ""), d.get("c", idx), idx,
                    self._exp_from_wall(d.get("e")))
            self._insert_key_shard_locked(sh, key)
            sh.data[key] = kv
            if kv.expiration is not None:
                heapq.heappush(sh.ttl_heap, (kv.expiration, key))
        self._index = max(self._index, idx)
        sh.history.append(StoreEvent(action, key, idx, kv, prev))
        if len(sh.history) > self.HISTORY_WINDOW:
            drop = len(sh.history) - self.HISTORY_WINDOW
            sh.evicted_through = sh.history[drop - 1].index
            del sh.history[:drop]

    def _replay_record(self, d: dict) -> int:
        if "txn" in d:
            ops = 0
            for e in d["txn"]:
                if e["i"] <= self._snap_index_guard:
                    continue  # pre-snapshot entry (crash mid-compact)
                self._apply_entry(e)
                ops += 1
            return ops
        if d["i"] <= self._snap_index_guard:
            return 0
        self._apply_entry(d)
        return 1

    def _recover(self) -> None:
        t0 = time.perf_counter()
        self._snap_index_guard = 0
        self._recovered_records = 0
        recovered_ops = 0
        snapshot_age_s = 0.0
        torn_bytes = 0
        snap_path = os.path.join(self._dir, _SNAP)
        if os.path.exists(snap_path):
            snapshot_age_s = max(0.0, self._wall()
                                 - os.path.getmtime(snap_path))
            self._wmx.snapshot_size.set(os.path.getsize(snap_path))
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            self._index = max(1, snap["index"])
            self._snap_index_guard = snap["index"]
            for d in snap["kvs"]:
                kv = self._kv_from_dict(d)
                sh = self._shard_of(kv.key)
                self._insert_key_shard_locked(sh, kv.key)
                sh.data[kv.key] = kv
                if kv.expiration is not None:
                    heapq.heappush(sh.ttl_heap, (kv.expiration, kv.key))
            hist = snap.get("history", [])
            for d in hist:
                sh = self._shard_of(d["k"])
                sh.history.append(StoreEvent(
                    d["a"], d["k"], d["i"],
                    self._kv_from_dict(d.get("kv")),
                    self._kv_from_dict(d.get("pv"))))
            # staleness floor: events below the snapshot's retained
            # window are gone for EVERY shard, whichever ring they
            # would have lived in — resume tokens below it must 410
            self._replay_floor = (hist[0]["i"] - 1) if hist \
                else snap["index"]
        wal_path = os.path.join(self._dir, _WAL)
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                data = f.read()
            good_end = 0
            bad_at = None
            pos = 0
            for raw in data.splitlines(keepends=True):
                line = raw.strip()
                pos += len(raw)
                if not line:
                    good_end = pos
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    bad_at = pos - len(raw)
                    break  # torn/corrupt record: stop at the last good one
                good_end = pos
                self._recovered_records += 1
                recovered_ops += self._replay_record(d)
            if bad_at is not None:
                discarded = len(data) - good_end
                torn_bytes = discarded
                tail = data[good_end:]
                midfile = any(_parses(l) for l in tail.splitlines()[1:])
                _log.error(
                    "WAL %s: unparseable record at byte %d; discarding %d "
                    "trailing bytes (%s) and truncating to last good record",
                    wal_path, bad_at, discarded,
                    "MID-FILE CORRUPTION — parseable records were lost"
                    if midfile else "torn tail from a crash")
                with open(wal_path, "r+b") as f:
                    f.truncate(good_end)
        recovery_s = time.perf_counter() - t0
        self.recovery = {
            "replayed_records": self._recovered_records,
            "replayed_ops": recovered_ops,
            "snapshot": os.path.exists(snap_path),
            "snapshot_age_s": round(snapshot_age_s, 3),
            "torn_bytes": torn_bytes,
            "recovery_s": round(recovery_s, 4),
            "index": self._index,
            "shards": self.shards,
        }
        self._wmx.recovery_s.observe(recovery_s)
        self._wmx.replayed.set(self._recovered_records)
        self._wmx.snapshot_age.set(snapshot_age_s)
        if torn_bytes:
            self._wmx.torn_bytes.inc(by=torn_bytes)
