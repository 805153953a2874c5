"""DurableStore — MemStore persisted by an append-only WAL + snapshots.

Port of ``kubernetes_tpu/storage/durable.py``.

The reference keeps every byte of cluster state in etcd and all components
are stateless resumers (ref: pkg/tools/etcd_helper.go:36-345;
etcd_helper_watch.go:47-57 resourceVersion semantics); MemStore alone is
process-RAM, so killing the apiserver loses the cluster. DurableStore is
the persistence option behind the SAME contract:

- every mutation (create/set/compareAndSwap/delete/expire) funnels through
  ``_record_locked`` — the single choke point — and is appended to
  ``wal.log`` as one JSON line under the store lock, so the WAL order IS
  the index order;
- the batched verbs GROUP-COMMIT (docs/design/ha.md): ``txn_many`` seals
  every op of one atomic evict+bind item into ONE WAL record
  (``{"txn": [op, ...]}``), so a crash can never resurrect half a
  transaction on replay, and the whole call's records land in one
  write+flush(+fsync) — one durability syscall per wave instead of one
  per op; ``compare_and_swap_many`` keeps per-op records but shares the
  single flush;
- ``snapshot.json`` is written atomically (tmp + rename) every
  ``compact_every`` WAL records, then the WAL restarts; a crash between
  the two is safe because replay skips entries at or below the snapshot
  index;
- recovery = load snapshot, replay WAL: the global index, every key's
  created/modified index (the resourceVersion), TTL deadlines (persisted
  as wall-clock, rebased to the store clock on load), and the bounded
  watch-history window all come back — so reflectors resume from their
  pre-crash resourceVersion without relisting, and CAS against a
  pre-crash resourceVersion behaves identically. A torn final record (a
  crash mid-append) is truncated and disclosed, never a crash loop;
- recovery is DISCLOSED, not silent: ``self.recovery`` carries replayed
  record/op counts, snapshot age, torn-tail bytes, and the recovery wall
  time; the same numbers ride the ``store_wal_*`` / ``store_recovery_*``
  metric families (util/metrics.StoreWalMetrics) so kube-store's
  /healthz and the chaos churn record can prove "bounded recovery"
  instead of asserting it;
- durability level: flush-per-group-commit by default (survives process
  kill); ``fsync=True`` for media-crash durability at a syscall per
  group.

Wire-in: ``Master(MasterConfig(store=DurableStore(dir)))`` — nothing else
in the stack knows persistence exists.
"""

from __future__ import annotations

import heapq
import json
import logging
import os
import time
from typing import Callable, List, Optional

from kubernetes_tpu_torch.storage.memstore import KV, MemStore, StoreEvent
from kubernetes_tpu_torch.util import chaos
from kubernetes_tpu_torch.util import metrics as metrics_pkg

__all__ = ["DurableStore"]

_log = logging.getLogger("kubernetes_tpu_torch.storage.durable")


def _parses(line: bytes) -> bool:
    try:
        json.loads(line)
        return True
    except ValueError:
        return False

_SNAP = "snapshot.json"
_WAL = "wal.log"


class DurableStore(MemStore):
    def __init__(self, directory: str,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 fsync: bool = False, compact_every: int = 10_000):
        super().__init__(clock)
        self._dir = directory
        self._wall = wall_clock
        self._fsync = fsync
        self._compact_every = compact_every
        self._wal_records = 0
        self._wal_bytes = 0
        self._wal_f = None  # set after recovery; _record_locked no-ops until
        # group-commit state: None outside a batched verb; a list of op
        # entries for the item being applied while inside one
        self._txn_buf: Optional[List[dict]] = None
        self._txn_lines: List[str] = []
        self._txn_ops = 0
        self._mx = metrics_pkg.store_wal_metrics()
        os.makedirs(directory, exist_ok=True)
        self._recover()
        self._wal_f = open(os.path.join(directory, _WAL), "a",
                           encoding="utf-8")
        self._wal_bytes = os.path.getsize(os.path.join(directory, _WAL))
        self._mx.wal_size.set(self._wal_bytes)
        # carry the replayed record count into the compaction budget (and
        # compact now if the inherited WAL already exceeds it): otherwise a
        # frequently-restarted server never snapshots and the WAL — and
        # recovery time — grow without bound across restart cycles
        self._wal_records = self._recovered_records
        if self._wal_records >= self._compact_every:
            with self._lock:
                self._compact_locked()

    # -- persistence hooks --------------------------------------------------
    def _exp_to_wall(self, exp_mono: Optional[float]) -> Optional[float]:
        if exp_mono is None:
            return None
        return self._wall() + (exp_mono - self._clock())

    def _exp_from_wall(self, exp_wall: Optional[float]) -> Optional[float]:
        if exp_wall is None:
            return None
        return self._clock() + (exp_wall - self._wall())

    def _entry_of(self, ev: StoreEvent) -> dict:
        entry = {"a": ev.action, "k": ev.key, "i": ev.index}
        if ev.kv is not None:
            entry["v"] = ev.kv.value
            entry["c"] = ev.kv.created_index
            if ev.kv.expiration is not None:
                entry["e"] = self._exp_to_wall(ev.kv.expiration)
        return entry

    def _record_locked(self, ev: StoreEvent) -> None:
        super()._record_locked(ev)  # watchers + history first
        if self._wal_f is None:
            return  # replaying recovery
        entry = self._entry_of(ev)
        if self._txn_buf is not None:
            # inside a batched verb: buffer; the boundary seals the item
            # into one record and the commit writes the whole call once
            self._txn_buf.append(entry)
            self._txn_ops += 1
            return
        self._wal_append_locked([json.dumps(entry)], ops=1)

    # -- group commit (the batched-verb hooks) ------------------------------
    def _txn_begin_locked(self) -> None:
        if self._wal_f is None:
            return
        self._txn_buf = []
        self._txn_lines = []
        self._txn_ops = 0

    def _txn_boundary_locked(self) -> None:
        buf = self._txn_buf
        if not buf:
            return  # outside a batch, or the item recorded nothing
        # one line per atomic unit: a single-op unit keeps the serial
        # verbs' record format (replay-compatible with pre-group WALs);
        # a multi-op unit becomes a txn record — all-or-nothing by
        # construction, because a JSON line either parses or is torn
        line = json.dumps(buf[0]) if len(buf) == 1 \
            else json.dumps({"txn": buf})
        self._txn_lines.append(line)
        self._txn_buf = []

    def _txn_commit_locked(self) -> None:
        if self._wal_f is None:
            self._txn_buf = None
            return
        self._txn_boundary_locked()  # seal a dangling unit defensively
        lines, ops = self._txn_lines, self._txn_ops
        self._txn_buf = None
        self._txn_lines = []
        self._txn_ops = 0
        if lines:
            self._wal_append_locked(lines, ops=ops)

    def _wal_append_locked(self, lines: List[str], ops: int) -> None:
        """The ONLY writer of WAL bytes: one write+flush(+fsync) per
        call — per op for the serial verbs, per wave for the batched
        ones. The chaos crash points bracket the physical append so the
        WAL atomicity tests can kill the store exactly where SIGKILL
        would land (before the append: nothing durable; after: every
        sealed record durable — never a fraction of one)."""
        chaos.crash_if_armed("durable.wal_append.pre")
        data = "\n".join(lines) + "\n"
        self._wal_f.write(data)
        self._wal_f.flush()
        if self._fsync:
            os.fsync(self._wal_f.fileno())
            self._mx.fsyncs.inc()
        chaos.crash_if_armed("durable.wal_append.post")
        self._wal_records += len(lines)
        self._wal_bytes += len(data)
        self._mx.records.inc(by=len(lines))
        self._mx.ops.inc(by=ops)
        self._mx.group_commits.inc()
        self._mx.bytes_written.inc(by=len(data))
        self._mx.wal_size.set(self._wal_bytes)
        if self._wal_records >= self._compact_every:
            self._compact_locked()

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

    # -- snapshot / compaction ---------------------------------------------
    def _compact_locked(self) -> None:
        snap = {
            "index": self._index,
            "kvs": [self._kv_dict(self._data[k]) for k in self._keys],
            # the watch window survives restart so reflectors can resume
            # from a pre-crash resourceVersion without relisting; prev_kv
            # is persisted too — delete replay delivers the prior object
            # and set replay needs it to pick ADDED vs MODIFIED
            "history": [
                {"a": ev.action, "k": ev.key, "i": ev.index,
                 "kv": self._kv_dict(ev.kv), "pv": self._kv_dict(ev.prev_kv)}
                for ev in self._history
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
        self._mx.compactions.inc()
        self._mx.wal_size.set(0)
        self._mx.snapshot_size.set(
            os.path.getsize(os.path.join(self._dir, _SNAP)))

    def compact(self) -> None:
        """Force a snapshot + WAL truncation (tests, shutdown hooks)."""
        with self._lock:
            self._compact_locked()

    # -- recovery -----------------------------------------------------------
    def _entry_kv(self, d: dict, modified: int) -> KV:
        return KV(d["k"], d.get("v", ""), d.get("c", modified), modified,
                  self._exp_from_wall(d.get("e")))

    def _apply_entry(self, d: dict) -> None:
        idx = d["i"]
        key = d["k"]
        action = d["a"]
        prev = self._data.get(key)
        if action in ("delete", "expire"):
            if prev is not None:
                self._remove_key_locked(key)
                del self._data[key]
            kv = None
        else:
            kv = self._entry_kv(d, idx)
            self._insert_key_locked(key)
            self._data[key] = kv
            if kv.expiration is not None:
                heapq.heappush(self._ttl_heap, (kv.expiration, key))
        self._index = max(self._index, idx)
        self._history.append(StoreEvent(action, key, idx, kv, prev))
        if len(self._history) > self.HISTORY_WINDOW:
            del self._history[: len(self._history) - self.HISTORY_WINDOW]

    def _replay_record(self, d: dict) -> int:
        """Apply one WAL record (a serial op, or a txn group whose ops
        land all together — the record parsed, so the whole item is
        here). Returns the op count."""
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
            self._mx.snapshot_size.set(os.path.getsize(snap_path))
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
            # clamp to the base-1 floor: a snapshot written by a pre-base-1
            # tree while empty carries index 0, which would reinstate the
            # bootstrap lost-event window (index 0 is the reserved
            # "from now" watch token — see MemStore.__init__)
            self._index = max(1, snap["index"])
            self._snap_index_guard = snap["index"]
            for d in snap["kvs"]:
                kv = KV(d["k"], d["v"], d["c"], d["m"],
                        self._exp_from_wall(d.get("e")))
                self._insert_key_locked(d["k"])
                self._data[d["k"]] = kv
                if kv.expiration is not None:
                    heapq.heappush(self._ttl_heap, (kv.expiration, d["k"]))
            for d in snap.get("history", []):
                self._history.append(StoreEvent(
                    d["a"], d["k"], d["i"],
                    self._kv_from_dict(d.get("kv")),
                    self._kv_from_dict(d.get("pv"))))
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
                    break  # torn/corrupt record: stop replay at the last good one
                good_end = pos
                self._recovered_records += 1
                recovered_ops += self._replay_record(d)
            if bad_at is not None:
                # Truncate to the last good record: reopening in append mode
                # would otherwise weld the next write onto the torn fragment,
                # and the NEXT restart would discard that merged line plus
                # everything after it (silent data loss + index regression).
                discarded = len(data) - good_end
                torn_bytes = discarded
                tail = data[good_end:]
                # a parseable line after the bad one means mid-file corruption,
                # not a crash-torn tail — surface it loudly either way
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
        # the disclosure contract (docs/design/ha.md): what recovery did,
        # visible to /healthz (kube-store, apiserver) and the chaos churn
        # record — a store that silently replayed for 40 s is a wall, not
        # an implementation detail
        self.recovery = {
            "replayed_records": self._recovered_records,
            "replayed_ops": recovered_ops,
            "snapshot": os.path.exists(snap_path),
            "snapshot_age_s": round(snapshot_age_s, 3),
            "torn_bytes": torn_bytes,
            "recovery_s": round(recovery_s, 4),
            "index": self._index,
        }
        self._mx.recovery_s.observe(recovery_s)
        self._mx.replayed.set(self._recovered_records)
        self._mx.snapshot_age.set(snapshot_age_s)
        if torn_bytes:
            self._mx.torn_bytes.inc(by=torn_bytes)
