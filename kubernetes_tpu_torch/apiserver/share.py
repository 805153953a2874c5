"""kube-share: the cross-worker apiserver side channel (shared segment).

Port of ``kubernetes_tpu/apiserver/share.py``.

An SO_REUSEPORT worker fleet (``--apiservers N``) splits two things the
single-worker hot path kept exact by construction:

1. **the encode-once frame cache** — frames are keyed ``(rv, version)``
   and the store's modified_index is globally unique per revision, so a
   frame built by the worker that COMMITTED the write is byte-valid for
   every sibling's watch fan-out. Without sharing, each worker of an
   N-fleet re-encodes every revision it fans out (N× the encode CPU the
   cache exists to avoid).
2. **the fairshed backlog ledger** — ``created - bound`` is exact only
   when one process sees both sides; the kernel load-balances creates
   and binds to DIFFERENT workers, so each worker's local ledger is a
   random share of the truth and the governor / Retry-After hints go
   blind (the former ``--overload`` ⇒ ``--apiservers 1`` restriction).

Both feeds ride ONE mmap-backed file (tmpfs in the harness): a fixed
header, then per-worker blocks of cache-line-aligned monotonic counters
plus a frame ring. The discipline that keeps it lock-free ACROSS
processes:

- **single-writer blocks** — worker *i* writes only block *i*; every
  other worker only reads it. In-process, a ``threading.Lock`` covers
  the handler threads of the owning worker.
- **publish-then-bump** — a ring record's bytes are fully written
  before the head counter moves, and heads/counters are aligned 8-byte
  slots (single-store on every platform this runs on), so a reader
  never observes a half-written record through a bumped head.
- **reader-validates** — heads are monotonic byte counts; a reader
  whose cursor lags by more than the ring size lost records (counted,
  ``apiserver_cache_seed_ring_drops_total``) and re-anchors at the
  head. After copying a batch it re-reads the head: if the writer
  lapped it mid-copy the batch is discarded, not imported.

Frame sharing is an OPTIMISATION feed (a lost record means a sibling
re-encodes once — correctness unaffected); the ledger counters are the
EXACT feed (never ring-buffered, never dropped: cumulative u64s summed
on read). docs/design/apiserver-hotpath.md §cross-worker has the full
design argument.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

__all__ = ["ShareSegment", "SharedLedger", "DEFAULT_RING_BYTES"]

_MAGIC = b"KTPUSHR1"
_HEADER_FMT = "<8sII48x"            # magic, nworkers, ring_bytes -> 64 B
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 64

# per-worker counter block: one cache line of aligned u64 slots
_CTR_CREATED = 0      # pods created (fairshed ledger)
_CTR_BOUND = 1        # pods bound
_CTR_DELETED = 2      # pending deletes (post-clamp, see SharedLedger)
_CTR_HEAD = 3         # frame ring head (monotonic bytes, pads included)
_CTR_PUBLISHED = 4    # frame records published
_CTR_SLOTS = 8
_CTR_BYTES = _CTR_SLOTS * 8

# ring record: total_len(u32) rv_len(u16) ver_len(u16) then rv|ver|json.
# A 0xFFFFFFFF total_len is the wrap pad: skip to the next ring start.
_REC_FMT = "<IHH"
_REC_HEADER = struct.calcsize(_REC_FMT)
_WRAP_PAD = 0xFFFFFFFF

DEFAULT_RING_BYTES = 4 * 1024 * 1024


class ShareSegment:
    """One worker's attachment to the shared segment file. Create once
    (the harness / parent process), attach per worker with that
    worker's index; ``worker_index=-1`` attaches read-only (probes)."""

    def __init__(self, path: str, worker_index: int = -1):
        self.path = path
        self.worker_index = worker_index
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, nworkers, ring_bytes = struct.unpack_from(_HEADER_FMT,
                                                         self._mm, 0)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a kube-share segment")
        self.nworkers = nworkers
        self.ring_bytes = ring_bytes
        if not (-1 <= worker_index < nworkers):
            raise ValueError(f"worker_index {worker_index} out of range "
                             f"(segment has {nworkers} workers)")
        # guards THIS process's writes into its own block; cross-process
        # isolation is structural (single-writer blocks)
        self._wlock = threading.Lock()
        # per-sibling ring cursors (monotonic byte counts)
        self._cursors = [0] * nworkers
        self.ring_drops = 0

    @classmethod
    def create(cls, path: str, nworkers: int,
               ring_bytes: int = DEFAULT_RING_BYTES,
               worker_index: int = -1) -> "ShareSegment":
        """Create (or truncate) the segment file and attach to it."""
        assert nworkers >= 1 and ring_bytes >= 4096
        size = _HEADER_SIZE + nworkers * (_CTR_BYTES + ring_bytes)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, size)
        finally:
            os.close(fd)
        with open(path, "r+b") as f:
            f.write(struct.pack(_HEADER_FMT, _MAGIC, nworkers, ring_bytes))
        return cls(path, worker_index=worker_index)

    # -- layout -----------------------------------------------------------

    def _ctr_off(self, worker: int) -> int:
        return _HEADER_SIZE + worker * (_CTR_BYTES + self.ring_bytes)

    def _ring_off(self, worker: int) -> int:
        return self._ctr_off(worker) + _CTR_BYTES

    def _ctr_get(self, worker: int, slot: int) -> int:
        return struct.unpack_from("<Q", self._mm,
                                  self._ctr_off(worker) + slot * 8)[0]

    def _ctr_set(self, worker: int, slot: int, value: int) -> None:
        struct.pack_into("<Q", self._mm,
                         self._ctr_off(worker) + slot * 8, value)

    def _ctr_add(self, slot: int, n: int = 1) -> None:
        """Bump one of OUR counter slots (single-writer: only the in-
        process lock is needed)."""
        w = self.worker_index
        with self._wlock:
            self._ctr_set(w, slot, self._ctr_get(w, slot) + n)

    def counter_totals(self, slot: int) -> int:
        return sum(self._ctr_get(w, slot) for w in range(self.nworkers))

    def worker_counters(self, worker: int) -> dict:
        """One worker's published counters (harness disclosure)."""
        return {"created": self._ctr_get(worker, _CTR_CREATED),
                "bound": self._ctr_get(worker, _CTR_BOUND),
                "deleted": self._ctr_get(worker, _CTR_DELETED),
                "published": self._ctr_get(worker, _CTR_PUBLISHED)}

    # -- frame ring (publish side) ----------------------------------------

    def publish_frame(self, rv: str, version: str, wire_json: str) -> bool:
        """Publish one seeded encoding into our ring. Returns False if
        the record is too large to ever fit (never published)."""
        if self.worker_index < 0:
            return False
        rv_b = rv.encode("utf-8")
        ver_b = version.encode("utf-8")
        json_b = wire_json.encode("utf-8")
        total = _REC_HEADER + len(rv_b) + len(ver_b) + len(json_b)
        if total > self.ring_bytes // 2:
            return False
        w = self.worker_index
        base = self._ring_off(w)
        with self._wlock:
            head = self._ctr_get(w, _CTR_HEAD)
            pos = head % self.ring_bytes
            room = self.ring_bytes - pos
            if total > room:
                # wrap pad: mark (if a marker fits) and skip to ring start
                if room >= 4:
                    struct.pack_into("<I", self._mm, base + pos, _WRAP_PAD)
                head += room
                pos = 0
            off = base + pos
            struct.pack_into(_REC_FMT, self._mm, off, total,
                             len(rv_b), len(ver_b))
            off += _REC_HEADER
            self._mm[off:off + len(rv_b)] = rv_b
            off += len(rv_b)
            self._mm[off:off + len(ver_b)] = ver_b
            off += len(ver_b)
            self._mm[off:off + len(json_b)] = json_b
            # bump-last: the record is fully resident before readers can
            # see it through the head
            self._ctr_set(w, _CTR_HEAD, head + total)
            self._ctr_set(w, _CTR_PUBLISHED,
                          self._ctr_get(w, _CTR_PUBLISHED) + 1)
        return True

    # -- frame ring (consume side) ----------------------------------------

    def drain_frames(self, limit: int = 4096) \
            -> List[Tuple[str, str, str]]:
        """Import every sibling's new records: ``[(rv, version, json)]``.
        Loss-tolerant by contract — a lapped reader re-anchors and
        counts ``ring_drops`` (the consumer re-encodes those revisions,
        nothing breaks)."""
        out: List[Tuple[str, str, str]] = []
        for w in range(self.nworkers):
            if w == self.worker_index:
                continue
            out.extend(self._drain_one(w, limit))
        return out

    def _drain_one(self, w: int, limit: int) -> List[Tuple[str, str, str]]:
        head = self._ctr_get(w, _CTR_HEAD)
        cur = self._cursors[w]
        if head == cur:
            return []
        if head - cur > self.ring_bytes:
            # lapped before we started: everything between is gone
            self.ring_drops += 1
            cur = head
            self._cursors[w] = cur
            return []
        base = self._ring_off(w)
        batch: List[Tuple[str, str, str]] = []
        while cur < head and len(batch) < limit:
            pos = cur % self.ring_bytes
            room = self.ring_bytes - pos
            if room < _REC_HEADER:
                cur += room
                continue
            total, rv_len, ver_len = struct.unpack_from(_REC_FMT, self._mm,
                                                        base + pos)
            if total == _WRAP_PAD:
                cur += room
                continue
            if total < _REC_HEADER or total > room:
                # torn/lapped read — re-anchor at head
                self.ring_drops += 1
                cur = head
                break
            off = base + pos + _REC_HEADER
            rv = bytes(self._mm[off:off + rv_len])
            off += rv_len
            ver = bytes(self._mm[off:off + ver_len])
            off += ver_len
            json_len = total - _REC_HEADER - rv_len - ver_len
            payload = bytes(self._mm[off:off + json_len])
            cur += total
            batch.append((rv.decode("utf-8", "replace"),
                          ver.decode("utf-8", "replace"),
                          payload.decode("utf-8", "replace")))
        # lap check: if the writer overwrote what we just copied, the
        # bytes above may interleave two records — discard, re-anchor
        if self._ctr_get(w, _CTR_HEAD) - self._cursors[w] > self.ring_bytes:
            self.ring_drops += 1
            self._cursors[w] = self._ctr_get(w, _CTR_HEAD)
            return []
        self._cursors[w] = cur
        return batch

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass


class SharedLedger:
    """The cross-worker fairshed drain feed: exact global
    created/bound/deleted from the segment's per-worker cumulative
    counters, plus a measured GLOBAL bind rate.

    The rate is sampled locally: every query appends ``(now, Σbound)``
    to a trailing-window deque — admission traffic IS the sampler, so
    under the load that makes hints matter the window is dense. The
    delete clamp mirrors the local ledger's availability-safe rule: a
    delete only counts while the global backlog is positive (deleting a
    BOUND pod must not open phantom governor headroom)."""

    _WINDOW_S = 10.0
    _SAMPLES = 2048

    def __init__(self, seg: ShareSegment, clock=None):
        self.seg = seg
        self._clock = clock or time.monotonic
        self._samples: deque = deque(maxlen=self._SAMPLES)
        self._lock = threading.Lock()

    def note_created(self) -> None:
        self.seg._ctr_add(_CTR_CREATED)

    def note_bound(self, n: int) -> None:
        self.seg._ctr_add(_CTR_BOUND, n)
        self._sample()

    def note_deleted(self) -> None:
        if self.backlog() > 0:
            self.seg._ctr_add(_CTR_DELETED)

    def backlog(self) -> int:
        s = self.seg
        return max(0, s.counter_totals(_CTR_CREATED)
                   - s.counter_totals(_CTR_BOUND)
                   - s.counter_totals(_CTR_DELETED))

    def _sample(self) -> None:
        now = self._clock()
        total = self.seg.counter_totals(_CTR_BOUND)
        with self._lock:
            self._samples.append((now, total))

    def bind_rate(self, now: Optional[float] = None) -> float:
        """Global binds/second over the trailing window (0.0 = no
        data). Samples on every call, so admission-time queries keep
        the window fresh without a background thread."""
        self._sample()
        if now is None:
            now = self._clock()
        lo = now - self._WINDOW_S
        with self._lock:
            window = [(t, v) for t, v in self._samples if t >= lo]
        if len(window) < 2:
            return 0.0
        (t0, v0), (t1, v1) = window[0], window[-1]
        if v1 <= v0:
            return 0.0
        return (v1 - v0) / max(1e-3, t1 - t0)
