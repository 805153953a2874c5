"""Ahead-of-time shape-bucket prewarm (kube-slipstream).

Port of ``kubernetes_tpu/solver/prewarm.py``: ``pow2_ladder`` and the
``PrewarmController`` whole. The reference compiles one XLA program per
pow-2 shape bucket and moves that compile off the wave loop. The port has
no per-shape compile: what "compiling" a bucket means here is building
the kernel library (once per source hash, ``ops/build.py``) and the first
launch of each instance the bucket needs. The controller keeps the
reference's buckets all the same; a bucket only decides which exemplar
wave gets launched early.

- **fill trigger**: every solve reports its true axis occupancy against
  the pow-2 bucket it falls in (``observe``); when an axis reaches
  ``fill_fraction`` of its bucket, the next bucket's target shape is
  queued and the background thread runs it through ``compile_fn`` (the
  daemon launches its latest exemplar wave at the exemplar's own shape,
  once per kernel instance: the bucket is a key, never a padding target);
- **boot set**: ``boot_set(targets)`` seeds the queue with the buckets
  implied by the declared cluster size (``--prewarm`` on
  cmd/solverd), and the ``compile_prewarm_ready`` gauge flips to 1 when
  it drains: the readiness signal load windows gate on.

Thread model: ``observe``/``submit`` are cheap and thread-safe; one
daemon thread runs ``compile_fn`` serially. A failed target is logged,
counted and never retried, and the thread lives on.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional, Sequence

from kubernetes_tpu_torch.util import metrics

__all__ = ["PrewarmController", "pow2_ladder"]

_log = logging.getLogger("kubernetes_tpu_torch.solver.prewarm")


def pow2_ladder(top: int, floor: int = 64) -> list:
    """Descending pow-2 bucket ladder from the bucket containing ``top``
    down to ``floor`` — the boot set for an axis whose live value ramps
    up through every bucket (the churn harness's pod axis)."""
    if top <= 0:
        return []
    b = 1
    while b < top:
        b <<= 1
    out = []
    while b >= max(1, floor):
        out.append(b)
        b >>= 1
    return out


class PrewarmController:
    """Queue + background thread over opaque shape targets.

    ``compile_fn(target)`` receives one target dict (axis letter ->
    length, e.g. ``{"N": 65536, "P": 1024, ...}``; solverd adds a
    ``"BATCH"`` key for the batch axis: waves in one launch) and must
    build and launch the corresponding work and read it back. Targets
    are deduplicated for the controller's lifetime — a bucket runs at
    most once.
    """

    def __init__(self, compile_fn, *, fill_fraction: float = 0.75,
                 name: str = "prewarm"):
        if not (0.0 < fill_fraction <= 1.0):
            raise ValueError(f"fill_fraction {fill_fraction} not in (0, 1]")
        self._compile = compile_fn
        self.fill_fraction = fill_fraction
        self.name = name
        self._sx = metrics.slipstream_metrics()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._queue: deque = deque()  # ktpu-vet: ok thread-discipline — lifetime-deduplicated (each pow-2 bucket queued at most once, _done/_queued guard), so the queue is bounded by the distinct-bucket count
        self._queued: set = set()      # keys queued or compiling
        self._done: set = set()        # keys compiled (or failed — no retry)
        self._boot: set = set()        # boot keys not yet compiled
        self._boot_armed = False
        self._thread: Optional[threading.Thread] = None
        # plain counters for tests/introspection (metrics are the
        # cross-process surface)
        self.compiled = 0
        self.errors = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "PrewarmController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=f"{self.name}-compile")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    # -- intake -------------------------------------------------------------
    @staticmethod
    def _key(target: Dict[str, int]) -> tuple:
        return tuple(sorted(target.items()))

    def submit(self, target: Dict[str, int], boot: bool = False) -> bool:
        """Queue one target unless it was already queued or compiled.
        Returns True when newly queued."""
        key = self._key(target)
        with self._lock:
            if key in self._done:
                return False
            if boot:
                self._boot.add(key)
            if key in self._queued:
                self._refresh_gauges()
                return False
            self._queued.add(key)
            self._queue.append(dict(target))
            self._refresh_gauges()
        self._wake.set()
        return True

    def boot_set(self, targets: Iterable[Dict[str, int]]) -> int:
        """Arm the readiness gate over ``targets`` (the --prewarm boot
        set). ``compile_prewarm_ready`` goes 0 until every one compiled;
        an empty/already-compiled set reports ready immediately."""
        n = 0
        with self._lock:
            self._boot_armed = True
        for t in targets:
            if self.submit(t, boot=True):
                n += 1
        with self._lock:
            self._refresh_gauges()
        return n

    def observe(self, actual: Dict[str, int], bucket: Dict[str, int],
                frozen: Sequence[str] = ()) -> None:
        """Hot-path fill check: for every axis whose true occupancy
        ``actual[k]`` reached ``fill_fraction`` of its current bucket,
        queue the single-axis-advanced next bucket. Axes absent from
        ``actual`` or listed in ``frozen`` never trigger."""
        f = self.fill_fraction
        for k, cur in bucket.items():
            if k in frozen or k == "N1":
                continue
            cur = int(cur)
            a = actual.get(k)
            if cur <= 0 or a is None or int(a) < f * cur:
                continue
            nxt = {ax: int(v) for ax, v in bucket.items()}
            nxt[k] = cur * 2
            if "N1" in nxt:
                nxt["N1"] = nxt["N"] + 1
            self.submit(nxt)

    # -- state --------------------------------------------------------------
    def ready(self) -> bool:
        with self._lock:
            return self._boot_armed and not self._boot

    def pending(self) -> int:
        with self._lock:
            return len(self._queued)

    def _refresh_gauges(self) -> None:
        # caller holds self._lock
        self._sx.prewarm_pending.set(len(self._queued))
        if self._boot_armed:
            self._sx.prewarm_ready.set(0 if self._boot else 1)

    # -- compile thread -----------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                target = self._queue.popleft() if self._queue else None
            if target is None:
                self._wake.wait(0.25)
                self._wake.clear()
                continue
            t0 = time.perf_counter()
            ok = True
            try:
                self._compile(target)
            except Exception:  # noqa: BLE001 — a failed prewarm must
                # never take the thread down; the live wave path builds
                # and launches on demand as it would have without prewarm
                ok = False
                self.errors += 1
                _log.exception("%s: bucket compile failed for %s",
                               self.name, target)
            dt = time.perf_counter() - t0
            key = self._key(target)
            with self._lock:
                self._queued.discard(key)
                self._done.add(key)  # no retry loop either way
                self._boot.discard(key)
                self._refresh_gauges()
            if ok:
                self.compiled += 1
                self._sx.prewarm_total.inc()
                self._sx.prewarm_s.observe(dt)
                _log.info("%s: compiled bucket %s in %.2fs", self.name,
                          {k: v for k, v in sorted(target.items())}, dt)
