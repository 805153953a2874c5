"""locksmith — a lock-order sanitizer for the --race rounds.

Port of ``kubernetes_tpu/util/locksmith.py``; ``TrackedRLock`` also
forwards ``_recursion_count``, which Python 3.12's multiprocessing asks.

kube-vet proves what it can statically; lock ORDER it cannot. The
switch-interval race mode (tests/conftest.py, hack/test.sh --race)
makes lock inversions *probable*; locksmith makes them *detectable
without the hang*: when armed, ``threading.Lock()``/``threading.RLock()``
hand out tracked wrappers that record, per thread, the chain of locks
held at every acquisition and fold those chains into one global
lock-order graph. Thread 1 acquiring B while holding A adds the edge
A->B; if thread 2 ever acquires A while holding B, the B->A edge closes
a cycle — a potential deadlock, reported with BOTH acquisition stacks
even if the schedules never actually interleaved into the hang.

Design constraints:

- **instance-level nodes**: graph nodes are live lock instances (keyed
  by identity, named by creation site). A cycle therefore means the
  SAME two locks are taken in both orders — a true potential deadlock,
  never the class-level false positive where disjoint instance pairs
  alias one creation site.
- **edges keep their evidence**: the first time an edge is seen, the
  acquiring thread's stack is captured; a cycle report carries the
  stacks of every edge in the cycle (``both stacks`` for the classic
  two-lock inversion).
- **armed only on demand**: KTPU_RACE=1 arms it when the package is
  imported (``kubernetes_tpu_torch/__init__.py``, so every binary the
  port spawns is probed); an unarmed process keeps stock
  ``threading.Lock`` and pays nothing.
- cross-thread release (a Lock used as a hand-off signal) is tolerated:
  the releasing thread ignores entries it never acquired; the acquiring
  thread's stale entry is dropped the next time it releases that lock.

API: ``arm()`` / ``disarm()`` / ``armed()``, ``reports()`` (cycle
dicts), ``clear()``, ``assert_clean()``, and ``wrap(lock, name=)`` for
explicitly tracking a lock created before arming.
"""

from __future__ import annotations

import threading
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

__all__ = ["arm", "disarm", "armed", "reports", "clear", "forget_named",
           "assert_clean", "wrap", "TrackedLock", "TrackedRLock"]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# all graph state under one REAL (untracked) lock; user locks are never
# acquired while holding it, so locksmith cannot itself deadlock
_state_lock = _REAL_LOCK()
# node key -> {succ key: edge info}; node key = (id(lock), site)
_edges: Dict[Tuple[int, str], Dict[Tuple[int, str], dict]] = {}
_cycles: List[dict] = []
_cycle_sigs: set = set()
_armed = False

_tls = threading.local()


def _held() -> List[dict]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _creation_site() -> str:
    for frame in reversed(traceback.extract_stack(limit=16)):
        if "locksmith" not in frame.filename \
                and "/threading" not in frame.filename:
            return f"{frame.filename}:{frame.lineno}"
    return "<unknown>"


def _trim_stack() -> List[str]:
    out = []
    for frame in traceback.extract_stack(limit=24):
        if "locksmith" in frame.filename:
            continue
        out.append(f"{frame.filename}:{frame.lineno} in {frame.name}")
    return out[-12:]


def _find_path(src: Tuple[int, str], dst: Tuple[int, str]
               ) -> Optional[List[Tuple[int, str]]]:
    """DFS for a path src -> ... -> dst in the edge graph (caller holds
    _state_lock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for succ in _edges.get(node, ()):
            if succ == dst:
                return path + [dst]
            if succ not in seen:
                seen.add(succ)
                stack.append((succ, path + [succ]))
    return None


def _note_acquire(key: Tuple[int, str]) -> None:
    held = _held()
    for ent in held:
        if ent["key"] == key:          # RLock reentry
            ent["depth"] += 1
            return
    prev = held[-1]["key"] if held else None
    held.append({"key": key, "depth": 1})
    if prev is None:
        return
    # one edge per acquisition suffices: the chain ...->prev was edged
    # when prev was acquired, so every cycle still closes on the
    # insertion of its final edge
    with _state_lock:
        _prune_dead()
        succs = _edges.setdefault(prev, {})
        if key in succs:
            succs[key]["count"] += 1
            return
        # new edge prev -> key: capture evidence, then look for a
        # return path key ~> prev, which would close a cycle
        succs[key] = {"count": 1,
                      "thread": threading.current_thread().name,
                      "stack": _trim_stack()}
        back = _find_path(key, prev)
        if back is not None:
            cycle_nodes = [prev] + back        # prev -> key ~> prev
            sig = frozenset(n[1] for n in cycle_nodes)
            if sig not in _cycle_sigs:
                _cycle_sigs.add(sig)
                _cycles.append(_render_cycle(cycle_nodes))


def _render_cycle(nodes: List[Tuple[int, str]]) -> dict:
    edges = []
    for a, b in zip(nodes, nodes[1:]):
        info = _edges.get(a, {}).get(b, {})
        edges.append({"from": a[1], "to": b[1],
                      "thread": info.get("thread", "?"),
                      "stack": info.get("stack", [])})
    return {"locks": [n[1] for n in nodes], "edges": edges}


def _note_release(key: Tuple[int, str]) -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i]["key"] == key:
            held[i]["depth"] -= 1
            if held[i]["depth"] <= 0:
                del held[i]
            return
    # released by a thread that never acquired it (hand-off pattern):
    # nothing to unwind here


# dead-lock keys queued by GC finalizers. A finalizer can run at ANY
# allocation point — including inside a `with _state_lock:` section —
# so it must never take the lock itself: list.append is atomic under
# the GIL, and the keys are pruned under the lock at the next graph
# mutation/read.
_dead: List[Tuple[int, str]] = []


def _forget(key: Tuple[int, str]) -> None:
    _dead.append(key)


def _prune_dead() -> None:
    """Drop edges of GC'd locks (caller holds _state_lock). Pruning
    before every graph use also means a reused id() can never alias a
    dead node."""
    if not _dead:
        return
    while _dead:
        key = _dead.pop()
        _edges.pop(key, None)
        for succs in _edges.values():
            succs.pop(key, None)


class _TrackedBase:
    _factory = staticmethod(_REAL_LOCK)

    def __init__(self, name: str = ""):
        self._inner = self._factory()
        self._site = name or _creation_site()
        self._key = (id(self), self._site)
        weakref.finalize(self, _forget, self._key)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self._key)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self._key)

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib fork hooks (concurrent.futures, logging) reinit locks
        # in the child; held-chain state from other threads died with
        # the fork, so only the inner primitive needs resetting
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._site} inner={self._inner!r}>"


class TrackedLock(_TrackedBase):
    _factory = staticmethod(_REAL_LOCK)


class TrackedRLock(_TrackedBase):
    _factory = staticmethod(_REAL_RLOCK)

    # Condition(RLock()) uses these to fully release across wait() —
    # ALL recursion levels at once, so the held-chain entry must be
    # dropped wholesale and restored at its saved depth
    def _is_owned(self):
        return self._inner._is_owned()

    # multiprocessing.resource_tracker (Python 3.12) asks its RLock how
    # deep the calling thread holds it before it stops the tracker
    def _recursion_count(self):
        return self._inner._recursion_count()

    def _release_save(self):
        state = self._inner._release_save()
        depth = 0
        held = getattr(_tls, "held", None) or []
        for i in range(len(held) - 1, -1, -1):
            if held[i]["key"] == self._key:
                depth = held[i]["depth"]
                del held[i]
                break
        return (state, depth)

    def _acquire_restore(self, state):
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        _note_acquire(self._key)
        if depth > 1:
            held = _held()
            for ent in held:
                if ent["key"] == self._key:
                    ent["depth"] = depth
                    break


def wrap(name: str = "", rlock: bool = False):
    """Explicitly tracked lock regardless of arming (tests, or hot
    spots worth watching in production runs)."""
    return TrackedRLock(name) if rlock else TrackedLock(name)


def arm() -> None:
    """Patch threading.Lock/RLock to hand out tracked wrappers. Locks
    created BEFORE arming stay stock (best effort by design)."""
    global _armed
    if _armed:
        return
    threading.Lock = TrackedLock        # type: ignore[assignment]
    threading.RLock = TrackedRLock      # type: ignore[assignment]
    _armed = True


def disarm() -> None:
    global _armed
    if not _armed:
        return
    threading.Lock = _REAL_LOCK         # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK       # type: ignore[assignment]
    _armed = False


def armed() -> bool:
    return _armed


def reports() -> List[dict]:
    with _state_lock:
        return list(_cycles)


def edges() -> Dict[Tuple[str, str], int]:
    """Observed (outer site, inner site) -> count, aggregated across
    instances — the measured lock-order table docs/design/invariants.md
    documents (self-edges from multiple instances of one site excluded)."""
    agg: Dict[Tuple[str, str], int] = {}
    with _state_lock:
        _prune_dead()
        for (_, a_site), succs in _edges.items():
            for (_, b_site), info in succs.items():
                if a_site == b_site:
                    continue
                k = (a_site, b_site)
                agg[k] = agg.get(k, 0) + info["count"]
    return agg


def clear() -> None:
    with _state_lock:
        _edges.clear()
        _cycles.clear()
        _cycle_sigs.clear()


def forget_named(*names: str) -> None:
    """Surgically drop graph state touching the named locks.

    For tests that inject an inversion on purpose: ``clear()`` would
    wipe the WHOLE session's order graph — including the
    KTPU_LOCK_EDGES aggregate every suite before this one recorded —
    so the sessionfinish edge dump would only show whatever ran after
    the wipe. This removes only the named locks' nodes, edges, and
    cycle reports.
    """
    doomed = set(names)
    with _state_lock:
        for key in [k for k in _edges if k[1] in doomed]:
            del _edges[key]
        for succs in _edges.values():
            for key in [k for k in succs if k[1] in doomed]:
                del succs[key]
        _cycles[:] = [rep for rep in _cycles
                      if not (set(rep["locks"]) & doomed)]
        for sig in [s for s in _cycle_sigs if s & doomed]:
            _cycle_sigs.discard(sig)


def format_report(rep: dict) -> str:
    lines = [f"lock-order cycle: {' -> '.join(rep['locks'])}"]
    for e in rep["edges"]:
        lines.append(f"  edge {e['from']} -> {e['to']} "
                     f"(thread {e['thread']}):")
        lines.extend(f"    {f}" for f in e["stack"])
    return "\n".join(lines)


def assert_clean() -> None:
    reps = reports()
    if reps:
        raise AssertionError(
            "locksmith found potential deadlocks:\n"
            + "\n".join(format_report(r) for r in reps))
