"""Deterministic fault-injection seams for kube-chaos.

Port of ``kubernetes_tpu/util/chaos.py``.

The chaos churn record (CHURN_MP_r14+) proves crash recovery by killing
real processes; tier-1 cannot afford process churn per test, so every
failure mode the harness exercises end-to-end also has an in-process
seam here:

- **crash points** (``inject_crash`` / ``crash_if_armed``): a named
  point in production code raises ``SimulatedCrash`` on its Nth hit —
  the WAL atomicity test crashes the store between physical WAL appends
  exactly where SIGKILL would land;
- **injected errors** (``inject_error`` / ``error_if_armed``): a named
  point raises a scripted exception (the ``MemStore.inject_error``
  idiom, generalized to non-store seams like the StoreServer
  connection loop);
- **injected delays** (``inject_delay`` / ``delay_if_armed``): a named
  point sleeps — delayed responses without a slow dependency;
- **connection resets** (``inject_flag`` / ``take_flag``): a named
  point observes a one-shot flag — the StoreServer drops the
  connection mid-stream, the client sees exactly what a killed server
  produces.

Discipline (the kube-trace/flightrec pattern): a process that never
arms anything pays ONE module-global truthiness check per seam; arming
is test-only and cleared with ``clear()``. Injection is deterministic —
no randomness, no wall-clock: a point fires on exact hit counts, so a
failing chaos test replays bit-identically.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, Optional

__all__ = ["SimulatedCrash", "inject_crash", "inject_error",
           "inject_delay", "inject_flag", "inject_gate", "release_gate",
           "crash_if_armed", "error_if_armed", "delay_if_armed",
           "take_flag", "gate_if_armed", "armed", "clear",
           "parse_duration"]


_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(us|ms|s|m)?\s*$")
_DURATION_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, None: 1.0}


def parse_duration(text: str) -> float:
    """``'250ms'`` -> 0.25, ``'1.5s'`` -> 1.5, ``'2m'`` -> 120.0; a bare
    number means seconds. The latency half of the chaos grammar
    (``apiserver@120s:delay=250ms`` — hack/churn_mp.parse_chaos) and
    the in-process delay seams share this vocabulary so a live
    gray-slowness schedule and its tier-1 twin read identically."""
    m = _DURATION_RE.match(text or "")
    if m is None:
        raise ValueError(f"bad duration {text!r}: expected "
                         "NUMBER[us|ms|s|m]")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


class SimulatedCrash(Exception):
    """Raised by an armed crash point — the in-process stand-in for
    SIGKILL. Production code never catches it (it must unwind like the
    process death it simulates); tests catch it and then reopen state
    from disk the way a respawned process would."""


class _Arm:
    __slots__ = ("kind", "skip", "times", "payload", "hits")

    def __init__(self, kind: str, skip: int, times: int, payload=None):
        self.kind = kind
        self.skip = skip        # hits to let pass before acting
        self.times = times      # actions remaining once past skip
        self.payload = payload  # exception instance / delay seconds
        self.hits = 0           # total observed hits (test assertions)


_lock = threading.Lock()
_arms: Dict[str, _Arm] = {}


def _arm(point: str, kind: str, skip: int, times: int, payload=None) -> None:
    with _lock:
        _arms[point] = _Arm(kind, skip, times, payload)


def inject_crash(point: str, skip: int = 0, times: int = 1) -> None:
    """Arm ``point`` to raise SimulatedCrash on hit ``skip+1`` (and the
    next ``times-1`` hits after it)."""
    _arm(point, "crash", skip, times)


def inject_error(point: str, exc: Exception, skip: int = 0,
                 times: int = 1) -> None:
    _arm(point, "error", skip, times, payload=exc)


def inject_delay(point: str, seconds: float, skip: int = 0,
                 times: int = 1) -> None:
    _arm(point, "delay", skip, times, payload=seconds)


def inject_flag(point: str, skip: int = 0, times: int = 1) -> None:
    """Arm a one-shot (or N-shot) boolean the seam polls with
    ``take_flag`` — connection-reset style actions the seam itself
    performs (close a socket, drop a frame)."""
    _arm(point, "flag", skip, times)


def inject_gate(point: str) -> None:
    """Arm ``point`` as a blocking gate: the next thread reaching it
    parks until ``release_gate(point)`` (or ``clear()``) — the
    deterministic replacement for "hope the reader is slow enough". A
    gated watch writer, for example, stops draining its fan-out queue so
    the producer-side lag machinery (coalesce / drop-to-resync) fires on
    exact queue depth instead of on kernel socket-buffer luck."""
    _arm(point, "gate", 0, 1, payload=threading.Event())


def release_gate(point: str) -> None:
    """Open an armed gate; no-op if nothing (or a non-gate) is armed."""
    with _lock:
        a = _arms.pop(point, None)
    if a is not None and a.kind == "gate":
        a.payload.set()


def _take(point: str, kind: str) -> Optional[_Arm]:
    """Consume one action at ``point`` if an arm of ``kind`` is due."""
    with _lock:
        a = _arms.get(point)
        if a is None or a.kind != kind:
            return None
        a.hits += 1
        if a.skip > 0:
            a.skip -= 1
            return None
        if a.times <= 0:
            return None
        a.times -= 1
        if a.times <= 0 and a.kind != "crash":
            # crash arms stay (a respawned test instance re-hitting the
            # point without re-arming would mask a missed crash); others
            # self-clear once spent
            del _arms[point]
        return a


def crash_if_armed(point: str) -> None:
    if not _arms:
        return
    if _take(point, "crash") is not None:
        raise SimulatedCrash(point)


def error_if_armed(point: str) -> None:
    if not _arms:
        return
    a = _take(point, "error")
    if a is not None:
        raise a.payload


def delay_if_armed(point: str) -> None:
    if not _arms:
        return
    a = _take(point, "delay")
    if a is not None:
        time.sleep(a.payload)


def take_flag(point: str) -> bool:
    if not _arms:
        return False
    return _take(point, "flag") is not None


def gate_if_armed(point: str, timeout: float = 30.0) -> None:
    """Park on an armed gate until released. The wait happens outside
    the registry lock (release/clear must be able to run), with a safety
    timeout so a test that forgets to release cannot hang a suite."""
    if not _arms:
        return
    with _lock:
        a = _arms.get(point)
        if a is None or a.kind != "gate":
            return
        a.hits += 1
        ev = a.payload
    ev.wait(timeout)


def armed(point: str) -> Optional[dict]:
    """Introspection for tests: {'kind', 'skip', 'times', 'hits'} or
    None."""
    with _lock:
        a = _arms.get(point)
        if a is None:
            return None
        return {"kind": a.kind, "skip": a.skip, "times": a.times,
                "hits": a.hits}


def clear() -> None:
    with _lock:
        for a in _arms.values():
            if a.kind == "gate":
                a.payload.set()  # wake parked seams before forgetting them
        _arms.clear()
