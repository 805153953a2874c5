"""kube-trace — low-overhead distributed tracing for the control plane.

Port of ``kubernetes_tpu/util/tracing.py``, whole. Each process keeps a
bounded in-memory ring of completed spans; span context propagates
across the process boundaries the port has (the ``X-KTPU-Trace`` HTTP
header of ``client/http.py``), and ``GET /debug/trace`` on the scheduler
binary drains the ring, so shards from several processes merge into one
Chrome-trace-event / Perfetto-loadable JSON file (``chrome_trace``).
The header and the span records have the reference's form, so the JAX
package's apiserver attaches its spans to the port's traces and either
package's ``parse`` reads the other's header.

Design constraints, in order:

1. **Disabled tracing must be free.** Entry points default tracing OFF;
   the scheduler's encode/solve/commit stage loop calls into this module
   per wave, so the off path is one module-global load and a branch
   (``span()`` returns a shared no-op object; nothing is allocated beyond
   the kwargs dict the call site built). ``tests/test_torch_tracing.py``
   guards this at <1% of the stage loop.
2. **Recording never blocks.** The ring is a preallocated slot array
   indexed by an ``itertools.count`` (its ``next`` is one atomic C call
   under the GIL): writers claim a slot index and store one fully-built
   record with a single list assignment — no lock, no resize, no
   back-pressure. When writers outrun the drain the oldest slots are
   overwritten and the loss is COUNTED (``dropped``), never hidden and
   never a stall.
3. **Clocks merge across processes.** Span times are
   ``time.monotonic_ns()``, CLOCK_MONOTONIC on Linux — one clock per
   host, shared by every process — so spans from the apiserver and the
   scheduler land on one comparable axis.
4. **Spans land on the device timeline.** ``torch.profiler``'s trace
   keeps its own clock, which drifts against ``monotonic_ns`` over a
   window, so no offset lays the ring's spans onto it. Instead, while
   tracing is on and the profiler records in this process, every
   ``span()`` also opens a ``record_function`` named ``ktpu.<name>``:
   the profiler stamps it beside the kernels and copies it waits on.
   The ring records the span as before. torch is never imported here;
   a process that has not loaded it has no profiler to mirror into.

Span context is ``(trace_id, span_id)``. Ambient context is a per-thread
stack (``span()`` nests); crossing a thread or process boundary is
explicit: ``current()``/``wire()`` capture the context,
``parent=``/``parse()`` re-attach it. A span with no parent starts a new
trace. Wire form: ``X-KTPU-Trace: <trace_id>-<span_id>`` (request
header; watch streams echo the stream's context back).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["HEADER", "enabled", "enable", "disable", "span", "child_span",
           "start", "record", "current", "new_ctx", "wire", "parse",
           "drain", "loss_peek", "chrome_trace", "NOP", "PROFILER_PREFIX"]

HEADER = "X-KTPU-Trace"
# the name prefix of a span's mirror in torch.profiler's trace
PROFILER_PREFIX = "ktpu."

# module-global fast-path flag: `span()` and friends read this before
# touching any state, so disabled tracing costs one load + one branch
_on = False

_DEFAULT_CAPACITY = 65536


class _Ring:
    """Preallocated slot array; see module docstring point 2. Each slot
    holds ``(seq, record)`` so the drain can tell live entries from
    overwritten history without a writer-side lock."""

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self.slots: List[Optional[tuple]] = [None] * self.cap
        self._seq = itertools.count()
        self._drain_lock = threading.Lock()
        self._drained_through = 0  # seq below which spans were returned

    def put(self, rec: dict) -> None:
        i = next(self._seq)          # atomic claim
        self.slots[i % self.cap] = (i, rec)

    def drain(self, reset: bool = True) -> Tuple[List[dict], int, int]:
        """-> (spans in seq order, written_total, dropped). ``dropped``
        counts spans overwritten before any drain saw them. Concurrent
        writers keep writing; a racing slot may carry a span newer than
        the snapshot — it is simply returned (and not returned again)."""
        with self._drain_lock:
            lo = self._drained_through
            live = [s for s in self.slots if s is not None and s[0] >= lo]
            live.sort(key=lambda s: s[0])
            written = (live[-1][0] + 1) if live else lo
            dropped = (written - lo) - len(live)
            if reset:
                self._drained_through = written
            return [rec for _i, rec in live], written, dropped


class _State:
    __slots__ = ("service", "ring")

    def __init__(self):
        self.service = ""
        # allocated by enable(): a process that never traces (the
        # default everywhere) must not pay for the slot array at import
        self.ring: Optional[_Ring] = None


_state = _State()
_tls = threading.local()
_span_seq = itertools.count(1)
_PID_TAG = ""  # refreshed on enable(): fork-safe span-id uniqueness


def _ctx_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return f"{_PID_TAG}{next(_span_seq):x}"


def enabled() -> bool:
    return _on


def enable(service: str = "", capacity: int = _DEFAULT_CAPACITY) -> None:
    """Turn tracing on for this process. ``service`` names the process
    in merged traces (apiserver / scheduler / ...);
    ``capacity`` bounds the span ring (oldest spans evicted past it)."""
    global _on, _PID_TAG
    _PID_TAG = f"{os.getpid():x}."
    _state.service = service or _state.service
    if _state.ring is None or _state.ring.cap != capacity:
        _state.ring = _Ring(capacity)
    _on = True


def disable() -> None:
    global _on
    _on = False


# -- context ----------------------------------------------------------------

def current() -> Optional[Tuple[str, str]]:
    """The ambient (trace_id, span_id), or None outside any span (or
    with tracing off)."""
    if not _on:
        return None
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def new_ctx() -> Optional[Tuple[str, str]]:
    """A fresh root context for a trace whose spans will be recorded
    from several threads (the pipelined wave loop): no span is recorded
    for the root itself — stages attach to it with ``parent=ctx`` and
    the merged view groups them by trace id."""
    if not _on:
        return None
    return (_new_trace_id(), _new_span_id())


def wire(ctx: Optional[Tuple[str, str]] = None) -> str:
    """``trace_id-span_id`` for the X-KTPU-Trace header ('' when no
    context is active)."""
    c = ctx if ctx is not None else current()
    return f"{c[0]}-{c[1]}" if c else ""


def parse(value) -> Optional[Tuple[str, str]]:
    """Inverse of ``wire``; tolerant of junk (returns None)."""
    if not value or not isinstance(value, str):
        return None
    tid, sep, sid = value.partition("-")
    if not sep or not tid or not sid or len(tid) > 64 or len(sid) > 64:
        return None
    return (tid, sid)


# -- spans ------------------------------------------------------------------

class _NopSpan:
    """Shared do-nothing span: the disabled fast path and the parent of
    no one. Supports the full surface so call sites never branch."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def finish(self, **attrs):
        return None


NOP = _NopSpan()

_AMBIENT = object()  # sentinel: "use the thread's current span as parent"


def _mirror(name: str):
    """An entered ``torch.profiler.record_function`` named
    ``ktpu.<name>`` while torch's profiler records in this process, else
    None (design point 4)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(PROFILER_PREFIX + name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("name", "attrs", "ctx", "psid", "_t0", "_pushed", "_rf")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.attrs = attrs
        if parent is _AMBIENT:
            parent = current()
        if parent:
            tid, psid = parent
        else:
            tid, psid = _new_trace_id(), ""
        self.ctx = (tid, _new_span_id())
        self.psid = psid
        self._t0 = 0
        self._pushed = False
        self._rf = None

    def __enter__(self):
        _ctx_stack().append(self.ctx)
        self._pushed = True
        self._rf = _mirror(self.name)
        self._t0 = time.monotonic_ns()
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def finish(self, **attrs):
        self.attrs.update(attrs)
        self.__exit__(None, None, None)

    def __exit__(self, exc_type, exc, tb):
        end = time.monotonic_ns()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if self._pushed:
            st = _ctx_stack()
            if st and st[-1] == self.ctx:
                st.pop()
            self._pushed = False
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        _emit(self.name, self.ctx, self.psid, self._t0, end, self.attrs)
        return False


def span(name: str, parent=_AMBIENT, **attrs):
    """Context manager for one span. ``parent`` defaults to the thread's
    ambient span; pass an explicit ``(trace_id, span_id)`` (or None for
    a new root) when crossing threads. Free when tracing is off."""
    if not _on:
        return NOP
    return _Span(name, parent, attrs)


def child_span(name: str, **attrs):
    """``span()`` that records ONLY under an active ambient trace: a
    no-op when tracing is off OR when the thread is outside any span.
    For shared internals on both traced and untraced paths (registry
    writes: a traced bind's store leg should appear in the wave's trace,
    but 50k untraced feeder creates must not each open a root trace and
    churn the ring)."""
    if not _on:
        return NOP
    st = getattr(_tls, "stack", None)
    if not st:
        return NOP
    return _Span(name, st[-1], attrs)


def start(name: str, parent=_AMBIENT, **attrs):
    """Manually-finished span for lifetimes that cross threads: returns
    a handle with ``.ctx`` and ``.finish(**attrs)``. Unlike ``span()``
    it does NOT install ambient context (the owner may finish it from
    another thread)."""
    if not _on:
        return NOP
    s = _Span(name, parent, attrs)
    s._t0 = time.monotonic_ns()
    return s


def record(name: str, start_ns: int, end_ns: int, parent=None,
           **attrs) -> None:
    """Retroactive completed span — for sites that know a span's bounds
    only after the fact (the wave loop records its drain and prepare
    legs once the wave's trace context exists)."""
    if not _on:
        return
    if parent is _AMBIENT:
        parent = current()
    if parent:
        tid, psid = parent
    else:
        tid, psid = _new_trace_id(), ""
    _emit(name, (tid, _new_span_id()), psid, start_ns, end_ns, attrs)


def _emit(name, ctx, psid, t0, end, attrs) -> None:
    _state.ring.put({
        "name": name, "tid": ctx[0], "sid": ctx[1], "psid": psid,
        "t0": t0, "dur": max(0, end - t0),
        "thr": threading.current_thread().name,
        "attrs": attrs,
    })


# -- collection -------------------------------------------------------------

def loss_peek() -> Optional[int]:
    """Unread-span loss estimate WITHOUT draining: spans evicted since
    the last drain (the flight recorder samples this once per second as
    the ``tracing_spans_dropped`` gauge feeding the spans-dropped SLO).
    None when tracing was never enabled — the sampler then records no
    series rather than a fake healthy zero."""
    ring = _state.ring
    if ring is None:
        return None
    with ring._drain_lock:
        lo = ring._drained_through
        live = hi = 0
        for s in ring.slots:
            if s is not None and s[0] >= lo:
                live += 1
                if s[0] >= hi:
                    hi = s[0] + 1
        return max(0, (hi - lo) - live)


def drain(reset: bool = True) -> Dict[str, Any]:
    """The ``GET /debug/trace`` payload: this process's span shard.
    Draining resets the ring's read position (each span is returned
    once); ``dropped`` counts spans evicted unread since the previous
    drain."""
    if _state.ring is None:  # tracing never enabled in this process
        spans, written, dropped = [], 0, 0
    else:
        spans, written, dropped = _state.ring.drain(reset=reset)
    return {"service": _state.service or f"pid{os.getpid()}",
            "pid": os.getpid(), "spans": spans,
            "written": written, "dropped": dropped}


def chrome_trace(shards: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge drained shards (one per process) into one Chrome-trace-
    event JSON object (Perfetto's legacy JSON importer loads it as-is:
    ui.perfetto.dev -> Open trace file). Spans become complete events
    ('ph': 'X', microsecond timestamps on the shared monotonic axis);
    process/thread names come from metadata events, and every event
    carries its trace/span ids in ``args`` so a trace id typed into the
    Perfetto search box lights up one pod-wave's causal path across
    every process."""
    events: List[dict] = []
    for shard in shards:
        pid = int(shard.get("pid", 0))
        svc = shard.get("service") or f"pid{pid}"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": svc}})
        tids: Dict[str, int] = {}
        for sp in shard.get("spans", ()):
            thr = sp.get("thr", "")
            tid = tids.get(thr)
            if tid is None:
                tid = tids[thr] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": thr}})
            args = dict(sp.get("attrs") or ())
            args["trace_id"] = sp.get("tid", "")
            args["span_id"] = sp.get("sid", "")
            if sp.get("psid"):
                args["parent_span_id"] = sp["psid"]
            events.append({
                "ph": "X", "cat": "ktpu", "name": sp.get("name", "?"),
                "pid": pid, "tid": tid,
                "ts": sp.get("t0", 0) / 1000.0,
                "dur": max(1, sp.get("dur", 0)) / 1000.0,
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome(shards: Iterable[Dict[str, Any]], path: str) -> str:
    """chrome_trace -> file; returns ``path`` (one file per run)."""
    with open(path, "w") as fh:
        json.dump(chrome_trace(shards), fh)
    return path
