"""/debug/pprof — per-binary profiling endpoints.

Port of ``kubernetes_tpu/util/pprof.py``. ref: pkg/master/master.go:431-435
and plugin/cmd/kube-scheduler/app/server.go:82-90 expose Go's
net/http/pprof on every binary. The Python analogs served here:

- ``/debug/pprof/``         index
- ``/debug/pprof/goroutine`` (alias ``stack``): every live thread's stack
- ``/debug/pprof/profile?seconds=N``: statistical CPU profile — samples
  all threads' frames via sys._current_frames() at ~100Hz for N seconds
  and renders a flat self+cumulative report (the text form of a pprof
  CPU profile)
- ``/debug/pprof/heap``: tracemalloc top allocation sites (tracing starts
  on first request, so the first snapshot is a baseline)

All return plain text; the scheduler binary's debug server mounts them.
``heap_profile`` starts ``tracemalloc`` and nothing here stops it, as in
the reference: a caller that must not leave tracing on (a test) stops it
itself.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
import tracemalloc
from typing import Dict, Tuple

__all__ = ["dump_stacks", "cpu_profile", "heap_profile", "index", "handle"]


_profile_slot = None  # created lazily; one sampler at a time process-wide


def handle(which: str, seconds_arg: str = "",
           format_arg: str = "") -> "str | None":
    """Shared endpoint dispatch for every binary's /debug/pprof mount.
    Returns the response text, or None for an unknown endpoint. At most
    one CPU profile runs at a time — stacked 100Hz all-thread samplers
    under the GIL would degrade the very loops being profiled.
    ``format_arg`` applies to the CPU profile: '' (flat text report) or
    'collapsed' (folded stacks, one ``frame;frame;frame count`` line per
    distinct stack — pipe straight into flamegraph.pl / speedscope)."""
    global _profile_slot
    if which in ("", "index"):
        return index()
    if which in ("goroutine", "stack"):
        return dump_stacks()
    if which == "profile":
        try:
            seconds = float(seconds_arg or "5")
        except ValueError:
            seconds = 5.0
        if _profile_slot is None:
            _profile_slot = threading.Semaphore(1)
        if not _profile_slot.acquire(blocking=False):
            return "a profile is already in progress; retry later\n"
        try:
            return cpu_profile(seconds, fmt=format_arg)
        finally:
            _profile_slot.release()
    if which == "heap":
        return heap_profile()
    return None


def index() -> str:
    return ("/debug/pprof/\n"
            "  goroutine  — live thread stacks\n"
            "  profile    — CPU profile (?seconds=N, default 5; "
            "&format=collapsed for flamegraph folded stacks)\n"
            "  heap       — top allocation sites (tracemalloc)\n")


def dump_stacks() -> str:
    """Every live thread's stack (the goroutine-dump analog)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"thread {names.get(ident, '?')} ({ident}):")
        out.extend(l.rstrip("\n")
                   for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def cpu_profile(seconds: float = 5.0, hz: int = 100, fmt: str = "") -> str:
    """Statistical whole-process CPU profile: sample every thread's stack
    for ``seconds`` and report where time is spent. Self = frames on top,
    cumulative = frames anywhere on a sampled stack.

    ``fmt='collapsed'`` emits Brendan Gregg folded stacks instead of the
    flat report: one ``root;...;leaf count`` line per distinct sampled
    stack (root first), the input format of flamegraph.pl, speedscope,
    and inferno — a profile drops straight into flamegraph tooling with
    no converter. Frames are ``file.py:func`` (semicolons in paths are
    replaced — they would split the frame)."""
    seconds = max(0.1, min(seconds, 60.0))
    interval = 1.0 / hz
    me = threading.get_ident()
    collapsed = fmt == "collapsed"
    self_counts: Dict[Tuple[str, int, str], int] = collections.Counter()
    cum_counts: Dict[Tuple[str, int, str], int] = collections.Counter()
    stack_counts: Dict[Tuple[str, ...], int] = collections.Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            samples += 1
            seen = set()
            top = True
            stack = [] if collapsed else None
            f = frame
            while f is not None:
                key = (f.f_code.co_filename, f.f_lineno, f.f_code.co_name)
                if stack is not None:
                    stack.append(_fold_frame(f))
                if top:
                    self_counts[key] += 1
                    top = False
                if key not in seen:
                    cum_counts[key] += 1
                    seen.add(key)
                f = f.f_back
            if stack is not None:
                stack.reverse()  # folded format reads root -> leaf
                stack_counts[tuple(stack)] += 1
        time.sleep(interval)
    if collapsed:
        return "\n".join(
            ";".join(stack) + f" {count}"
            for stack, count in sorted(stack_counts.items(),
                                       key=lambda kv: -kv[1])) + "\n"
    lines = [f"cpu profile: {samples} samples over {seconds:.1f}s "
             f"({hz}Hz, all threads except profiler)",
             f"{'self':>6} {'cum':>6}  location"]
    ranked = sorted(cum_counts, key=lambda k: (-self_counts[k],
                                               -cum_counts[k]))
    for key in ranked[:40]:
        fn, line, name = key
        lines.append(f"{self_counts[key]:>6} {cum_counts[key]:>6}  "
                     f"{name} ({fn}:{line})")
    return "\n".join(lines) + "\n"


def _fold_frame(f) -> str:
    """One folded-stack frame label: basename:function, sanitized of the
    two characters the folded format reserves (';' splits frames, ' '
    splits the count)."""
    import os
    name = f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
    return name.replace(";", ",").replace(" ", "_")


def heap_profile(top: int = 30) -> str:
    """Top allocation sites. tracemalloc begins on first call — the first
    snapshot is the baseline for later ones."""
    if not tracemalloc.is_tracing():
        tracemalloc.start(10)
        return ("tracemalloc started; this snapshot is the baseline — "
                "request again to see allocations\n")
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")
    cur, peak = tracemalloc.get_traced_memory()
    lines = [f"heap: {cur:,} bytes live, {peak:,} peak since tracing began",
             f"{'bytes':>12} {'count':>8}  location"]
    for s in stats[:top]:
        frame = s.traceback[0]
        lines.append(f"{s.size:>12,} {s.count:>8}  "
                     f"{frame.filename}:{frame.lineno}")
    return "\n".join(lines) + "\n"
