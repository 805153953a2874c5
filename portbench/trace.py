"""The reduction of a ``torch.profiler`` Chrome trace of a run's window to
what the per-layer metrics and the breakdown read: each wave's span, the
device's activity inside it, the kernels by name, and the device's idle
gaps, each labelled by what the host was doing at its midpoint (the
harness's innermost span, and the innermost torch op if one was
running)."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

__all__ = ["Trace", "read", "kernel_name"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAVE = "portbench.wave"

Span = Tuple[float, float]


class Trace(NamedTuple):
    waves: List[Span]                 # seconds, in wave order
    busy_s: List[float]               # device busy time inside each wave
    kernels: List[Dict[str, float]]   # per wave: kernel name -> seconds
    device_ops: Dict[str, float]      # every device op in waves, by name
    idle_gaps: Dict[str, float]       # idle seconds in waves, by host label


def kernel_name(raw: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    or parameters: ``void kgpu::commit_solve_kernel<int, ...>(...)`` ->
    ``commit_solve_kernel``."""
    name = raw.replace("(anonymous namespace)::", "")
    name = name.split("<")[0].split("(")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def _merge(intervals: List[Span]) -> List[Span]:
    out: List[Span] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class _Spans:
    """Spans of one wave, sorted by start, for the innermost span at a
    moment: of the spans that hold it, the one that starts last (spans
    nest, as the host's calls do)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [sp[0] for sp in self.spans]

    def innermost(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            s, e, name = self.spans[i]
            if e >= t:
                return name
            i -= 1
        return ""


def _by_wave(waves: List[Span], items: list) -> List[list]:
    """``items`` (tuples that start with their span) in a list per wave
    that they overlap."""
    starts = [w[0] for w in waves]
    out: List[list] = [[] for _ in waves]
    for it in items:
        s, e = it[0], it[1]
        i = bisect.bisect_left(starts, e) - 1
        while i >= 0 and waves[i][1] > s:
            out[i].append(it)
            i -= 1
    return out


def read(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    waves: List[Span] = []
    marks: List[Tuple[float, float, str]] = []
    cpu_ops: List[Tuple[float, float, str]] = []
    device: List[Tuple[float, float, str, str]] = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name == WAVE:
            waves.append((s, e))
        elif cat == "user_annotation" and name.startswith("portbench."):
            marks.append((s, e, name[len("portbench."):]))
        elif cat == "cpu_op":
            cpu_ops.append((s, e, name))
        elif cat in DEVICE_CATS:
            device.append((s, e, name, cat))
    waves.sort()
    busy, kernels = [], []
    ops: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    for (ws, we), inside, w_marks, w_ops in zip(
            waves, _by_wave(waves, device), _by_wave(waves, marks),
            _by_wave(waves, cpu_ops)):
        per: Dict[str, float] = defaultdict(float)
        for s, e, name, cat in inside:
            ops[name.split("(")[0][:120]] += e - s
            if cat == "kernel":
                per[kernel_name(name)] += e - s
        kernels.append(dict(per))
        merged = _merge([(max(s, ws), min(e, we)) for s, e, _n, _c in inside])
        busy.append(sum(e - s for s, e in merged))
        w_marks, w_ops = _Spans(w_marks), _Spans(w_ops)
        edges = [ws] + [t for iv in merged for t in iv] + [we]
        for gs, ge in zip(edges[::2], edges[1::2]):
            if ge <= gs:
                continue
            mid = (gs + ge) / 2
            label = w_marks.innermost(mid) or "harness"
            op = w_ops.innermost(mid)
            gaps[f"{label}/{op}" if op else label] += ge - gs
    return Trace(waves, busy, kernels, dict(ops), dict(gaps))
