"""One run of one cell: set-up, the measured window of waves, the check
against the plain reference, and the metrics.

A wave is the path a scheduler calls once a burst of pending pods is in
its cache: ``encode_snapshot`` over the base cluster and the burst, then
``batch_solver.solve`` on the device, then ``decisions_to_names``. It is
timed from the hand-over of the burst's pod objects until its names are
back (``solve`` ends in a device-to-host readback). Waves follow each
other in a closed loop of one scheduler; the window is ``seconds`` of
wave time. Making the next burst's objects is the apiserver's and the
watch's work, not the scheduler's: it happens off the clock. The cyclic
collector runs as in any process: its pauses fall where the allocations
put them, inside a wave or while a burst is made.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import manifest
from portbench.generators._cluster import base_cluster, rng_for
from portbench.reference import scheduler as reference

__all__ = ["FORBIDDEN", "Record", "forbidden_modules", "node_indices",
           "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_tpu")
OUT = manifest.HERE / "out"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``kubernetes_tpu_torch`` is not ``kubernetes_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def node_indices(base, names) -> np.ndarray:
    """The program's names as node indices: -1 unplaced, -2 a name that is
    no node of the cluster."""
    return np.array([-1 if n is None else base.node_index.get(n, -2)
                     for n in names], np.int64)


class _GcClock:
    """The cyclic collector's pauses while a wave runs."""

    def __init__(self):
        self.inside = False
        self.paused = 0.0
        self._t = 0.0

    def __call__(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self.inside:
            self.paused += time.perf_counter() - self._t


class Record(dict):
    """What one run saw, handed to every metric reader: ``setup_s``;
    ``waves``, one dict per wave of the window (``wave_s``, ``encode_s``,
    ``solve_s``, ``names_s``, ``gc_s``, ``pods``, ``launches``);
    ``compared``, one dict per wave checked against the reference
    (``index``, ``feasible_pairs``, ``cluster``, ``wave``); and with a
    trace, ``trace`` (portbench.trace.Trace)."""


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[Dict[str, dict]] = None,
             log=print) -> dict:
    """Run cell ``name`` and return its result line (a dict). ``t_start``
    is the process's start on the ``time.perf_counter`` clock.
    ``overrides``: as ``manifest.cell``'s, for tests on the CPU only."""
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    marks = {"imports": time.perf_counter() - t_start}
    cell = manifest.cell(name, overrides)
    config, traffic = cell.config, cell.traffic
    gen = manifest.module("generators", traffic["generator"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    marks["context"] = time.perf_counter() - t_start
    base = base_cluster(config, seed)
    marks["base_cluster"] = time.perf_counter() - t_start
    clock = _GcClock()
    gc.callbacks.append(clock)

    if trace:
        from torch.profiler import record_function as span
    else:
        def span(_name):
            return contextlib.nullcontext()

    def wave(pods):
        """One wave through the program -> (timings, names)."""
        launches = commit_solver.solve_commit.launches
        clock.inside, clock.paused = True, 0.0
        with span("portbench.wave"):
            t0 = time.perf_counter()
            with span("portbench.encode_snapshot"):
                snap = encode_snapshot(base.nodes, base.residents, pods,
                                       base.services)
            t1 = time.perf_counter()
            with span("portbench.solve"):
                chosen, _scores = bs.solve(snap, device=dev)
            t2 = time.perf_counter()
            with span("portbench.decisions_to_names"):
                names = bs.decisions_to_names(snap, chosen)
            t3 = time.perf_counter()
        clock.inside = False
        return {"wave_s": t3 - t0, "encode_s": t1 - t0, "solve_s": t2 - t1,
                "names_s": t3 - t2, "gc_s": clock.paused, "pods": len(pods),
                "launches": commit_solver.solve_commit.launches - launches
                }, names

    # ---- set-up: the base cluster, then one warm wave of this cell's shape
    warm = gen.wave(base, config, traffic, seed, -1)
    marks["warm_burst"] = time.perf_counter() - t_start
    warm_timing, _ = wave(warm.pods)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    marks["warm_wave"] = setup_s

    # ---- the window
    profiler = None
    trace_marks = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
        profiler.__enter__()
        trace_marks["start"] = time.perf_counter() - t0
    reference_calls = commit_solver.solve_commit_reference.calls
    waves: List[dict] = []
    chosen_idx: List[np.ndarray] = []
    spent = off_clock = 0.0
    t_window = time.perf_counter()
    while spent < seconds:
        t0 = time.perf_counter()
        pods = gen.wave(base, config, traffic, seed, len(waves)).pods
        off_clock += time.perf_counter() - t0
        timing, names = wave(pods)
        del pods
        spent += timing["wave_s"]
        waves.append(timing)
        chosen_idx.append(node_indices(base, names))
        del names
    window_wall = time.perf_counter() - t_window
    reference_calls = (commit_solver.solve_commit_reference.calls
                       - reference_calls)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    gc.callbacks.remove(clock)
    rec = Record(setup_s=setup_s, waves=waves, compared=[])
    if profiler is not None:
        from portbench import trace as trace_mod
        t0 = time.perf_counter()
        profiler.__exit__(None, None, None)
        OUT.mkdir(exist_ok=True)
        path = OUT / f"{name}-{seed}.trace.json"
        t1 = time.perf_counter()
        profiler.export_chrome_trace(str(path))
        del profiler
        t2 = time.perf_counter()
        rec["trace"] = trace_mod.read(path)
        trace_marks.update(stop=t1 - t0, export=t2 - t1,
                           read=time.perf_counter() - t2)

    # ---- the check: a sample of the window's waves, drawn from the seed,
    # against the plain reference over the same inputs
    k = min(int(traffic["compare_waves"]), len(waves))
    sample = sorted(rng_for(seed, 2).choice(len(waves), k, replace=False)
                    .tolist())
    t_ref = time.perf_counter()
    mismatched = 0
    for i in sample:
        plain = gen.wave(base, config, traffic, seed, i).plain
        want, feasible = reference.solve(base.plain, plain)
        got = chosen_idx[i]
        mismatched += (int(np.count_nonzero(got != want))
                       if got.shape == want.shape else len(plain.keys))
        rec["compared"].append({"index": i, "feasible_pairs": feasible,
                                "cluster": base.plain, "wave": plain})
    reference_s = time.perf_counter() - t_ref
    checks = {"mismatched_pods": {"value": mismatched, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in manifest.metrics_for(name, trace):
        value = manifest.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # what this process loaded by now, the reference and every metric
    # reader included
    found = forbidden_modules()
    correct = correct and not found
    pods = sum(w["pods"] for w in waves)
    info = {
        "cell": name, "seed": seed, "trace": trace, "waves": len(waves),
        "pods": pods, "wave_s_total": sum(w["wave_s"] for w in waves),
        "launches_per_wave": sorted({w["launches"] for w in waves}),
        "solve_commit_reference_calls": reference_calls,
        "warm_wave_s": warm_timing["wave_s"], "setup_marks_s": marks,
        "window_wall_s": window_wall, "burst_making_s": off_clock,
        "compared_waves": sample, "reference_s": reference_s,
        "trace_s": trace_marks,
        "card": _power_limit() if dev.type == "cuda" else "none",
        "forbidden_modules": found,
    }
    log(f"portbench {info}")
    OUT.mkdir(exist_ok=True)
    (OUT / f"{name}-{seed}.waves.json").write_text(json.dumps(waves))
    result = {
        "correct": bool(correct), "attempted": pods, "failed": mismatched,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": int(memory_peak)},
    }
    if "trace" in rec:
        tr = rec["trace"]
        result["device"]["busy_s"] = sum(tr.busy_s)
        result["device"]["window_s"] = sum(e - s for s, e in tr.waves)
        result["breakdown"] = {
            "device_ops": sorted(tr.device_ops.items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(tr.idle_gaps.items(),
                                key=lambda kv: -kv[1])[:10]}
    if found:
        result["forbidden_modules"] = found
    result["checks"] = checks
    return result
