#!/usr/bin/env python3
"""Time the scheduler's two wave loops on a north_star cluster: the
causal and the pipelined ``BatchScheduler``, in alternating turns.

Each run builds a fresh FakeClient cluster (``fixtures.build_cluster``:
5,000 nodes, 2 bound pods each, 8 services, ``--pending`` pods synced
before the loop starts), drives it through ``run()`` until every pod is
bound, and records pods/s, the ``scheduler_pipeline_*`` deltas, each
solve's launches and the per-stage medians of the waves' tracing spans
(``drive``, which chip_smoke.py phase 7p calls too). ``--pairs N`` runs
N pairs in the order causal, pipelined, pipelined, causal, ... (each
loop runs first in half the pairs), fails unless every run placed every
pod as the first run did, and prints one JSON line: each run's pods/s,
each loop's median and quartiles, the ratio of the medians, how many
pairs the pipelined loop won, and the card's name and power limit; the
record also goes to ``chiprun_out/loop_time.json``.

    PYTHONPATH=. python3 kubernetes_tpu_torch/tools/loop_time.py --pairs 10

Needs one CUDA card and nvcc; ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from kubernetes_tpu_torch.api.quantity import Quantity
from kubernetes_tpu_torch.models.fixtures import build_cluster
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.runtime.clone import deep_clone
from kubernetes_tpu_torch.scheduler import tpu_batch
from kubernetes_tpu_torch.scheduler.driver import ConfigFactory
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from kubernetes_tpu_torch.util import tracing


def stage_medians(spans) -> dict:
    """Median seconds of each wave stage's spans (wave.encode, .solve,
    .commit; speculative encodes included) and how many there were."""
    out: dict = {}
    for stage in ("encode", "solve", "commit"):
        durs = [s["dur"] / 1e9 for s in spans if s["name"] == f"wave.{stage}"]
        out[stage] = {"n": len(durs), "median_s": (statistics.median(durs)
                                                   if durs else None)}
    out["speculative_encodes"] = sum(
        1 for s in spans if s["name"] == "wave.encode"
        and s["attrs"].get("speculative"))
    return out


def drive(dev, pipeline: bool, inject: bool = False, n_nodes: int = 5_000,
          n_pending: int = 10_000, wave_size: int = 1_024) -> dict:
    """One drive of a fresh north_star cluster behind a FakeClient by the
    loop thread (``run()``), causal or pipelined, optionally with one
    foreign bind landing in the scheduled store during the first solve (as
    tests/test_pipeline.py injects it). Every wave is traced; each solve's
    launches are counted around it, and each solve whose decisions the
    loop consumed is marked, so a discarded speculative solve shows.
    Returns the run's record, the final placements included."""
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    fc = FakeCluster(nodes, existing, pending, services)
    factory = ConfigFactory(fc.client, node_poll_period=3600)
    fc.attach(factory)
    pm = tpu_batch._pipeline_metrics()
    # per solve: [launches, consumed, its decisions until consumed]
    solves: list = []
    injected: list = []
    sched = None
    try:
        sched = tpu_batch.BatchScheduler(
            factory.create(pipeline=pipeline), factory, fc.client,
            wave_size=wave_size, wave_linger_s=0.02, device=dev)
        solve_snap, split = sched._solve_snap, sched._split_decisions

        def _solve_snap(snap, n, tctx=None):
            if inject and not injected:
                foreign = deep_clone(existing[0])
                foreign.metadata.name = foreign.metadata.uid = "foreign-0"
                foreign.spec.containers[0].resources.limits["cpu"] = \
                    Quantity("8")
                injected.append(foreign)
                factory.scheduled_pods.add(foreign)
            l0 = commit_solver.solve_commit.launches
            d = solve_snap(snap, n, tctx)
            solves.append([commit_solver.solve_commit.launches - l0, False,
                           d])
            return d

        def _split_decisions(pending_, decisions):
            for row in solves:
                if row[2] is decisions:
                    row[1:] = [True, None]
            return split(pending_, decisions)

        sched._solve_snap, sched._split_decisions = _solve_snap, \
            _split_decisions
        fc.wait_synced()
        m0 = {"waves": pm.waves.value(), "hits": pm.hits.value(),
              "inval": pm.invalidations.by_label(),
              "overlap": pm.overlap.value(),
              "unspec": pm.unspeculated.value()}
        tracing.enable("loop_time")
        tracing.drain()
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t0 = time.perf_counter()
        sched.run()
        deadline = time.monotonic() + 300
        while len(fc.bind_log) < n_pending:
            if time.monotonic() > deadline or sched.fault is not None:
                raise AssertionError(f"loop: {len(fc.bind_log)} of "
                                     f"{n_pending} bound "
                                     f"(fault {sched.fault!r})")
            time.sleep(0.002)
        loop_s = time.perf_counter() - t0
        if not sched.stop(timeout=60):
            raise AssertionError("loop: the loop thread did not stop")
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        spans = tracing.drain()["spans"]
    finally:
        tracing.disable()
        if sched is not None:
            sched.stop(timeout=60)
        if not factory.stop(join=True, timeout=5.0):
            raise AssertionError("the factory's threads did not stop")
    inval = {k[0]: v - m0["inval"].get(k, 0.0)
             for k, v in pm.invalidations.by_label().items()
             if v - m0["inval"].get(k, 0.0)}
    consumed = sum(1 for s in solves if s[1])
    return {
        "pipeline": pipeline, "inject": inject, "loop_s": loop_s,
        "pods_per_s": n_pending / loop_s,
        "placements": {p.metadata.name: p.spec.host for p in fc.bind_log},
        "bound": len(fc.bind_log), "solves": len(solves),
        "consumed": consumed, "discarded": len(solves) - consumed,
        "launches_per_solve": sorted({s[0] for s in solves}),
        "launches": launches, "plain_calls": plain_calls,
        "pipeline_waves": pm.waves.value() - m0["waves"],
        "hits": pm.hits.value() - m0["hits"], "invalidations": inval,
        "unspeculated": pm.unspeculated.value() - m0["unspec"],
        "overlap_s": pm.overlap.value() - m0["overlap"],
        "stages": stage_medians(spans), "injected": len(injected),
    }


def _quartiles(xs) -> list:
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else list(xs) * 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--pending", type=int, default=10_000)
    ap.add_argument("--wave-size", type=int, default=1_024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("loop_time: no CUDA device", file=sys.stderr)
        return 2
    runs, first = [], None
    for k in range(args.pairs):
        for pipeline in ((False, True) if k % 2 == 0 else (True, False)):
            r = drive(args.device, pipeline, n_nodes=args.nodes,
                      n_pending=args.pending, wave_size=args.wave_size)
            placements = r.pop("placements")
            if first is None:
                first = placements
            elif placements != first:
                raise AssertionError(f"run {len(runs)}: placements differ "
                                     f"from the first run's")
            r["pair"] = k
            runs.append(r)
    loops = {}
    for name, pipeline in (("causal", False), ("pipelined", True)):
        pps = [r["pods_per_s"] for r in runs if r["pipeline"] is pipeline]
        loops[name] = {"median": statistics.median(pps),
                       "quartiles": _quartiles(pps), "runs": pps}
    wins = sum(1 for k in range(args.pairs)
               if [r["pods_per_s"] for r in runs if r["pair"] == k
                   and r["pipeline"]][0] >
               [r["pods_per_s"] for r in runs if r["pair"] == k
                and not r["pipeline"]][0])
    out = {"nodes": args.nodes, "pending": args.pending,
           "wave_size": args.wave_size, "pairs": args.pairs,
           "device": args.device, "loops": loops,
           "ratio": loops["pipelined"]["median"] / loops["causal"]["median"],
           "pipelined_wins": wins,
           "runs": [{k: r[k] for k in ("pair", "pipeline", "pods_per_s",
                                       "hits", "overlap_s", "stages",
                                       "launches", "solves")}
                    for r in runs]}
    if args.device == "cuda":
        from kubernetes_tpu_torch.tools.kernel_time import card_line

        out["card"] = card_line()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "loop_time.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
