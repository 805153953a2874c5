#!/usr/bin/env python3
"""Time one of the benchmark's waves on the card: the commit_solve kernel
alone, or the whole wave.

Encodes the shape's wave (fixtures.FULL_SHAPES, under the shape's JSON
Policy where it has one; ``north_star_dec`` takes the int64 instances,
``priority`` the preemption branch, ``planet`` and ``services64`` the
large-cluster instances). By default it prepares the kernel's inputs on
the card and times ``solve_commit`` with CUDA events: one warm-up launch,
then the median of ``--runs`` launches. With ``--wave`` it times the whole
wave as a user runs it, on the host clock: encode_snapshot, solve and
decisions_to_names, one warm-up wave, then ``--runs`` waves. With
``--batch K`` it times one batched launch over K stacked copies of the
wave, K blocks (the solver daemon's coalesced group; the planes are
stacked before the timed launches). Prints one JSON line with the card's
name and power limit.

The package is imported from the working directory, so the same script
times two trees of the repository in turns:

    cd <tree> && PYTHONPATH=. python3 <this repo>/kubernetes_tpu_torch/tools/kernel_time.py north_star [--wave]

Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, runs: int):
    """Median and all times (ms) of ``runs`` CUDA-event timed calls of
    ``fn``, and the last call's result."""
    import torch

    times = []
    out = None
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times, out


def _wave_times(cluster, policy, runs: int) -> dict:
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot

    encode, solve = [], []
    for _ in range(runs + 1):                           # the first warms up
        t0 = time.perf_counter()
        snap = encode_snapshot(*cluster, policy=policy)
        t1 = time.perf_counter()
        chosen, _scores = bs.solve(snap)
        bs.decisions_to_names(snap, chosen)
        t2 = time.perf_counter()
        encode.append(t1 - t0)
        solve.append(t2 - t1)
    encode, solve = encode[1:], solve[1:]
    wave = [e + s for e, s in zip(encode, solve)]
    return {"encode_s": statistics.median(encode),
            "solve_and_names_s": statistics.median(solve),
            "wave_s": statistics.median(wave),
            "pods_per_s": len(cluster[2]) / statistics.median(wave),
            "encode_s_runs": encode, "solve_and_names_s_runs": solve}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", help="a key of fixtures.FULL_SHAPES")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--wave", action="store_true",
                    help="time the whole wave, not the kernel alone")
    ap.add_argument("--batch", type=int, default=0,
                    help="time one batched launch over this many copies "
                         "of the wave")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_time: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import fixtures
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    n_nodes, _n_pods, _kw, policy_json = fixtures.FULL_SHAPES[args.shape]
    policy = None
    if policy_json:
        from kubernetes_tpu_torch.models.policy import batch_policy_from
        from kubernetes_tpu_torch.scheduler.plugins import load_policy

        policy = batch_policy_from(policy=load_policy(policy_json))
    cluster = fixtures.build_shape(args.shape)
    out = {"shape": args.shape, "nodes": n_nodes, "pods": len(cluster[2])}
    if args.wave:
        out.update(_wave_times(cluster, policy, args.runs))
    else:
        snap = encode_snapshot(*cluster, policy=policy)
        inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cuda")
        bound = bs.peer_bound_of(snap)
        if not commit_solver.eligible(inp, snap.policy, bound):
            raise AssertionError("wave outside the kernel's domain")
        ci = commit_solver.prepare(inp, snap.policy, snap.has_gangs, bound)
        if args.batch:
            # the planes are stacked once, outside the timed launches
            planes = commit_solver.stack_planes([ci] * args.batch)
            run = lambda: commit_solver.launch_stacked(  # noqa: E731
                ci, planes, args.batch)
            out["batch"] = args.batch
        else:
            run = lambda: commit_solver.solve_commit(ci)  # noqa: E731
        run()                                           # build and warm up
        ms, runs, _ = event_ms(run, args.runs)
        on_chip, _ = commit_solver.layout_of(ci)
        out.update({"kernel_ms": ms, "kernel_ms_runs": runs,
                    "resource_type": str(ci.cap.dtype).split(".")[-1],
                    "bands": ci.band.shape[0],
                    "instance": commit_solver.instance_of(
                        ci, args.batch or 1),
                    "layout": "shared" if on_chip else "global"})
    out["card"] = card_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
