#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Drives the port's main path — one scheduling wave: API objects ->
encode_snapshot -> solve (the hand-written CUDA commit_solve kernel) ->
decisions_to_names — on one NVIDIA GPU at the benchmark's north-star
width (5,000 nodes x 10,000 pending pods, default provider policy), and
holds the kernel against its plain PyTorch version. Phases:

1. torch version, the card's name and power limit;
2. build the CUDA sources with nvcc;
3. the kernel's spread-score device function against the plain int64
   version over every 0 <= count <= total < 2^15;
4. seeded small waves (ports, PDs, selectors, host pins, cordons,
   unschedulable pods, a third resource with a zero-quantity
   advertisement): kernel == plain version, bit for bit;
5. north_star through ``solve``: exactly one kernel launch, decisions and
   scores bit-identical to the plain version, every pod bound; kernel
   time (median of CUDA-event timed runs), plain time, encode and wave
   seconds, pods/s;
6. binpack3 (three resources), the same checks, while time allows.

Any mismatch or error exits non-zero. Run from the repository root:
``python3 chip_smoke.py``. It needs one CUDA device and nvcc, and exits
non-zero without printing a result when either the device or the port's
package is missing. A record of every number goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM: HBM rate,
# and the float32 non-tensor rate, used for the kernel's int32 and compare
# operations since the table gives no int32 rate
_HBM_BYTES_PER_S = 3.35e12
_OPS_PER_S = 67e12
_BUDGET_S = 600      # phase 6 runs only if the run is still inside this


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _fuzz_wave(rng: random.Random, n_nodes: int, n_pods: int,
               three: bool):
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity

    zones = ["z1", "z2", "z3"]
    nodes = []
    for i in range(n_nodes):
        cap = {"cpu": Quantity(f"{rng.choice([500, 1000, 2000, 4000])}m"),
               "memory": Quantity(rng.choice([1 << 30, 2 << 30, 8 << 30]))}
        if three and rng.random() < 0.5:
            # a zero-quantity advertisement still widens the divisor
            cap["nvidia.com/gpu"] = Quantity(rng.choice([0, 1, 2]))
        labels = {"zone": rng.choice(zones)} if rng.random() < 0.5 else {}
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
            spec=api.NodeSpec(capacity=cap,
                              unschedulable=rng.random() < 0.05)))
    services = [api.Service(
        metadata=api.ObjectMeta(name=f"svc-{s}", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": s}))
        for s in ("a", "b")]
    hosts = [n.metadata.name for n in nodes] + ["", "dead-node"]

    def pod(name, may_have_host):
        limits = {}
        cpu = rng.choice([0, 100, 250, 500, 1000, 5000])
        mem = rng.choice([0, 64 << 20, 512 << 20, 1 << 30])
        if cpu:
            limits["cpu"] = Quantity(f"{cpu}m")
        if mem:
            limits["memory"] = Quantity(mem)
        if three and rng.random() < 0.3:
            limits["nvidia.com/gpu"] = Quantity(rng.choice([1, 2]))
        if rng.random() < 0.05:
            limits["fpga"] = Quantity(1)     # advertised by no node
        ports = ([api.ContainerPort(container_port=80,
                                    host_port=rng.choice([8080, 9090]))]
                 if rng.random() < 0.3 else [])
        vols = ([api.Volume(name="v", source=api.VolumeSource(
            gce_persistent_disk=api.GCEPersistentDiskVolumeSource(
                pd_name=rng.choice(["pd1", "pd2", "pd3"]))))]
            if rng.random() < 0.15 else [])
        host = ""
        if may_have_host:
            host = rng.choice(hosts)
        elif rng.random() < 0.05:
            host = rng.choice([nodes[0].metadata.name, "ghost"])
        selector = ({"zone": rng.choice(zones)} if rng.random() < 0.2
                    else {})
        labels = ({"app": rng.choice(["a", "b", "c"])}
                  if rng.random() < 0.7 else {})
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default",
                                    uid=f"uid-{name}", labels=labels),
            spec=api.PodSpec(
                host=host, node_selector=selector, volumes=vols,
                containers=[api.Container(
                    name="c", image="i", ports=ports,
                    resources=api.ResourceRequirements(limits=limits))]),
            status=api.PodStatus(host=host))

    existing = [pod(f"e{i}", True) for i in range(n_nodes // 2 + 3)]
    pending = [pod(f"p{i}", False) for i in range(n_pods)]
    return nodes, existing, pending, services


def _inputs(snap, dev):
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.ops import commit_solver

    host = bs.snapshot_to_host_inputs(snap)
    inp = bs.ship_inputs(host, dev)
    if not commit_solver.eligible(inp, snap.policy, bs.peer_bound_of(snap)):
        raise AssertionError("wave outside the kernel's domain")
    return commit_solver.prepare(inp, snap.policy)


def _event_ms(fn, runs: int):
    """Median and all times (ms) of ``runs`` CUDA-event timed calls."""
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


def _bound(ci, feasible_pairs: int):
    """Least time (ms) the card could take for one wave's solve: the
    larger of the bytes it must move (each input read once, each output
    written once) over the HBM rate and its integer operations over the
    non-tensor rate. Operations: every (pod, node) pair runs the filter
    (1 + 3R + 2Wp + 2Wd ops); every feasible pair is scored
    (6R + 45 ops: LeastRequested per dimension, the spread emulation,
    the running max)."""
    P, N = ci.smask.shape
    R, Wp, Wd = ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0]
    inputs = (ci.smask, ci.podrow, ci.cap, ci.fit0, ci.score0, ci.advx,
              ci.fitexc, ci.ports0, ci.pds0, ci.counts0, ci.offl)
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + 2 * P * 4
    ops = P * N * (1 + 3 * R + 2 * Wp + 2 * Wd) + feasible_pairs * (6 * R + 45)
    bytes_ms = nbytes / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _OPS_PER_S * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", nbytes, ops
    return bytes_ms, "bytes", nbytes, ops


def _spread_exhaustive(dev) -> dict:
    import torch

    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.ops.kernels import spread_score

    limit = 1 << 15
    chunk_pairs = 1 << 26
    t0 = time.perf_counter()
    pairs = bad = 0
    lo = 0
    while lo < limit:
        hi = lo + 1
        while hi < limit and (hi - lo + 1) * (hi + 1) <= chunk_pairs:
            hi += 1
        totals = torch.arange(lo, hi, device=dev, dtype=torch.int64)
        lens = totals + 1
        total = torch.repeat_interleave(totals, lens)
        starts = torch.cumsum(lens, 0) - lens
        count = torch.arange(total.numel(), device=dev) - \
            torch.repeat_interleave(starts, lens)
        got = commit_solver.spread_eval(total.to(torch.int32).contiguous(),
                                        count.to(torch.int32).contiguous())
        want = spread_score(total, count)
        bad += int((got != want).sum())
        pairs += total.numel()
        lo = hi
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"spread device function: {bad} of {pairs} "
                             f"pairs disagree with the plain version")
    return {"pairs": pairs, "mismatches": 0,
            "seconds": time.perf_counter() - t0}


def _fuzz(dev) -> dict:
    import torch

    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    # (seed, nodes, pods, third resource): small waves, then widths that
    # give each thread 2 and 32 nodes (N = 1025, N = 32640)
    cases = [(s, 3 + s % 14, 10 + 3 * s, s % 2 == 1) for s in range(17)]
    cases += [(100, 1025, 150, True), (101, 2999, 200, False),
              (102, 32640, 40, True)]
    t0 = time.perf_counter()
    pods = 0
    for seed, n_nodes, n_pods, three in cases:
        rng = random.Random(seed)
        snap = encode_snapshot(*_fuzz_wave(rng, n_nodes, n_pods, three))
        ci = _inputs(snap, dev)
        got = commit_solver.solve_commit(ci)
        want = commit_solver.solve_commit_reference(ci)
        for g, w, what in zip(got, want, ("chosen", "win")):
            if not torch.equal(g, w):
                i = int((g != w).nonzero()[0])
                raise AssertionError(
                    f"fuzz seed {seed}: {what} differs at pod {i}: kernel "
                    f"{int(g[i])} vs plain {int(w[i])}")
        pods += n_pods
    return {"waves": len(cases), "pods": pods,
            "seconds": time.perf_counter() - t0}


def _wave_phase(name: str, dev, kernel_runs: int) -> dict:
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.fixtures import FULL_SHAPES, build_cluster
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    n_nodes, n_pods, kw = FULL_SHAPES[name]
    t0 = time.perf_counter()
    cluster = build_cluster(n_nodes, n_pods, **kw)
    build_s = time.perf_counter() - t0

    # ---- the main path, through the entry points a user calls ----------
    commit_solver.solve_commit.launches = 0
    t0 = time.perf_counter()
    snap = encode_snapshot(*cluster)
    t1 = time.perf_counter()
    chosen, scores = bs.solve(snap)
    names = bs.decisions_to_names(snap, chosen)
    t2 = time.perf_counter()
    launches = commit_solver.solve_commit.launches
    if launches != 1:
        raise AssertionError(f"{name}: the wave launched commit_solve "
                             f"{launches} times, want exactly 1")

    # ---- the kernel against its plain version on the same inputs -------
    ci = _inputs(snap, dev)
    kernel_ms, kernel_all, (kc, kw_) = _event_ms(
        lambda: commit_solver.solve_commit(ci), kernel_runs)
    stats: dict = {}
    plain_ms, _, (pc, pw) = _event_ms(
        lambda: commit_solver.solve_commit_reference(ci, stats), 1)
    for got, want, what in ((kc, pc, "chosen"), (kw_, pw, "win")):
        if not torch.equal(got, want):
            i = int((got != want).nonzero()[0])
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain version at pod {i}")
    if not (np.array_equal(chosen, pc.cpu().numpy())
            and np.array_equal(scores, pw.cpu().numpy())):
        raise AssertionError(f"{name}: solve() differs from the plain "
                             f"version")
    max_abs_err = int(max((kc - pc).abs().max(), (kw_ - pw).abs().max()))

    # ---- what comes out is right: every pod fits this cluster ----------
    bound = sum(n is not None for n in names)
    if len(names) != n_pods or bound != n_pods:
        raise AssertionError(f"{name}: {bound} of {n_pods} pods bound; "
                             f"the cluster has room for all")
    if not ((chosen >= 0) & (chosen < n_nodes) & (scores >= 0)).all():
        raise AssertionError(f"{name}: decision out of range")

    feasible_pairs = int(stats["feasible"].sum())
    bound_ms, bound_by, nbytes, ops = _bound(ci, feasible_pairs)
    wave_s = t2 - t0
    return {
        "shape": name, "nodes": n_nodes, "pods": n_pods,
        "build_cluster_s": build_s, "encode_s": t1 - t0,
        "solve_and_names_s": t2 - t1, "wave_s": wave_s,
        "pods_per_s": n_pods / wave_s, "bound_pods": bound,
        "launches": launches, "kernel_ms": kernel_ms,
        "kernel_ms_runs": kernel_all, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "bound_ops": ops, "feasible_pairs": feasible_pairs,
        "max_abs_err": max_abs_err,
    }


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    record: dict = {}

    # 1. versions and the card
    card = _card_line()
    _log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}; card: {card}")
    record["card"] = card
    record["torch"] = torch.__version__

    # 2. build
    t0 = time.perf_counter()
    build.build("commit_solve")
    record["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_logs["commit_solve"].splitlines()
             if "registers" in ln or "spill" in ln]
    _log(f"[2] built commit_solve in {record['build_s']:.2f}s")
    for ln in ptxas:
        _log(f"    ptxas: {ln}")

    # 3. exhaustive spread check
    record["spread"] = _spread_exhaustive(dev)
    _log(f"[3] spread device function == plain version on all "
         f"{record['spread']['pairs']} pairs "
         f"({record['spread']['seconds']:.2f}s)")

    # 4. seeded waves
    record["fuzz"] = _fuzz(dev)
    _log(f"[4] {record['fuzz']['waves']} seeded waves "
         f"({record['fuzz']['pods']} pods): kernel == plain version "
         f"({record['fuzz']['seconds']:.2f}s)")

    # 5. north_star, the main path
    ns = _wave_phase("north_star", dev, kernel_runs=7)
    record["north_star"] = ns
    _log(f"[5] north_star {ns['nodes']}x{ns['pods']}: launches "
         f"{ns['launches']}, bound {ns['bound_pods']}, encode "
         f"{ns['encode_s']:.3f}s, wave {ns['wave_s']:.3f}s "
         f"({ns['pods_per_s']:.1f} pods/s), kernel {ns['kernel_ms']:.3f} ms "
         f"(runs {[round(t, 3) for t in ns['kernel_ms_runs']]}), plain "
         f"{ns['plain_ms']:.1f} ms, bound {ns['bound_ms']:.4f} ms "
         f"({ns['bound_by']})")

    # 6. binpack3, while time allows
    if time.perf_counter() - t_start < _BUDGET_S:
        bp = _wave_phase("binpack3", dev, kernel_runs=5)
        record["binpack3"] = bp
        _log(f"[6] binpack3 {bp['nodes']}x{bp['pods']}: launches "
             f"{bp['launches']}, bound {bp['bound_pods']}, wave "
             f"{bp['wave_s']:.3f}s ({bp['pods_per_s']:.1f} pods/s), kernel "
             f"{bp['kernel_ms']:.3f} ms, plain {bp['plain_ms']:.1f} ms")
    else:
        _log("[6] binpack3 skipped: time budget spent")
    record["total_s"] = time.perf_counter() - t_start

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    kernels = {"kernels": [{
        "name": "commit_solve", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/commit_solve.cu",
        "replaces": "kubernetes_tpu/ops/pallas_solver.py:772",
        "launches": ns["launches"], "max_abs_err": ns["max_abs_err"],
        "ms": ns["kernel_ms"], "plain_ms": ns["plain_ms"],
        "bound_ms": ns["bound_ms"], "bound_by": ns["bound_by"],
        "library_ms": None}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
