#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Drives the port's main paths on one NVIDIA GPU — one scheduling wave
(API objects -> encode_snapshot -> solve, the hand-written CUDA
commit_solve kernel -> decisions_to_names) at the benchmark's north-star
width (5,000 nodes x 10,000 pending pods, default provider policy), the
benchmark's ``affinity``, ``gang`` and ``priority`` (preemption) waves and
north_star with decimal memory (int64 planes) at full width, and the
scheduler's wave loop (BatchScheduler) binding a north-star cluster wave
by wave and preempting on the priority cluster — and holds the kernel
against its plain PyTorch version. Phases:

1. torch version, the card's name and power limit;
2. build the CUDA sources with nvcc (one process per source, in
   parallel), and report each source's compile seconds and ptxas'
   registers, static shared memory, stack and spills for each of the
   kernel's instances;
3. the kernel's spread-score device function against the plain int64
   version over every 0 <= count <= total < 2^15;
4. seeded small waves (ports, PDs, selectors, host pins, cordons,
   unschedulable pods, a third resource with a zero-quantity
   advertisement): kernel == plain version, bit for bit;
4b. seeded waves with every policy extension — zone anti-affinity on one
   and two labels with unlabeled nodes, service affinity on one and two
   labels with and without existing peers and with an anchor on an
   unknown host, label preferences, label presence, gangs that
   oversubscribe on purpose, gangs with affinity and with anti-affinity,
   and the kitchen sink: kernel == plain version, bit for bit; fails
   unless some gang run was rolled back, and unless the waves of phases 4
   and 4b ran both state layouts (shared memory and global memory; the
   32,640-node waves take the global one);
4c. seeded int64 and preemption waves — a 1 TiB + 3 B node and decimal
   memory, bands in arrival order (the incremental encoder's slots, or a
   permuted full encoding), 32 bands (the kernel's cap), Never and
   equal-priority pods, gangs, zone anti-affinity, service affinity, both
   state layouts: kernel == plain version, bit for bit, and no victim at
   equal or higher priority, no Never pod placed by eviction;
5. north_star through ``solve``: exactly one kernel launch and no call of
   the plain version, decisions and scores bit-identical to the plain
   version, every pod bound; kernel time (median of CUDA-event timed
   runs), plain time, encode and wave seconds, pods/s;
5b. affinity (5,000 x 5,000) with its Policy loaded from JSON through
   ``load_policy`` -> ``batch_policy_from``, the same checks;
5c. gang (1,000 PodGroups of 8 on 2,000 nodes), the same checks after
   the all-or-nothing post-pass;
5d. north_star_dec (north_star, every pending pod's memory in ``M``: int64
   planes), the same checks;
5e. priority (2,000 nodes filled by 8,000 pods in two bands, 1,000 storm
   pods), the same checks but for the pods that must stay pending, and
   bench.py's preemption invariants; logs the placements by preemption
   and the victims;
6. binpack3 (three resources), the same checks, while time allows;
7. the scheduler: BatchScheduler over the port's ConfigFactory and a
   FakeClient (tools/fake_cluster.py) holding the north-star cluster —
   5,000 nodes, 8 services, 10,000 bound pods that reach the assigned-pods
   store through the reflector's list — binds 10,000 pending pods in
   waves of 1,024 (the first a full-list encode, the rest
   IncrementalEncoder deltas; the last wave's 784 pods pad to 1,024);
   then churn (1,000 bound pods deleted, 2,000 pending added: two delta
   waves) and a node added with 1,024 more pending (the node planes
   rebuild: one full-list wave). ``schedule_wave()`` runs until the FIFO
   is empty, with no sleeps. Fails unless every pending pod binds, every
   wave launches commit_solve exactly once, the encode takes the path
   above, no padding row places, each wave's bindings equal
   solve(encode_snapshot(...)) of its state on the card, and one delta
   wave's decisions equal the plain version on the CPU. Logs each wave's
   encode path and encode, solve and commit seconds (the loop's own
   ``scheduler_wave_*`` histograms), the garbage collector's pauses in it
   (seconds and full collections, from ``gc.callbacks``) and the loop's
   pods/s (pods bound over the time from the first drain to the last
   commit);
8. the scheduler on the priority cluster, waves of 512 (two waves, the
   second sees the first's evictions): each wave launches commit_solve
   once and never the plain version, every preempting pod binds with its
   victims through the FakeCluster's atomic evict+bind and the victims
   leave the stores, each wave's bindings and victim sets equal the
   replay of solve(encode_snapshot(...)) of its state, and the
   scheduler_preemption_* counters agree.

Each full shape and each wide seeded wave logs the state layout it took
and its dynamic shared memory. Any mismatch or error exits non-zero. Run
from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and nvcc, and exits non-zero without printing a result when either
the device or the port's package is missing. A record of every number
goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import random
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
    return commit_solver.prepare(inp, snap.policy, snap.has_gangs)


def _layout(ci):
    """-> ("shared" or "global", dynamic shared bytes): where the kernel
    keeps this wave's node state."""
    from kubernetes_tpu_torch.ops import commit_solver

    on_chip, nbytes = commit_solver.layout_of(ci)
    return ("shared" if on_chip else "global"), nbytes


def _bound(ci, feasible_pairs: int, preempt_pairs: int = 0):
    """Least time (ms) the card could take for the work one wave's solve
    must do: the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its operations over the
    non-tensor rate. Operations, counted as the reference states them
    (not as this kernel computes them): every (pod, node) pair runs the
    filter (1 + 3R + 2Wp + 2Wd ops); every feasible pair is scored: when
    LeastRequested weighs in, 6 per dimension plus the divisor and the
    weight (6R + 2); when ServiceSpreading does, its float32 spread
    expression (two converts, subtract, divide, times 10, truncate,
    weight, add: 8); per anti-affinity label, the zone accumulation and
    the same spread expression (9); 2L compares for the affinity anchors;
    one add each for the label-preference plane and the Equal priority;
    and the running max (2). Every (pod, node) pair the preemption branch
    examines (``preempt_pairs``: a pod with no normal node that may
    preempt, a node passing every other filter) adds B R adds and B R
    compares of the freed capacity against the request. int64 planes
    count at the same rate (the table has no integer rate)."""
    P = ci.smask.shape[0]
    R, N = ci.cap.shape
    Wp, Wd = ci.ports0.shape[0], ci.pds0.shape[0]
    L, A, B = ci.affv.shape[0], ci.zone.shape[0], ci.band.shape[0]
    # the mask counts its N columns, not the row padding
    inputs = (ci.podrow, ci.cap, ci.fit0, ci.score0, ci.advx,
              ci.fitexc, ci.ports0, ci.pds0, ci.counts0, ci.offl, ci.sstat,
              ci.affv, ci.anchor0, ci.has0, ci.zone, ci.ecap0, ci.ecnt0,
              ci.band)
    nbytes = (P * N + sum(t.numel() * t.element_size() for t in inputs)
              + 2 * P * 4)
    per_feasible = ((6 * R + 2 if ci.w_lr else 0) + (8 if ci.w_spread else 0)
                    + 9 * A + 2 * L + (1 if ci.sstat.numel() else 0)
                    + (1 if ci.w_equal else 0) + 2)
    ops = (P * N * (1 + 3 * R + 2 * Wp + 2 * Wd)
           + feasible_pairs * per_feasible + preempt_pairs * 2 * B * R)
    bytes_ms = nbytes / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _OPS_PER_S * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", nbytes, ops
    return bytes_ms, "bytes", nbytes, ops


def _ptxas_report(log: str) -> dict:
    """ptxas' registers, static shared memory, stack and spills for each
    kernel instance, keyed by the instance's resource type, branch set and
    state layout (``commit_solve<int32,pre,aff,anti,gang,static,shared>``
    with 0/1 flags) or the kernel's name."""
    import re

    out: dict = {}
    entry = props = None
    frames: dict = {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        if "stack frame" in ln and props:
            frames[props] = ln.strip()
            continue
        m = re.search(r"Used \d+ registers.*", ln)
        if m and entry:
            flags = re.search(r"commit_solve_kernelI([ix])Lb([01])ELb([01])"
                              r"ELb([01])ELb([01])ELb([01])ELb([01])E", entry)
            name = entry
            if flags:
                res = "int32" if flags.group(1) == "i" else "int64"
                name = (f"commit_solve<{res},"
                        f"{','.join(flags.groups()[1:])}>")
            elif "spread_eval" in entry:
                name = "spread_eval"
            out[name] = f"{m.group(0)}; {frames.get(entry, '')}"
            entry = None
    return out


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
    layouts: dict = {}
    for seed, n_nodes, n_pods, three in cases:
        rng = random.Random(seed)
        snap = encode_snapshot(*_fuzz_wave(rng, n_nodes, n_pods, three))
        ci = _inputs(snap, dev)
        layout = _layout(ci)[0]
        layouts[layout] = layouts.get(layout, 0) + 1
        got = commit_solver.solve_commit(ci)
        want = commit_solver.solve_commit_reference(ci)
        for g, w, what in zip(got, want, ("chosen", "win")):
            if not torch.equal(g, w):
                i = int((g != w).nonzero()[0])
                raise AssertionError(
                    f"fuzz seed {seed}: {what} differs at pod {i}: kernel "
                    f"{int(g[i])} vs plain {int(w[i])}")
        pods += n_pods
    return {"waves": len(cases), "pods": pods, "layouts": layouts,
            "seconds": time.perf_counter() - t0}


def _ext_wave(rng: random.Random, n_nodes: int, n_pods: int, anti=0,
              aff=0, prefs=False, presence=False, gangs=False,
              ghost=False):
    """A seeded wave and the BatchPolicy that uses the named extensions:
    ``anti`` zone anti-affinity labels (0-2), ``aff`` service-affinity
    labels (0-2), label preferences, label presence, gangs (some sized
    to oversubscribe the cluster), and an existing service peer on a host
    that is not a node (``ghost``)."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.models import gang
    from kubernetes_tpu_torch.models.policy import BatchPolicy

    nodes = []
    for i in range(n_nodes):
        labels = {}
        for key, values, p in (("zone", 6, 0.8), ("rack", 4, 0.6),
                               ("region", 3, 0.8)):
            if rng.random() < p:
                labels[key] = f"{key[0]}{rng.randrange(values)}"
        if rng.random() < 0.4:
            labels["ssd"] = "true"
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
            spec=api.NodeSpec(capacity={
                "cpu": Quantity(f"{rng.choice([1000, 2000, 4000])}m"),
                "memory": Quantity(rng.choice([2 << 30, 8 << 30]))},
                unschedulable=rng.random() < 0.03)))
    services = [api.Service(
        metadata=api.ObjectMeta(name=f"svc-{s}", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": f"a{s}"}))
        for s in range(3)]

    def pod(name, host="", cpu=None, group=None):
        cpu = cpu if cpu is not None else rng.choice([0, 100, 250, 500, 900])
        limits = {"memory": Quantity(rng.choice([64 << 20, 256 << 20]))}
        if cpu:
            limits["cpu"] = Quantity(f"{cpu}m")
        selector = {}
        if rng.random() < 0.2:
            selector["region"] = f"r{rng.randrange(3)}"
        if rng.random() < 0.1:
            selector["zone"] = f"z{rng.randrange(6)}"
        ports = ([api.ContainerPort(container_port=80,
                                    host_port=rng.choice([8080, 9090]))]
                 if rng.random() < 0.15 else [])
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, namespace="default", uid=f"uid-{name}",
                labels=({"app": f"a{rng.randrange(3)}"}
                        if rng.random() < 0.8 else {}),
                annotations=({gang.GANG_NAME_ANNOTATION: group}
                             if group else {})),
            spec=api.PodSpec(
                host=host, node_selector=selector if not host else {},
                containers=[api.Container(
                    name="c", image="i", ports=ports,
                    resources=api.ResourceRequirements(limits=limits))]),
            status=api.PodStatus(host=host))

    n_existing = 0 if rng.random() < 0.3 else n_nodes // 2 + 3
    existing = [pod(f"e{i}", host=rng.choice(nodes).metadata.name)
                for i in range(n_existing)]
    if ghost:
        existing.append(pod("ghost-peer", host="ghost"))
        existing[-1].metadata.labels = {"app": "a0"}
    pending = []
    while len(pending) < n_pods:
        if gangs and rng.random() < 0.6:
            # some groups ask for more than the cluster has left
            size = rng.randint(2, 5)
            cpu = rng.choice([300, 900, 1900, 3900])
            g = len(pending)
            pending += [pod(f"g{g}-m{m}", cpu=cpu, group=f"grp-{g}")
                        for m in range(size)]
        else:
            pending.append(pod(f"p{len(pending)}"))
    policy = BatchPolicy(
        w_lr=1, w_spread=rng.choice([0, 1]),
        anti_affinity=(("zone", 2), ("rack", 1))[:anti],
        affinity_labels=("region", "rack")[:aff],
        label_prefs=(("ssd", True, 2), ("gpu", False, 1)) if prefs else (),
        label_presence=((("zone",), True),) if presence else ())
    return (nodes, existing, pending, services), policy


# (seed, nodes, pods, _ext_wave keywords): each small case runs three
# seeds; the last cases give each thread 2, 3 and 32 nodes
_EXT_CASES = [
    (200, 9, 30, dict(anti=1)),
    (210, 14, 40, dict(anti=2)),
    (220, 9, 30, dict(aff=1)),
    (230, 12, 40, dict(aff=2)),
    (240, 10, 30, dict(aff=1, ghost=True)),
    (250, 10, 30, dict(prefs=True)),
    (260, 10, 30, dict(presence=True)),
    (270, 8, 40, dict(gangs=True)),
    (280, 8, 40, dict(gangs=True, aff=1)),
    (290, 8, 40, dict(gangs=True, anti=1)),
    (300, 12, 50, dict(gangs=True, anti=2, aff=2, prefs=True,
                       presence=True)),
    (310, 14, 50, dict(anti=1, aff=1, prefs=True, ghost=True)),
]
_EXT_WIDE = [
    (400, 1500, 120, dict(anti=2, aff=1, prefs=True)),
    (401, 2100, 160, dict(gangs=True, anti=1, aff=2)),
    (402, 32640, 40, dict(gangs=True, anti=1, aff=1, presence=True)),
]


def _rolled_back_runs(rid, chosen) -> int:
    """Gang runs in which a member found no node after an earlier member
    of the run had placed: the kernel rolled those back."""
    import numpy as np

    runs = 0
    for r in np.unique(rid[rid >= 0]):
        c = chosen[rid == r]
        fail = np.nonzero(c < 0)[0]
        if fail.size and (c[:fail[0]] >= 0).any():
            runs += 1
    return runs


def _ext_fuzz(dev) -> dict:
    import torch

    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.tools.kernel_time import event_ms

    cases = [(seed + k, n, p, kw) for seed, n, p, kw in _EXT_CASES
             for k in range(3)] + _EXT_WIDE
    t0 = time.perf_counter()
    pods = rolled_back = gang_waves = 0
    wide = []
    layouts: dict = {}
    for seed, n_nodes, n_pods, kw in cases:
        wave, policy = _ext_wave(random.Random(seed), n_nodes, n_pods, **kw)
        snap = encode_snapshot(*wave, policy=policy)
        ci = _inputs(snap, dev)
        layout, dyn_bytes = _layout(ci)
        layouts[layout] = layouts.get(layout, 0) + 1
        if n_nodes < 1000:
            got = commit_solver.solve_commit(ci)
            want = commit_solver.solve_commit_reference(ci)
        else:
            # the wide waves also give the branches' times at these shapes
            kernel_ms, _, got = event_ms(
                lambda: commit_solver.solve_commit(ci), 3)
            stats: dict = {}
            plain_ms, _, want = event_ms(
                lambda: commit_solver.solve_commit_reference(ci, stats), 1)
            feasible_pairs = int(stats["feasible"].sum())
            bound_ms, bound_by, nbytes, ops = _bound(ci, feasible_pairs)
            wide.append({"seed": seed, "nodes": n_nodes,
                         "pods": len(snap.pod_names), "extensions": kw,
                         "layout": layout, "dyn_shared_bytes": dyn_bytes,
                         "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_bytes": nbytes, "bound_ops": ops,
                         "feasible_pairs": feasible_pairs})
        for g, w, what in zip(got, want, ("chosen", "win")):
            if not torch.equal(g, w):
                i = int((g != w).nonzero()[0])
                raise AssertionError(
                    f"extension seed {seed} {kw}: {what} differs at pod "
                    f"{i}: kernel {int(g[i])} vs plain {int(w[i])}")
        if snap.has_gangs:
            gang_waves += 1
            rolled_back += _rolled_back_runs(snap.pod_rid,
                                             want[0].cpu().numpy())
        pods += len(snap.pod_names)
    if not rolled_back:
        raise AssertionError("no gang run was rolled back: the rollback "
                             "path went unchecked")
    return {"waves": len(cases), "pods": pods, "gang_waves": gang_waves,
            "rolled_back_runs": rolled_back, "wide": wide,
            "layouts": layouts,
            "seconds": time.perf_counter() - t0}


def _pre_wave(rng: random.Random, n_nodes: int, n_pods: int, n_bands: int,
              wide=False, gangs=False, anti=0, aff=0):
    """A seeded preemption wave and its BatchPolicy: nodes about full of
    resident pods at ``n_bands`` distinct priorities, then pending pods
    above every band, between bands, equal to one, below all, and some
    with PreemptionPolicy=Never. ``wide``: memory in decimal units beside
    binary ones, and one node of 1 TiB + 3 B, so the resource planes are
    int64. ``gangs``: some pending PodGroups; ``anti``/``aff``: zone
    anti-affinity and service-affinity labels."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.models import gang
    from kubernetes_tpu_torch.models.policy import BatchPolicy

    bands = rng.sample(range(0, 10_000, 10), n_bands)
    nodes = []
    for i in range(n_nodes):
        mem = rng.choice([4 << 30, 8 << 30])
        if wide and i == 0:
            mem = (1 << 40) + 3
        labels = {"zone": f"z{rng.randrange(4)}", "rack": f"r{rng.randrange(3)}"}
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", labels=labels),
            spec=api.NodeSpec(capacity={
                "cpu": Quantity(f"{rng.choice([1000, 2000, 4000])}m"),
                "memory": Quantity(mem)})))
    services = [api.Service(
        metadata=api.ObjectMeta(name=f"svc-{s}", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": f"a{s}"}))
        for s in range(2)]

    def pod(name, prio, host="", cpu=None, never=False, group=None):
        cpu = cpu if cpu is not None else rng.choice([100, 250, 500, 900])
        mem = (Quantity(f"{rng.choice([100, 300, 500])}M") if wide
               and rng.random() < 0.5 else
               Quantity(rng.choice([64 << 20, 256 << 20])))
        ports = ([api.ContainerPort(container_port=80, host_port=8080)]
                 if rng.random() < 0.1 else [])
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, namespace="default", uid=f"uid-{name}",
                labels=({"app": f"a{rng.randrange(2)}"}
                        if rng.random() < 0.7 else {}),
                annotations=({gang.GANG_NAME_ANNOTATION: group}
                             if group else {})),
            spec=api.PodSpec(
                host=host, priority=prio,
                preemption_policy=api.PreemptNever if never else "",
                containers=[api.Container(
                    name="c", image="i", ports=ports,
                    resources=api.ResourceRequirements(limits={
                        "cpu": Quantity(f"{cpu}m"), "memory": mem}))]),
            status=api.PodStatus(host=host))

    existing = []
    for i, node in enumerate(nodes):
        for j in range(rng.randint(1, 4)):
            existing.append(pod(f"e{i}-{j}", rng.choice(bands),
                                host=node.metadata.name,
                                cpu=rng.choice([200, 300, 500])))
    rng.shuffle(existing)     # band slots in arrival order
    top = max(bands)
    pending = []
    while len(pending) < n_pods:
        kind = rng.random()
        prio = (top + 1 if kind < 0.5 else rng.choice(bands) if kind < 0.65
                else rng.randrange(top) if kind < 0.9 else -1)
        never = rng.random() < 0.15
        if gangs and rng.random() < 0.3:
            g = len(pending)
            cpu = rng.choice([300, 900, 1900])
            pending += [pod(f"g{g}-m{m}", prio, cpu=cpu, never=never,
                            group=f"grp-{g}")
                        for m in range(rng.randint(2, 4))]
        else:
            pending.append(pod(f"p{len(pending)}", prio, never=never))
    policy = BatchPolicy(
        w_lr=1, w_spread=1,
        anti_affinity=(("zone", 2), ("rack", 1))[:anti],
        affinity_labels=("zone",)[:aff])
    return (nodes, existing, pending, services), policy


# (seed, nodes, pods, bands, _pre_wave keywords): int64 planes, bands in
# arrival order, the band cap, Never and equal-priority pods, gangs,
# zone anti-affinity, service affinity; the wide cases give each thread
# several nodes and take the global state layout
_PRE_CASES = [
    (500, 6, 24, 2, {}),
    (501, 9, 30, 3, {}),
    (502, 12, 40, 5, dict(wide=True)),
    (503, 8, 30, 4, dict(gangs=True)),
    (504, 10, 36, 4, dict(anti=1)),
    (505, 10, 36, 3, dict(anti=2, wide=True)),
    (506, 8, 30, 3, dict(aff=1)),
    (507, 12, 40, 6, dict(gangs=True, anti=1, wide=True)),
    (508, 16, 60, 32, {}),
    (509, 16, 60, 32, dict(wide=True, gangs=True)),
]
_PRE_WIDE = [
    (600, 1500, 120, 32, dict(anti=1)),
    (601, 2100, 160, 4, dict(wide=True, gangs=True)),
    (602, 32640, 40, 3, dict(wide=True)),
]


def _pre_fuzz(dev) -> dict:
    """Phase 4c: seeded int64 and preemption waves, kernel == plain."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.models import preempt
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.tools.kernel_time import event_ms

    cases = [(seed + k, n, p, b, kw) for seed, n, p, b, kw in _PRE_CASES
             for k in range(2)] + _PRE_WIDE
    t0 = time.perf_counter()
    seen = {"layouts": {}, "int64": 0, "bands_at_cap": 0, "unsorted": 0,
            "preempting": 0, "victims": 0, "never_pods": 0,
            "gang_waves": 0, "waves": len(cases), "pods": 0}
    wide = []
    for seed, n_nodes, n_pods, n_bands, kw in cases:
        wave, policy = _pre_wave(random.Random(seed), n_nodes, n_pods,
                                 n_bands, **kw)
        nodes, existing, pending, services = wave
        if policy.affinity_labels:
            snap = encode_snapshot(*wave, policy=policy)
            # hand the kernel the bands in another slot order
            perm = np.random.default_rng(seed).permutation(
                snap.band_prio.shape[0])
            snap.band_prio = snap.band_prio[perm]
            snap.evict_cap = snap.evict_cap[:, perm]
            snap.evict_cnt = snap.evict_cnt[:, perm]
            index = {n.metadata.name: i for i, n in enumerate(nodes)}
            lookup = dict(resident=preempt.resident_from_pods(existing,
                                                              index))
        else:
            enc = IncrementalEncoder(policy)
            snap = enc.encode(nodes, existing, pending, services)
            lookup = dict(node_pods=enc.resident_on)
        ci = _inputs(snap, dev)
        B = ci.band.shape[0]
        if B == 0:
            raise AssertionError(f"preemption seed {seed}: no bands")
        layout, dyn_bytes = _layout(ci)
        seen["layouts"][layout] = seen["layouts"].get(layout, 0) + 1
        seen["int64"] += ci.cap.dtype == torch.int64
        seen["bands_at_cap"] += B == commit_solver.MAX_B
        band = snap.band_prio
        seen["unsorted"] += bool((np.diff(band[band != preempt.BAND_EMPTY])
                                  < 0).any())
        stats: dict = {}
        if n_nodes < 1000:
            got = commit_solver.solve_commit(ci)
            want = commit_solver.solve_commit_reference(ci, stats)
        else:
            kernel_ms, _, got = event_ms(
                lambda: commit_solver.solve_commit(ci), 3)
            plain_ms, _, want = event_ms(
                lambda: commit_solver.solve_commit_reference(ci, stats), 1)
            bound_ms, bound_by, nbytes, ops = _bound(
                ci, int(stats["feasible"].sum()),
                int(stats["preempt_pairs"].sum()))
            wide.append({"seed": seed, "nodes": n_nodes,
                         "pods": len(snap.pod_names), "bands": B,
                         "resource_type": str(ci.cap.dtype), "kw": kw,
                         "layout": layout, "dyn_shared_bytes": dyn_bytes,
                         "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
        for g, w, what in zip(got, want, ("chosen", "win")):
            if not torch.equal(g, w):
                i = int((g != w).nonzero()[0])
                raise AssertionError(
                    f"preemption seed {seed} {kw}: {what} differs at pod "
                    f"{i}: kernel {int(g[i])} vs plain {int(w[i])}")
        chosen, win = (t.cpu().numpy() for t in want)
        n = len(pending)
        victims = preempt.assign_victims(chosen, win, snap.band_prio,
                                         n_pods=n, **lookup)
        prio_of = {p.metadata.uid: api.pod_priority(p) for p in existing}
        order = {f"{p.metadata.namespace}/{p.metadata.name}": p
                 for p in pending}
        for name, v in zip(snap.pod_names[:n], victims):
            if not v:
                continue
            p = order[name]
            if not api.pod_can_preempt(p):
                raise AssertionError(f"preemption seed {seed}: a Never pod "
                                     f"placed by eviction")
            if any(prio_of[x.uid] >= api.pod_priority(p) for x in v):
                raise AssertionError(f"preemption seed {seed}: an equal-or-"
                                     f"higher pod was evicted")
            seen["preempting"] += 1
            seen["victims"] += len(v)
        seen["never_pods"] += sum(not api.pod_can_preempt(p)
                                  for p in pending)
        seen["gang_waves"] += snap.has_gangs
        seen["pods"] += n
    for key, what in (("preempting", "no pod placed by preemption"),
                      ("int64", "no wave had int64 planes"),
                      ("bands_at_cap", f"no wave had {commit_solver.MAX_B} "
                                       f"bands"),
                      ("unsorted", "no wave had its bands out of order"),
                      ("gang_waves", "no preemption wave had gangs")):
        if not seen[key]:
            raise AssertionError(f"phase 4c: {what}")
    if set(seen["layouts"]) != {"shared", "global"}:
        raise AssertionError(f"phase 4c ran only the {set(seen['layouts'])} "
                             f"state layout(s)")
    seen["wide"] = wide
    seen["seconds"] = time.perf_counter() - t0
    return seen


def _wave_phase(name: str, dev, kernel_runs: int) -> dict:
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import gang
    from kubernetes_tpu_torch.models.fixtures import FULL_SHAPES, build_shape
    from kubernetes_tpu_torch.models.policy import batch_policy_from
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler.plugins import load_policy
    from kubernetes_tpu_torch.tools.kernel_time import event_ms

    n_nodes, n_pods, kw, policy_json = FULL_SHAPES[name]
    t0 = time.perf_counter()
    cluster = build_shape(name)
    build_s = time.perf_counter() - t0
    n_pods = len(cluster[2])

    # ---- the main path, through the entry points a user calls ----------
    commit_solver.solve_commit.launches = 0
    commit_solver.solve_commit_reference.calls = 0
    t0 = time.perf_counter()
    policy = (batch_policy_from(policy=load_policy(policy_json))
              if policy_json else None)
    snap = encode_snapshot(*cluster, policy=policy)
    t1 = time.perf_counter()
    chosen, scores = bs.solve(snap)
    names = bs.decisions_to_names(snap, chosen)
    t2 = time.perf_counter()
    launches = commit_solver.solve_commit.launches
    if launches != 1:
        raise AssertionError(f"{name}: the wave launched commit_solve "
                             f"{launches} times, want exactly 1")
    if commit_solver.solve_commit_reference.calls:
        raise AssertionError(f"{name}: the main path ran the plain version")

    # ---- the kernel against its plain version on the same inputs -------
    ci = _inputs(snap, dev)
    layout, dyn_bytes = _layout(ci)
    kernel_ms, kernel_all, (kc, kw_) = event_ms(
        lambda: commit_solver.solve_commit(ci), kernel_runs)
    stats: dict = {}
    plain_ms, _, (pc, pw) = event_ms(
        lambda: commit_solver.solve_commit_reference(ci, stats), 1)
    for got, want, what in ((kc, pc, "chosen"), (kw_, pw, "win")):
        if not torch.equal(got, want):
            i = int((got != want).nonzero()[0])
            raise AssertionError(f"{name}: kernel {what} differs from the "
                                 f"plain version at pod {i}")
    max_abs_err = int(max((kc - pc).abs().max(), (kw_ - pw).abs().max()))
    want_c, want_s = pc.cpu().numpy(), pw.cpu().numpy()
    if snap.has_gangs:
        want_c = gang.apply_all_or_nothing(snap.pod_rid, want_c)
        want_s = np.where(want_c < 0, -1, want_s)
    if not (np.array_equal(chosen, want_c) and np.array_equal(scores, want_s)):
        raise AssertionError(f"{name}: solve() differs from the plain "
                             f"version")

    # ---- what comes out is right -------------------------------------
    bound = sum(n is not None for n in names)
    extra: dict = {}
    if name == "priority":
        extra = _priority_checks(cluster, snap, chosen, scores, names)
    elif len(names) != n_pods or bound != n_pods:
        raise AssertionError(f"{name}: {bound} of {n_pods} pods bound; "
                             f"the cluster has room for all")
    elif not ((chosen >= 0) & (chosen < n_nodes) & (scores >= 0)).all():
        raise AssertionError(f"{name}: decision out of range")

    feasible_pairs = int(stats["feasible"].sum())
    preempt_pairs = int(stats["preempt_pairs"].sum())
    bound_ms, bound_by, nbytes, ops = _bound(ci, feasible_pairs,
                                             preempt_pairs)
    wave_s = t2 - t0
    return {**extra,
        "resource_type": str(ci.cap.dtype).split(".")[-1],
        "bands": ci.band.shape[0], "preempt_pairs": preempt_pairs,
        "shape": name, "nodes": n_nodes, "pods": n_pods,
        "policy": policy_json or "default provider",
        "gangs": snap.has_gangs,
        "build_cluster_s": build_s, "encode_s": t1 - t0,
        "solve_and_names_s": t2 - t1, "wave_s": wave_s,
        "pods_per_s": n_pods / wave_s, "bound_pods": bound,
        "launches": launches, "layout": layout,
        "dyn_shared_bytes": dyn_bytes, "kernel_ms": kernel_ms,
        "kernel_ms_runs": kernel_all, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "bound_ops": ops, "feasible_pairs": feasible_pairs,
        "max_abs_err": max_abs_err,
    }


def _priority_checks(cluster, snap, chosen, scores, names) -> dict:
    """bench.py's preemption invariants on the priority wave (bench.py
    :851-878): no victim at equal or higher priority than its preemptor,
    no PreemptionPolicy=Never pod placed by eviction; and the storm must
    really preempt."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.models import preempt

    nodes, existing, pending, _services = cluster
    index = {n.metadata.name: i for i, n in enumerate(nodes)}
    victims = preempt.assign_victims(
        chosen, scores, snap.band_prio,
        preempt.resident_from_pods(existing, index), n_pods=len(pending))
    prio_of = {p.metadata.uid: api.pod_priority(p) for p in existing}
    for p, v in zip(pending, victims):
        if not v:
            continue
        if any(prio_of[x.uid] >= api.pod_priority(p) for x in v):
            raise AssertionError("priority: evicted an equal-or-higher-"
                                 "priority pod")
        if p.spec.preemption_policy == api.PreemptNever:
            raise AssertionError("priority: a PreemptionPolicy=Never pod "
                                 "placed by eviction")
    n_preempted = sum(1 for v in victims if v)
    if not n_preempted:
        raise AssertionError("priority: no pod placed by preemption")
    return {"preempted_pods": n_preempted,
            "victims": sum(len(v) for v in victims if v),
            "placed": sum(n is not None for n in names)}


def _log_wave(tag: str, w: dict) -> None:
    pre = (f", {w['preempted_pods']} placed by preemption evicting "
           f"{w['victims']}" if "preempted_pods" in w else "")
    _log(f"[{tag}] {w['shape']} {w['nodes']}x{w['pods']} "
         f"({w['resource_type']} planes, {w['bands']} bands{pre}): launches "
         f"{w['launches']}, state in {w['layout']} memory "
         f"({w['dyn_shared_bytes']} B dynamic shared), bound "
         f"{w['bound_pods']}, encode "
         f"{w['encode_s']:.3f}s, wave {w['wave_s']:.3f}s "
         f"({w['pods_per_s']:.1f} pods/s), kernel {w['kernel_ms']:.3f} ms "
         f"(runs {[round(t, 3) for t in w['kernel_ms_runs']]}), plain "
         f"{w['plain_ms']:.1f} ms, bound {w['bound_ms']:.4f} ms "
         f"({w['bound_by']})")


def _copy_snapshot(snap):
    """A snapshot whose arrays no later wave can touch (the incremental
    encoder hands out its resident planes, which it mutates in place)."""
    import dataclasses

    import numpy as np

    return dataclasses.replace(snap, **{
        f.name: getattr(snap, f.name).copy()
        for f in dataclasses.fields(snap)
        if isinstance(getattr(snap, f.name), np.ndarray)})


def _scheduler_phase(dev, n_nodes=5_000, n_pending=10_000, n_churn=2_000,
                     n_deleted=1_000, n_last=1_024, wave_size=1_024,
                     plain_wave=1, count_launches=True) -> dict:
    """Phase 7: the scheduler's causal wave loop (BatchScheduler over the
    port's ConfigFactory and FakeClient) binds a north_star cluster wave
    by wave, then churn, then a node add. Each wave's bindings are held
    against solve(encode_snapshot(...)) of the same state on ``dev``, one
    delta wave also against the plain version on the CPU."""
    import gc

    import numpy as np

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler.driver import ConfigFactory
    from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
    from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
    from kubernetes_tpu_torch.util import metrics

    # the cyclic garbage collector's pauses inside each wave: seconds, and
    # how many of them were full (generation 2) collections
    gc_acc = {"s": 0.0, "full": 0, "t": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gc_acc["t"] = time.perf_counter()
        else:
            gc_acc["s"] += time.perf_counter() - gc_acc["t"]
            gc_acc["full"] += info["generation"] == 2

    t0 = time.perf_counter()
    nodes, existing, pending, services = build_cluster(
        n_nodes, n_pending + n_churn + n_last)
    first, churn, last = (pending[:n_pending],
                          pending[n_pending:n_pending + n_churn],
                          pending[n_pending + n_churn:])
    new_node = api.Node(
        metadata=api.ObjectMeta(name=f"node-{n_nodes:05d}", labels={
            "zone": f"z{n_nodes % 16}", "disk": "ssd"}),
        spec=api.NodeSpec(capacity={"cpu": Quantity("16"),
                                    "memory": Quantity("64Gi")}))
    build_s = time.perf_counter() - t0

    class Recorded(BatchScheduler):
        """Keeps each wave's pod order, and one wave's snapshot and
        decisions, for the checks after the loop."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.orders: list = []
            self.kept: dict = {}

        def _prepare_wave(self, pods):
            prep = super()._prepare_wave(pods)
            self.orders.append(None if prep is None else prep[0])
            return prep

        def _solve_snap(self, snap, n_pending):
            d = super()._solve_snap(snap, n_pending)
            self.kept[len(self.orders) - 1] = (
                _copy_snapshot(snap) if len(self.orders) - 1 == plain_wave
                else None, d.chosen, d.scores, len(snap.pod_names))
            return d

    fc = FakeCluster(nodes, existing, first, services)
    factory = ConfigFactory(fc.client, node_poll_period=3600)
    fc.attach(factory)
    reg = metrics.default_registry()
    hist = {k: reg.histogram(f"scheduler_wave_{k}_seconds")
            for k in ("encode", "solve", "commit")}
    resyncs = reg.counter("scheduler_wave_encode_resyncs_total")
    replays = metrics.slipstream_metrics().resync_replay
    waves: list = []
    marks: list = []          # per wave: (bind-log length, nodes, deleted)
    deleted: set = set()
    try:
        sched = Recorded(factory.create(), factory, fc.client,
                         wave_size=wave_size, device=dev)
        t0 = time.perf_counter()
        fc.wait_synced()
        sync_s = time.perf_counter() - t0

        def drive(stage):
            """schedule_wave() until the FIFO is empty -> (pods bound,
            seconds from the first drain to the last commit)."""
            t_first = t_end = time.perf_counter()
            bound = 0
            while True:
                before = {k: h.sum() for k, h in hist.items()}
                r0, p0 = resyncs.total(), replays.total()
                gc0 = dict(gc_acc)
                l0 = commit_solver.solve_commit.launches
                marks.append((len(fc.bind_log), len(fc.nodes),
                              frozenset(deleted)))
                t_w = time.perf_counter()
                try:
                    n = sched.schedule_wave(timeout=0)
                except TimeoutError:
                    marks.pop()
                    break
                t_end = time.perf_counter()
                bound += n
                row = {"wave": len(waves), "stage": stage,
                       "pods": len(sched.orders[-1]), "bound": n,
                       "wave_s": t_end - t_w,
                       "launches": commit_solver.solve_commit.launches - l0,
                       "path": ("full" if resyncs.total() > r0 else
                                "replay" if replays.total() > p0
                                else "delta")}
                for k, h in hist.items():
                    row[f"{k}_s"] = h.sum() - before[k]
                row["gc_s"] = gc_acc["s"] - gc0["s"]
                row["gc_full"] = gc_acc["full"] - gc0["full"]
                waves.append(row)
            return bound, t_end - t_first

        gc.callbacks.append(on_gc)
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        loop_bound, loop_s = drive("north_star")
        fc.delete_bound(existing[:n_deleted])
        deleted.update(f"default/{p.metadata.name}"
                       for p in existing[:n_deleted])
        fc.add_pending(churn)
        churn_bound, churn_s = drive("churn")
        fc.add_node(new_node)
        fc.add_pending(last)
        node_bound, node_s = drive("node added")
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
    finally:
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        if not factory.stop(join=True, timeout=5.0):
            raise AssertionError("the factory's threads did not stop")

    # ---- the checks, after the loop --------------------------------------
    total = n_pending + n_churn + n_last
    if len(fc.bind_log) != total or len(fc.bound()) != \
            len(existing) - n_deleted + total:
        raise AssertionError(f"scheduler: {len(fc.bind_log)} of {total} "
                             f"pending pods bound")
    if count_launches and any(w["launches"] != 1 for w in waves):
        raise AssertionError(f"scheduler: commit_solve launches per wave "
                             f"{[w['launches'] for w in waves]}, want 1 each")
    if count_launches and plain_calls:
        raise AssertionError("scheduler: the loop ran the plain version")
    # the first wave and the first after the node add sync the full list;
    # every other wave takes the O(changed) delta
    paths = [w["path"] for w in waves]
    want = ["full" if k == 0 or (w["stage"] == "node added" and
                                 waves[k - 1]["stage"] != "node added")
            else "delta" for k, w in enumerate(waves)]
    if paths != want:
        raise AssertionError(f"scheduler: encode paths {paths}")
    node_list = sorted(fc.nodes, key=lambda n: n.metadata.name)
    t0 = time.perf_counter()
    for k, (mark, n_nodes_k, gone) in enumerate(marks):
        order = sched.orders[k]
        state = [p for p in existing
                 if f"default/{p.metadata.name}" not in gone]
        state += fc.bind_log[:mark]
        snap = encode_snapshot(node_list[:n_nodes_k], state, order, services)
        chosen, _ = bs.solve(snap, device=dev)
        want = {p.metadata.name: h for p, h in
                zip(order, bs.decisions_to_names(snap, chosen)) if h}
        nxt = marks[k + 1][0] if k + 1 < len(marks) else len(fc.bind_log)
        got = {p.metadata.name: p.spec.host for p in fc.bind_log[mark:nxt]}
        if got != want:
            raise AssertionError(f"scheduler wave {k}: bindings differ from "
                                 f"solve(encode_snapshot(...)) of its state")
        _snap, w_chosen, _w_scores, n_real = sched.kept[k]
        if (np.asarray(w_chosen)[n_real:] != -1).any():
            raise AssertionError(f"scheduler wave {k}: a padding row placed")
    full_check_s = time.perf_counter() - t0
    snap, w_chosen, w_scores, n_real = sched.kept[plain_wave]
    t0 = time.perf_counter()
    p_chosen, p_scores = bs.solve(snap, device="cpu")
    plain_s = time.perf_counter() - t0
    if not (np.array_equal(p_chosen, w_chosen)
            and np.array_equal(p_scores, w_scores)):
        raise AssertionError(f"scheduler wave {plain_wave}: decisions differ "
                             f"from the plain version")

    def split(stage):
        return [w for w in waves if w["stage"] == stage]

    return {
        "nodes": n_nodes, "existing": len(existing), "pending": n_pending,
        "churn_pending": n_churn, "deleted": n_deleted,
        "node_add_pending": n_last, "wave_size": wave_size,
        "build_cluster_s": build_s, "reflector_sync_s": sync_s,
        "waves": waves, "launches": launches,
        "loop_pods_per_s": loop_bound / loop_s, "loop_s": loop_s,
        "churn_pods_per_s": churn_bound / churn_s,
        "node_add_pods_per_s": node_bound / node_s,
        "full_encode_s": [w["encode_s"] for w in waves
                          if w["path"] == "full"],
        "delta_encode_s": [w["encode_s"] for w in split("north_star")[1:]
                           + split("churn")],
        "full_encode_check_s": full_check_s,
        "plain_wave": plain_wave, "plain_cpu_s": plain_s,
    }


def _preempt_loop_phase(dev, n_nodes=2_000, n_pending=1_000, wave_size=512,
                        count_launches=True) -> dict:
    """Phase 8: BatchScheduler over a FakeClient holding the priority
    cluster (2,000 full nodes, 8,000 resident pods in two bands, 1,000
    storm pods) in waves of ``wave_size``: each wave launches commit_solve
    once, every preempting placement binds with its victims through the
    FakeCluster's atomic evict+bind and its victims leave the stores, and
    each wave's bindings and victim sets equal the replay of
    solve(encode_snapshot(...)) of its state on ``dev``."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import preempt
    from kubernetes_tpu_torch.models.fixtures import build_priority_cluster
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler.driver import ConfigFactory
    from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
    from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
    from kubernetes_tpu_torch.util import metrics

    def key(p):
        return f"{p.metadata.namespace}/{p.metadata.name}"

    nodes, existing, pending, services = build_priority_cluster(n_nodes,
                                                                n_pending)

    class Recorded(BatchScheduler):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.orders: list = []

        def _prepare_wave(self, pods):
            prep = super()._prepare_wave(pods)
            self.orders.append(None if prep is None else prep[0])
            return prep

    fc = FakeCluster(nodes, existing, pending, services)
    factory = ConfigFactory(fc.client, node_poll_period=3600)
    # a failed pod stays out of the queue for this phase: the waves are
    # the drained storm only
    factory.backoff.initial = 3600.0
    fc.attach(factory)
    reg = metrics.default_registry()
    hist = {k: reg.histogram(f"scheduler_wave_{k}_seconds")
            for k in ("encode", "solve", "commit")}
    pmx = metrics.preemption_metrics()
    p0 = (pmx.attempts.total(), pmx.victims.total(),
          pmx.higher_evictions.total(), pmx.conflicts.total())
    waves: list = []
    marks: list = []
    try:
        sched = Recorded(factory.create(), factory, fc.client,
                         wave_size=wave_size, device=dev)
        fc.wait_synced()
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t_first = time.perf_counter()
        while True:
            before = {k: h.sum() for k, h in hist.items()}
            l0 = commit_solver.solve_commit.launches
            marks.append((len(fc.bind_log), len(fc.evict_log)))
            t_w = time.perf_counter()
            try:
                n = sched.schedule_wave(timeout=0)
            except TimeoutError:
                marks.pop()
                break
            row = {"wave": len(waves), "pods": len(sched.orders[-1]),
                   "bound": n, "wave_s": time.perf_counter() - t_w,
                   "launches": commit_solver.solve_commit.launches - l0}
            for k, h in hist.items():
                row[f"{k}_s"] = h.sum() - before[k]
            waves.append(row)
        loop_s = time.perf_counter() - t_first
        plain_calls = commit_solver.solve_commit_reference.calls
    finally:
        if not factory.stop(join=True, timeout=5.0):
            raise AssertionError("the factory's threads did not stop")

    # ---- the checks, after the loop --------------------------------------
    if len(waves) != -(-len(pending) // wave_size):
        raise AssertionError(f"priority loop: {len(waves)} waves")
    if count_launches and any(w["launches"] != 1 for w in waves):
        raise AssertionError(f"priority loop: commit_solve launches per "
                             f"wave {[w['launches'] for w in waves]}")
    if count_launches and plain_calls:
        raise AssertionError("priority loop: the plain version ran")
    evicted = {key(p) for p in fc.evict_log}
    if len(evicted) != len(fc.evict_log) or not evicted:
        raise AssertionError("priority loop: no eviction, or one twice")
    if evicted & {key(p) for p in fc.bound()} or any(
            factory.scheduled_pods.get_by_key(k) is not None
            for k in evicted):
        raise AssertionError("priority loop: a victim stayed in the stores")
    prio = {key(p): api.pod_priority(p) for p in existing + pending}
    index = {n.metadata.name: i for i, n in enumerate(nodes)}
    t0 = time.perf_counter()
    for k, (n_bound, n_evicted) in enumerate(marks):
        order = sched.orders[k]
        gone = {key(p) for p in fc.evict_log[:n_evicted]}
        state = [p for p in existing if key(p) not in gone]
        state += fc.bind_log[:n_bound]
        snap = encode_snapshot(nodes, state, order, services)
        chosen, scores = bs.solve(snap, device=dev)
        victims = preempt.assign_victims(
            chosen, scores, snap.band_prio,
            preempt.resident_from_pods(state, index), n_pods=len(order))
        want = {key(p): (h, sorted(f"{v.namespace}/{v.name}"
                                   for v in (vs or ())))
                for p, h, vs in zip(order, bs.decisions_to_names(snap, chosen),
                                    victims) if h}
        nxt = marks[k + 1][0] if k + 1 < len(marks) else len(fc.bind_log)
        got = {key(p): (p.spec.host, sorted(
            key(v) for v in fc.victims_of.get(key(p), ())))
            for p in fc.bind_log[n_bound:nxt]}
        if got != want:
            raise AssertionError(f"priority loop wave {k}: bindings or "
                                 f"victims differ from solve(encode_snapshot"
                                 f"(...)) of its state")
        for pkey, (_h, vs) in got.items():
            if any(prio[v] >= prio[pkey] for v in vs):
                raise AssertionError("priority loop: an equal-or-higher "
                                     "pod was evicted")
    check_s = time.perf_counter() - t0
    preempted = sum(1 for p in fc.bind_log if key(p) in fc.victims_of)
    d = (pmx.attempts.total() - p0[0], pmx.victims.total() - p0[1],
         pmx.higher_evictions.total() - p0[2], pmx.conflicts.total() - p0[3])
    if d[:3] != (preempted, len(fc.evict_log), 0):
        raise AssertionError(f"priority loop: scheduler_preemption_* "
                             f"{d} vs {preempted} preemptors, "
                             f"{len(fc.evict_log)} victims")
    return {"nodes": len(nodes), "existing": len(existing),
            "pending": len(pending), "wave_size": wave_size,
            "waves": waves, "bound": len(fc.bind_log),
            "preempted_pods": preempted, "victims": len(fc.evict_log),
            "conflicts": d[3], "loop_s": loop_s,
            "loop_pods_per_s": len(fc.bind_log) / loop_s,
            "replay_check_s": check_s}


def _log_preempt_loop(pl: dict) -> None:
    _log(f"[8] priority loop: {pl['nodes']} nodes, {pl['existing']} "
         f"resident, {pl['pending']} storm pods in waves of "
         f"{pl['wave_size']}: {pl['bound']} bound, {pl['preempted_pods']} "
         f"by preemption evicting {pl['victims']} ({pl['conflicts']} "
         f"conflicts); {pl['loop_pods_per_s']:.1f} pods/s "
         f"({pl['loop_s']:.3f} s)")
    for w in pl["waves"]:
        _log(f"     wave {w['wave']} {w['pods']:4d} pods, {w['bound']} bound:"
             f" encode {w['encode_s']:.4f} s, solve {w['solve_s']:.4f} s, "
             f"commit {w['commit_s']:.4f} s, wave {w['wave_s']:.4f} s, "
             f"launches {w['launches']}")
    _log(f"     every wave's bindings and victims == the replay of "
         f"solve(encode_snapshot) of its state ({pl['replay_check_s']:.1f} s)")


def _log_scheduler(sc: dict) -> None:
    _log(f"[7] scheduler: {sc['nodes']} nodes, {sc['existing']} existing, "
         f"{sc['pending']} + {sc['churn_pending']} + "
         f"{sc['node_add_pending']} pending in waves of {sc['wave_size']}; "
         f"{len(sc['waves'])} waves, {sc['launches']} commit_solve "
         f"launches; loop {sc['loop_pods_per_s']:.1f} pods/s "
         f"({sc['loop_s']:.3f} s), churn {sc['churn_pods_per_s']:.1f} "
         f"pods/s, node add {sc['node_add_pods_per_s']:.1f} pods/s")
    for w in sc["waves"]:
        _log(f"     wave {w['wave']:2d} {w['stage']:10s} {w['path']:6s} "
             f"{w['pods']:5d} pods: encode {w['encode_s']:.4f} s, solve "
             f"{w['solve_s']:.4f} s, commit {w['commit_s']:.4f} s, wave "
             f"{w['wave_s']:.4f} s; gc {w['gc_s']:.4f} s "
             f"({w['gc_full']} full)")
    _log(f"     every wave == solve(encode_snapshot) of its state "
         f"({sc['full_encode_check_s']:.1f} s); wave {sc['plain_wave']} == "
         f"plain version on the CPU ({sc['plain_cpu_s']:.1f} s)")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import build, commit_solver
    from kubernetes_tpu_torch.tools.kernel_time import card_line

    dev = torch.device("cuda", 0)
    record: dict = {}

    # 1. versions and the card
    card = card_line()
    _log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}; card: {card}")
    record["card"] = card
    record["torch"] = torch.__version__

    # 2. build
    t0 = time.perf_counter()
    build.build("commit_solve")
    record["build_s"] = time.perf_counter() - t0
    record["build_sources_s"] = build.build_seconds["commit_solve"]
    record["ptxas"] = _ptxas_report(build.build_logs["commit_solve"])
    _log(f"[2] built commit_solve in {record['build_s']:.2f}s (seconds per "
         f"source, compiled in parallel: "
         f"{ {k: round(v, 1) for k, v in record['build_sources_s'].items()} })")
    for fn, use in record["ptxas"].items():
        _log(f"    ptxas: {fn}: {use}")

    # 3. exhaustive spread check
    record["spread"] = _spread_exhaustive(dev)
    _log(f"[3] spread device function == plain version on all "
         f"{record['spread']['pairs']} pairs "
         f"({record['spread']['seconds']:.2f}s)")

    # 4. seeded waves
    record["fuzz"] = _fuzz(dev)
    _log(f"[4] {record['fuzz']['waves']} seeded waves "
         f"({record['fuzz']['pods']} pods, state layouts "
         f"{record['fuzz']['layouts']}): kernel == plain version "
         f"({record['fuzz']['seconds']:.2f}s)")

    # 4b. seeded waves with every policy extension and gangs
    record["extensions"] = _ext_fuzz(dev)
    ex = record["extensions"]
    _log(f"[4b] {ex['waves']} seeded extension waves ({ex['pods']} pods, "
         f"{ex['gang_waves']} with gangs, {ex['rolled_back_runs']} gang "
         f"runs rolled back, state layouts {ex['layouts']}): kernel == "
         f"plain version ({ex['seconds']:.2f}s)")
    for w in ex["wide"]:
        _log(f"     {w['nodes']}x{w['pods']} {w['extensions']}: state in "
             f"{w['layout']} memory ({w['dyn_shared_bytes']} B dynamic "
             f"shared), kernel {w['kernel_ms']:.3f} ms, plain "
             f"{w['plain_ms']:.1f} ms, bound {w['bound_ms']:.5f} ms "
             f"({w['bound_by']})")
    seen = set(record["fuzz"]["layouts"]) | set(ex["layouts"])
    if seen != {"shared", "global"}:
        raise AssertionError(f"the seeded waves ran only the {seen} state "
                             f"layout(s); both must be checked")

    # 4c. seeded int64 and preemption waves
    record["preemption"] = pr = _pre_fuzz(dev)
    _log(f"[4c] {pr['waves']} seeded int64/preemption waves ({pr['pods']} "
         f"pods; {pr['int64']} with int64 planes, {pr['bands_at_cap']} at "
         f"the {commit_solver.MAX_B}-band cap, {pr['unsorted']} with bands "
         f"out of order, {pr['gang_waves']} with gangs; "
         f"{pr['preempting']} pods placed by preemption evicting "
         f"{pr['victims']}; {pr['never_pods']} Never pods; state layouts "
         f"{pr['layouts']}): kernel == plain version "
         f"({pr['seconds']:.2f}s)")
    for w in pr["wide"]:
        _log(f"     {w['nodes']}x{w['pods']} {w['resource_type']} "
             f"{w['bands']} bands {w['kw']}: state in {w['layout']} memory "
             f"({w['dyn_shared_bytes']} B dynamic shared), kernel "
             f"{w['kernel_ms']:.3f} ms, plain {w['plain_ms']:.1f} ms, bound "
             f"{w['bound_ms']:.5f} ms ({w['bound_by']})")

    # 5. north_star, the main path
    ns = _wave_phase("north_star", dev, kernel_runs=7)
    record["north_star"] = ns
    _log_wave("5", ns)

    # 5b. affinity, its Policy read from a JSON file's text
    record["affinity"] = _wave_phase("affinity", dev, kernel_runs=5)
    _log_wave("5b", record["affinity"])

    # 5c. gang: 1,000 PodGroups of 8
    record["gang"] = _wave_phase("gang", dev, kernel_runs=5)
    _log_wave("5c", record["gang"])

    # 5d. north_star with decimal memory: int64 resource planes
    record["north_star_dec"] = _wave_phase("north_star_dec", dev,
                                           kernel_runs=5)
    _log_wave("5d", record["north_star_dec"])

    # 5e. priority: 2,000 full nodes, a storm that places by preemption
    record["priority"] = _wave_phase("priority", dev, kernel_runs=5)
    _log_wave("5e", record["priority"])

    # 6. binpack3, while time allows
    if time.perf_counter() - t_start < _BUDGET_S:
        bp = _wave_phase("binpack3", dev, kernel_runs=5)
        record["binpack3"] = bp
        _log_wave("6", bp)
    else:
        _log("[6] binpack3 skipped: time budget spent")

    # 7. the scheduler's wave loop at north_star width
    sc = _scheduler_phase(dev)
    record["scheduler"] = sc
    _log_scheduler(sc)

    # 8. the loop on the priority cluster: preemption with evict+bind
    record["priority_loop"] = pl = _preempt_loop_phase(dev)
    _log_preempt_loop(pl)
    record["total_s"] = time.perf_counter() - t_start

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    # one entry per instance family the main paths run: the int32 default
    # branch (north_star, launches over the scheduler loop), the int64
    # instances (north_star_dec) and the preemption branch (priority,
    # launches over the priority loop); no PyTorch call computes the
    # sequential commit, so library_ms is null
    entries = (("commit_solve", ns, sc["launches"]),
               ("commit_solve[int64 planes]", record["north_star_dec"],
                record["north_star_dec"]["launches"]),
               ("commit_solve[preemption]", record["priority"],
                sum(w["launches"] for w in pl["waves"])))
    kernels = {"kernels": [{
        "name": name, "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/commit_solve.cuh",
        "replaces": "kubernetes_tpu/ops/pallas_solver.py:772",
        "launches": launches, "max_abs_err": w["max_abs_err"],
        "ms": w["kernel_ms"], "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
        "library_ms": None} for name, w, launches in entries]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
