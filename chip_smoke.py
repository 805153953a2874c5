#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch).

Drives the port's main paths on one NVIDIA GPU — one scheduling wave
(API objects -> encode_snapshot -> solve, the hand-written CUDA
commit_solve kernel -> decisions_to_names) at the benchmark's north-star
width (5,000 nodes x 10,000 pending pods, default provider policy), the
benchmark's ``affinity``, ``gang`` and ``priority`` (preemption) waves and
north_star with decimal memory (int64 planes) at full width, and the
scheduler's wave loop (BatchScheduler) binding a north-star cluster wave
by wave, causal and pipelined, and preempting on the priority cluster,
and the scheduler binary (cmd/scheduler.py) binding a north-star cluster
through an apiserver process over HTTP, causal and pipelined with wave
tracing, the flight recorder and the unschedulability diagnosis, and the
shared solver daemon (solver/service.py, cmd/solverd.py) coalescing
concurrent north-star waves into one batched launch, one block per wave,
in process and under the binary, the serial oracle against the kernel's
decisions, the binaries under the race probe and the self-checks, the
device mesh (the node-sharded loop, its kernel crossover, the daemon's
mesh executor and the submesh) on four shards of the card, and the
scheduler binary against the apiserver's storage tier and worker fleet
(a kube-store and two apiserver workers sharing a segment, each killed
under load, then a durable apiserver alone, killed), the controller
manager's replication controllers binding through it on nodes its node
controller registered from an inventory cloud, an operator's kubectl
session putting nodes and pods in through the legacy wire, kubectl
drain through the descheduler and kubelets running what the card
placed, and a soak through kube-proxy to backends the card placed, with
the dns, logging and monitoring addons and the port's deploy script —
and holds the kernel against its plain PyTorch version. Phases:

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
4d. the batched launch: sixteen seeded waves of different shapes (two
   default north_star cuts, two zone anti-affinity, two gang, one int64
   and one preemption wave, about 1,500 nodes x 120 pods; then groups
   padded further to an odd node count and an odd group count, so that a
   wave's packed state is not a multiple of 4 bytes: two gang waves, an
   int64 wave with bands and one without, two int64 waves without bands,
   and two north_star cuts of about 6,800 nodes, whose state lives in
   global memory), grouped as the solver daemon groups them, each group
   padded to its per-axis maximum, all given to one
   ``solve_commit_batch``: every wave == the plain version (max abs err
   0) == its own unpadded single-wave launch, one launch per distinct
   launch key (shape and flags), and each group took the state layout
   and the kernel instance named for it;
5. north_star through ``solve``: exactly one kernel launch and no call of
   the plain version, decisions and scores bit-identical to the plain
   version, every pod bound; kernel time (median of CUDA-event timed
   runs), plain time, encode and wave seconds, pods/s; then the same
   objects encoded again, every pod's rows a hit of the encoder's row
   cache: its seconds, and its arrays equal to the first encode's;
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
   scheduler_preemption_* counters agree;
9. the scheduler binary: the port's apiserver binary
   (``kubernetes_tpu_torch.cmd.apiserver``, default flags) runs as a
   separate OS process in the cluster's place; the north-star cluster
   (5,000 nodes, 10,000 bound pods, 8 services) is seeded over HTTP with
   the port's client from 8 threads while a watch of pods and one of
   nodes read every create (logging the apiserver's creates/s; fails
   unless the watches saw every create, resourceVersions strictly
   increasing); the port's ``scheduler_server`` (``--algorithm
   tpu-batch --prewarm --metrics-port``) runs in a thread, lists and
   watches over the v1 wire, builds the kernel and solves one exemplar
   wave off its loop; once ``compile_prewarm_ready 1`` reads on
   /metrics and its caches hold the cluster, 1,000 pending pods are
   created from 4 threads. Fails unless every pod reads back bound from
   the apiserver, no node is over capacity and no host port doubled,
   each wave launched commit_solve once and the plain version never ran,
   each wave's bindings equal solve(encode_snapshot(...)) of its state,
   and /healthz answers healthy JSON. Logs the seeding seconds, the
   prewarm's, the load window, pods/s from the first create to the last
   bind seen through a watch, each wave's encode, solve and commit
   seconds and the garbage collector's pauses;
9b. the binary as its own process with ``--algorithm tpu-batch`` and a
   Policy with a negative priority weight, against a fresh apiserver
   process (50 nodes, 200 pending pods): it must log its fallback to
   serial, bind every pod, and place each where the port's
   ``GenericScheduler`` puts it one pod at a time. Every child process
   is stopped on the way out, on failure too;
7p. (run after 7) the pipelined loop: the causal and the pipelined
   ``BatchScheduler`` each drive a fresh, identical phase 7 cluster
   (5,000 nodes, 10,000 bound, 10,000 pending synced before ``run()``,
   waves of 1,024), then both again with one foreign bind injected into
   the scheduled store during the first solve. Fails unless each pair's
   placements are equal pod for pod, the clean pipelined run hit a
   speculation and the injected one invalidated on ``store_delta``,
   every commit_solve launch is one solve (the committed waves plus the
   discarded speculative solves) and the plain version never ran. Logs
   both loops' pods/s, the overlapped seconds, hits, invalidations by
   reason and the per-wave encode/solve/commit medians (from the waves'
   tracing spans);
7e. the diagnosis: north_star with 256 unschedulable pods appended
   (oversized, selector-mismatched, port-clashing, pinned to a missing
   node); ``explain_wave`` on the card and on the CPU must give equal
   counts and messages, each with the constructed dominant reason;
9c. the binary with ``--algorithm tpu-batch --pipeline --trace
   --flightrec --prewarm`` against a fresh apiserver process seeded as in
   phase 9; 1,000 pending, 20 oversized and 20 with a node selector no
   node matches. Fails unless every other pod binds to a valid host, the
   pipeline's waves counter equals its committed waves, a FailedScheduling
   event of each kind carries the breakdown line (summing to 5,000, the
   constructed dominant reason), the unschedulable families sum, the
   span shard of /debug/trace holds the wave stages and a speculative
   encode (written as a Chrome trace to
   ``chiprun_out/phase9c_trace.json``), /debug/vars holds the pipeline
   waves series and its rate, and the launches are accounted for;
10. the solver daemon: a ``SolverService`` on the card in this process
   (gather window 50 ms) and four client threads, each with its own
   ``RemoteSolver`` (delta wire on) and its own north_star cluster (5,000
   nodes, seeded), each shipping 6 waves of 1,024 pods through its
   ``IncrementalEncoder``, released together at a barrier every round.
   Fails unless some device solve coalesced two or more waves, the
   launches equal the daemon's kernel-path solves, the plain version
   never ran, every reply equals the in-process ``solve(snap)`` of the
   same wave, and every wave after a client's first rode the delta wire.
   Logs the group sizes, the bytes shipped against the full frames, and
   the batched launch alone (CUDA events) over k = 1, 2, 4, 8 and 16 of
   the first round's waves, k = 4 against its plain version;
10b. ``python -m kubernetes_tpu_torch.cmd.solverd --prewarm`` as its own
   process and the scheduler binary (``--algorithm tpu-batch --prewarm
   --solver-addr``) against a fresh apiserver process holding north_star's
   nodes, bound pods and services, then 1,000 pending pods. Fails unless
   every pod binds within capacity, every wave went to the daemon (no
   fallback, no busy wave, no launch in the scheduler's process) and the
   daemon's ``solverd_coalesced_waves_total`` equals the remote waves;
11. the serial oracle (``models/oracle.py``, run in spawned worker
   processes while the card solves) against commit_solve's decisions:
   (a) phase 4b's extension and gang waves (but the ghost-anchor cases,
   which the serial scheduler cannot look up) and its 1,500 and 2,100-node
   waves == ``solve_serial`` (``gangs`` where the wave has them); (b)
   north_star's 5,000 nodes, 10,000 bound pods and 8 services with its
   first 64 pending pods == ``solve_serial`` (a quarter of
   ``_ORACLE_NS_PODS``, the largest count the oracle takes in 60 s on a
   build host's CPU); (c) phase 4c's preemption waves without gangs and
   its 1,500-node wave == ``preempt_serial``, node and victim set; (d)
   64 of phase 7e's unschedulable pods (the same four kinds) once its
   10,000 pending are bound where the kernel
   put them: ``explain_wave`` on the card count-identical to
   ``explain_serial``. Each compared wave is one counted launch of
   ``solve`` and is timed alone (CUDA events); logs each part's waves,
   pods compared, oracle seconds and kernel milliseconds;
12. the apiserver and scheduler binaries as processes with
   ``KTPU_RACE=1`` (1 us switch interval, locksmith armed) and
   ``KTPU_DEBUG=1`` (the self-checks), the scheduler with ``--algorithm
   tpu-batch --pipeline`` under the zone anti-affinity Policy: 500 nodes,
   500 pending from 4 threads, then 50 deletes and 100 creates at a
   higher priority. Fails unless every pod binds within capacity, both
   exit cleanly, neither printed a locksmith report, a failed check or a
   fallback to serial, and /metrics shows the waves solved on the card
   with commit_solve launches. Its pods/s is a race run, not a speed;
13. the device mesh (parallel/mesh.py, models/submesh.py,
   solver/mesh_exec.py) on a virtual mesh of four node shards on the card
   (``make_mesh([cuda:0] * 4)``): (a) the ``mesh`` shape (10,000 nodes x
   2,048 pods, default policy) through the sharded loop
   (``solve_sharded(..., prefer_kernel=False)``) == the single-device
   ``solve_scan`` == commit_solve's decisions, no decision on a pad node,
   each timed on the host clock, with ``shard_memory_report``'s bytes per
   device; (b) the crossover: the same wave through ``solve(snap,
   mesh=mesh)``, exactly one commit_solve launch and no sharded loop (the
   phase's counted main path); (c) 33,152 nodes x 256 pods, past the
   narrow instances, through ``solve(snap, mesh=mesh)``: the crossover's
   one launch of a large instance, no sharded loop, == the single-device
   ``solve_scan``; a wave beyond the kernel's domain at the same node
   count (32 pods, 40 priority bands: more than its 32) through the
   sharded loop == ``solve_scan``; and a preemption wave (phase 5e's
   generator, full nodes in two bands) and a zone anti-affinity wave
   (phase 4b's), 1,500 x 120 each, sharded == single-device, some pod
   placed by preemption; (d) a
   ``MeshExecutor`` on the same mesh (dispatch shard, probe all) serving
   an ``IncrementalEncoder`` churn at 10,000 nodes, 5 waves of 256, each
   == ``solve(snap)``: the first a full transfer, the rest delta scatters
   with no reshard, no parity divergence; (e) a late-churn wave (10,000
   nodes, 1,500 free) on the executor's single-device layout: compacted
   (``plan_wave``) == the full solve, counted by
   ``solverd_submesh_*``, the compacted wave one commit_solve launch.
14. The fleet. (a) The reference's production topology: one kube-store
   process (``cmd.storeserver --shards 4 --data-dir``, a
   ``DurableStripedStore``), a share segment this script creates, two
   apiserver workers on one port (``--store-server --reuse-port
   --share-seg --share-worker i``) and the scheduler binary in a thread
   (``--algorithm tpu-batch --prewarm``): north_star seeded through the
   port, then 1,000 pending from 4 threads that resend through the
   outages; once a watch has seen a third bound the kube-store is
   SIGKILLed between two waves and respawned, once two thirds, worker 0.
   Every pod bound exactly once within capacity, every acknowledged
   create, bind and marker write read back, the store's recovery
   disclosed up to an index at or above every resourceVersion
   acknowledged before its kill, both workers served, a frame seed
   published by one worker and imported by the other, the ledger
   exact with a backlog of 0, one launch a wave, no plain version, each
   wave == the plain version and == solve(encode_snapshot(...)) of its
   state. (b) One apiserver with ``--data-dir`` (a ``DurableStore``),
   north_star's nodes, 2,000 pending; SIGKILLed and respawned on its port
   and directory once half are bound, which the binary rides; the same
   checks and the recovery on its /healthz;
15. the controller manager feeding the card: the port's kube-apiserver
   (``--cloud-provider inventory``) and kube-controller-manager
   (``--cloud-provider inventory --node-sync-period 1``) as processes
   over an inventory file of 5,000 instances (north_star's capacities,
   no labels), the scheduler binary in a thread. The NodeController
   registers the 5,000 nodes and writes their conditions (nodes/s
   logged); north_star's 8 services and 10,000 residents are seeded;
   20 RCs ``rc-{a}-{v}`` of 50 (4 apps ``app-{a}`` of 5 versions, the
   ``v = 0`` templates with host port ``7000 + a``) are created, and the
   ReplicationManager's 1,000 pods bind (pods/s from the first RC
   create to the last bind); the inventory is rewritten without 100
   instances: their nodes and pods go, the RCs recreate what they lost
   and it binds on the 4,900 left (seconds to recover); ``rc-0-1``
   scales to 30 and ``rc-1-1`` to 150. Each step waits until every RC
   stands at its count, bound, nothing on a departed node. Fails unless
   each wave launched commit_solve once, equals the plain version and
   ``solve(encode_snapshot(...))`` of the encoder's own state, no node
   is over capacity, no host port doubled, the scale-down took only its
   RC's pods, the manager exits 0 on SIGTERM and no replica was created
   beyond the targets (the reference's racing syncs create some; the
   port syncs one RC at a time); the full and delta encodes are logged.
16. an operator's kubectl session feeding the card: the apiserver and
   the controller manager (no cloud) as processes, the binary in a
   thread, kubectl as processes over a kubeconfig it writes itself
   (``config set-cluster``/``set-context``/``use-context``;
   ``api-versions`` prints v1, v1beta1, v1beta2; ``cluster-info``,
   ``version``, one request through ``proxy --once``). north_star's
   5,000 nodes go in as one v1beta1 MinionList file and its 8 services
   as a v1beta2 List, both by ``kubectl create -f``; its first 750
   pending pods as a v1beta1 PodList, under a v1beta1 watch: each reads
   back bound in v1beta1 (``desiredState.host``) as in v1, and the
   legacy field selector ``DesiredState.Host=`` lists none. Then the 50
   nodes with the most free CPU are cordoned, ``run-container web`` of
   250 is resized to 500 (every pod bound, none on a cordoned
   node), ``small`` (10) is rolled to ``small-v2``, a 64-CPU pod is
   described with its FailedScheduling breakdown, and everything is
   stopped and deleted again. Fails on any kubectl exit but 0, unless
   each wave launched commit_solve once and equals the plain version
   and ``solve(encode_snapshot(...))`` of the encoder's state.
17. kubectl drain and the kubelets: (a) at the reference's fragment
   storm's width, the apiserver process with north_star's 5,000 nodes, 8
   services and first 8,000 residents, the binary in a thread; 8 nodes
   drained by kubectl processes; 500 pods created while the binary's
   loop is held, the port's kube-descheduler started as a process
   (``--period 1 --qps 1``): it declines with ``pending_work``, which
   releases the binary; then it migrates. Fails unless every drained
   node ends empty, no pod moved twice or was lost, every placement
   fits, no migration came before the decline, no score regression and
   a fragmentation gauge that never rises. (b) The apiserver and the
   controller manager as processes, the binary in a thread, 4 kubelet
   processes with the process runtime (5 CPUs, 8Gi): an RC of 120 pods
   behind a service runs as process groups under the native pause
   sandbox (built by g++ into ``kubernetes_tpu_torch/kubelet/_build``;
   the phase prints it), the endpoints name all 120; ``kubectl drain
   node-0`` and the descheduler move its pods, its runtime ends with no
   live process, and all 120 run again on the other nodes. Each wave of
   both launched commit_solve once and equals the plain version and
   ``solve(encode_snapshot(...))`` of the encoder's state.
18. the service path and the deploy script: (a) the shape
   ``kubernetes_tpu_torch/deploy/inventory-up.sh`` deploys, each server
   a process started by its hyperkube name (apiserver and controller
   manager over an inventory of north_star's 5,000 instances, each at a
   loopback address of its own; 4 kubelets with the process runtime on
   instances labelled ``role=serving`` by kubectl; kube-proxy; the dns
   and monitoring addons; the logging addon by its module), the binary
   in a thread: 120 RCs of one hostnames backend each (host network,
   its own port), placed by the card behind the service ``hostnames``.
   Fails unless every backend runs on a serving node and the endpoints
   name it, a 10 s soak of 4 clients through kube-proxy has no error
   and reaches all 120, 48 deletes over 20 s under the clients (errors
   recorded) settle into a second clean soak, every wave launched
   commit_solve once over the 5,000 nodes and is exact, every service
   resolves through the dns process (a deleted one NXDOMAIN within 5
   s), the logging process returns every start line within 20 s and the
   monitoring process scrapes the 4 kubelets of 5,000 nodes. (b) The
   script itself under bash on a 2-instance inventory: its fixed ports
   free first, the cluster healthy, a kubectl pod placed by its
   ``tpu-batch`` scheduler process (which holds the card) and Running,
   the addons answering, and nothing left after SIGTERM.
19. the conformance tools on the card: (a) the port's all-in-one
   cluster (``cmd.standalone.standalone_server`` with ``--nodes 3
   --algorithm tpu-batch --device cuda``) in a thread, and the port's e2e
   driver (``tools/e2e.py --master``) at it: all nine suites pass (pods,
   replication, services, events, secrets, watch, kubectl, guestbook,
   update-demo, with kubectl processes and the ``examples/`` manifests),
   each wave launched commit_solve once, equals the plain version and
   ``solve(encode_snapshot(...))`` of the encoder's state, and the plain
   version never ran; each suite's seconds. (b) The port's stress harness
   (``tools/stress.run``, the tpu-batch scheduler on the card, 15 s, 4
   writers): CLEAN (every survivor bound, a final write accepted, no
   escaped loop exception), at least one launch, no plain call, every
   wave equal to the plain version, the switch interval restored.
20. the kernel's cluster instances (a wave past 32,768 nodes, 31 service
   groups or peer totals of 2^15 runs on a thread-block cluster of up to
   16 SMs; models/fixtures ``planet`` and ``services64``): (a) planet
   (40,000 nodes x 10,000 pods, two services of 40,000 peers each: int32
   counts) and services64 (north_star with 64 services: 64 groups)
   through ``solve``, one launch of a cluster instance each, bit-identical
   to the plain version on the card; kernel ms (CUDA events), the
   cluster's blocks, the slices' layout and a block's dynamic shared
   memory, ptxas' report of the instance, bound; (b) phase
   7's loop on the planet cluster, 3 waves of 1,024, one launch a wave,
   no plain call, each wave held as phase 7 holds it; (c) the spread
   device function against the plain version beyond 2^15: every count of
   the totals 2^k - 1, 2^k and 2^k + 1 for k = 15..23, and 2^20 seeded
   pairs below 2^24; (d) nine seeded large waves (64 and 1,024 groups,
   33,000 nodes, peer totals past 2^15; zones, anchors, gangs, label
   planes, preemption, int64 planes; both slice layouts): kernel ==
   plain version, at the wrapper's cluster size and at a second one (2
   blocks where the wrapper took more, else 4), so block boundaries fall
   inside every branch.

Phase 2 also prints whether the one-block instances' ptxas reports are
those recorded in ``kubernetes_tpu_torch/tools/ptxas_reference.json``
(or which differ), and fails if an instance's static shared memory
passes the room the wrapper keeps for it.

Each full shape and each wide seeded wave logs the state layout it took
and its dynamic shared memory. Any mismatch or error exits non-zero. Run
from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
device and nvcc, and exits non-zero without printing a result when either
the device or the port's package is missing. A record of every number
goes to ``chiprun_out/chip_smoke.json``, the apiservers' and the
binaries' output to ``chiprun_out/phase9*.log``, ``phase10b_*.log``,
``phase12_*.log``, ``phase14*.log``, ``phase15_*.log``,
``phase16_*.log``, ``phase17*.log`` and ``phase18*.log``.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import re
import statistics
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
    bound = bs.peer_bound_of(snap)
    if not commit_solver.eligible(inp, snap.policy, bound):
        raise AssertionError("wave outside the kernel's domain")
    return commit_solver.prepare(inp, snap.policy, snap.has_gangs, bound)


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
    kernel instance, keyed by the instance's resource type, branch set,
    state layout and batching
    (``commit_solve<int32,pre,aff,anti,gang,static,shared,batch>`` with 0/1
    flags), a cluster instance by its resource and peer-count types and
    slice layout (``commit_solve_large<int32,counts16,shared>``), as
    ``commit_solver.instance_of`` names them (less the cluster's size, a
    launch parameter), or the kernel's name."""
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
                              r"ELb([01])ELb([01])ELb([01])ELb([01])"
                              r"ELb([01])E", entry)
            large = re.search(r"commit_solve_cluster_kernelI([ix])([si])"
                              r"Lb([01])E", entry)
            name = entry
            if flags:
                res = "int32" if flags.group(1) == "i" else "int64"
                name = (f"commit_solve<{res},"
                        f"{','.join(flags.groups()[1:8])}>")
            elif large:
                res = "int32" if large.group(1) == "i" else "int64"
                counts = 16 if large.group(2) == "s" else 32
                layout = "shared" if large.group(3) == "1" else "global"
                name = f"commit_solve_large<{res},counts{counts},{layout}>"
            elif "spread_eval" in entry:
                name = "spread_eval"
            out[name] = f"{m.group(0)}; {frames.get(entry, '')}"
            entry = None
    return out


def _ptxas_of(report: dict, instance: str) -> str:
    """ptxas' line for ``instance`` (``commit_solver.instance_of``'s name;
    a cluster instance's without its size)."""
    return report.get(re.sub(r",c\d+>$", ">", instance), "not reported")


def _ptxas_against_reference(report: dict) -> str:
    """The one-block instances' ptxas reports against the recorded ones
    (``tools/ptxas_reference.json``): "same as the recorded reports", or
    each instance whose report differs, is new or is missing."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kubernetes_tpu_torch", "tools",
                        "ptxas_reference.json")
    with open(path) as fh:
        want = json.load(fh)
    got = {k: v for k, v in report.items() if k.startswith("commit_solve<")}
    diff = [f"{k}: {want.get(k, 'missing')} -> {got.get(k, 'missing')}"
            for k in sorted(set(want) | set(got)) if want.get(k) != got.get(k)]
    if not diff:
        return (f"the {len(got)} one-block instances: same as the recorded "
                f"reports")
    return (f"the one-block instances: {len(diff)} of {len(want)} differ "
            f"from the recorded reports: " + "; ".join(diff))


def _static_smem_within_reserve(report: dict) -> None:
    """Each instance's static shared memory (ptxas' report) fits the room
    the wrapper keeps for it when it sizes a block's dynamic shared memory
    (``commit_solver.STATIC_SMEM``, ``CLUSTER_STATIC_SMEM``); else a wave
    that the wrapper reckons fits would be refused at launch."""
    from kubernetes_tpu_torch.ops import commit_solver

    for name, line in report.items():
        m = re.search(r"(\d+) bytes smem", line)
        limit = (commit_solver.CLUSTER_STATIC_SMEM
                 if name.startswith("commit_solve_large<")
                 else commit_solver.STATIC_SMEM
                 if name.startswith("commit_solve<") else None)
        if m and limit is not None and int(m.group(1)) > limit:
            raise AssertionError(f"{name}: {m.group(1)} B of static shared "
                                 f"memory, past the {limit} B the wrapper "
                                 f"keeps for it")


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
              ghost=False, n_services=3, peers=0):
    """A seeded wave and the BatchPolicy that uses the named extensions:
    ``anti`` zone anti-affinity labels (0-2), ``aff`` service-affinity
    labels (0-2), label preferences, label presence, gangs (some sized
    to oversubscribe the cluster), and an existing service peer on a host
    that is not a node (``ghost``). Pods pick among ``n_services``;
    ``peers`` zero-request residents of the first are spread over the
    nodes after the rest (``_zero_peers``)."""
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
        for s in range(n_services)]

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
                labels=({"app": f"a{rng.randrange(n_services)}"}
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
    existing += _zero_peers(nodes, peers)
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


def _zero_peers(nodes, n: int, prio=None):
    """``n`` residents of service ``a0`` that request nothing, round robin
    over ``nodes``: peer totals past 2^15 without filling a node."""
    from kubernetes_tpu_torch.api import types as api

    return [api.Pod(
        metadata=api.ObjectMeta(name=f"z{i}", namespace="default",
                                uid=f"uid-z{i}", labels={"app": "a0"}),
        spec=api.PodSpec(host=nodes[i % len(nodes)].metadata.name,
                         priority=prio,
                         containers=[api.Container(name="c", image="i")]),
        status=api.PodStatus(host=nodes[i % len(nodes)].metadata.name))
        for i in range(n)]


def _pre_wave(rng: random.Random, n_nodes: int, n_pods: int, n_bands: int,
              wide=False, gangs=False, anti=0, aff=0, n_services=2, peers=0):
    """A seeded preemption wave and its BatchPolicy: nodes about full of
    resident pods at ``n_bands`` distinct priorities, then pending pods
    above every band, between bands, equal to one, below all, and some
    with PreemptionPolicy=Never. ``wide``: memory in decimal units beside
    binary ones, and one node of 1 TiB + 3 B, so the resource planes are
    int64. ``gangs``: some pending PodGroups; ``anti``/``aff``: zone
    anti-affinity and service-affinity labels; ``n_services`` and ``peers``
    as in ``_ext_wave`` (the peers in the lowest band)."""
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
        for s in range(n_services)]

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
                labels=({"app": f"a{rng.randrange(n_services)}"}
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
    existing += _zero_peers(nodes, peers, min(bands))
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


# ---- phase 4d: the batched launch against its plain version ---------------

# (family, seed, node and pod fractions of the phase's width, group): eight
# waves, two of a family but int64 and preemption, of different shapes,
# grouped as the daemon groups them; then the groups that pad to an odd
# node count and an odd group count ("odd-*", _odd_target): a gang group
# (the checkpoint is per wave), int64 with and without bands, int64 with
# no bands (the int64 instance without preemption), and a group too wide
# for shared memory (its node fractions are of ``n_global``)
_BATCH_CASES = [
    ("default", 700, 1.0, 1.0, ""), ("default", 701, 0.9, 0.8, ""),
    ("anti", 710, 1.0, 1.0, ""), ("anti", 711, 0.95, 0.9, ""),
    ("gang", 720, 1.0, 1.0, ""), ("gang", 721, 0.9, 1.1, ""),
    ("int64", 730, 1.0, 1.0, ""), ("preempt", 740, 0.8, 1.0, ""),
    ("gang", 722, 1.0, 1.0, "odd-gang"), ("gang", 723, 0.9, 0.9, "odd-gang"),
    ("int64", 731, 1.0, 1.0, "odd-int64"),
    ("int64flat", 732, 0.9, 1.0, "odd-int64"),
    ("int64flat", 733, 1.0, 1.0, "odd-int64flat"),
    ("int64flat", 734, 0.9, 0.9, "odd-int64flat"),
    ("default", 750, 1.0, 1.0, "odd-global"),
    ("default", 751, 0.97, 0.9, "odd-global"),
]

# the instance each group of two or more waves takes on the card
# (commit_solver.instance_of: int32|int64, pre, aff, anti, gang, static,
# shared, batch)
_BATCH_INSTANCES = {
    "default": "commit_solve<int32,1,1,1,0,1,1,1>",
    "anti": "commit_solve<int32,0,0,1,0,0,1,1>",
    "gang": "commit_solve<int32,0,0,0,1,0,1,1>",
    "odd-gang": "commit_solve<int32,0,0,0,1,0,1,1>",
    "odd-int64": "commit_solve<int64,1,1,1,0,1,0,1>",
    "odd-int64flat": "commit_solve<int64,0,1,1,0,1,1,1>",
    "odd-global": "commit_solve<int32,0,0,0,0,0,0,1>",
}


def _batch_wave(family: str, rng: random.Random, n_nodes: int,
                n_pods: int):
    """One seeded wave of a phase 4d family -> its snapshot. The anti and
    gang families fix the spread weight, so their two waves share one
    policy and pad together; the preemption wave runs the default policy,
    so the default waves (no bands) pad to its bands. ``int64flat`` is
    north_star's objects with one node of 1 TiB + 3 B: int64 planes, no
    bands."""
    import dataclasses

    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot

    if family in ("default", "int64flat"):
        # north_star's objects (no priority bands), cut by the case
        from kubernetes_tpu_torch.models.fixtures import build_cluster
        nodes, existing, pending, services = build_cluster(n_nodes, n_pods)
        rng.shuffle(pending)
        if family == "int64flat":
            nodes[0].spec.capacity["memory"] = Quantity((1 << 40) + 3)
        return encode_snapshot(nodes, existing, pending, services)
    if family in ("anti", "gang"):
        kw = dict(anti=1) if family == "anti" else dict(gangs=True)
        wave, policy = _ext_wave(rng, n_nodes, n_pods, **kw)
        return encode_snapshot(
            *wave, policy=dataclasses.replace(policy, w_spread=1))
    wave, policy = _pre_wave(rng, n_nodes, n_pods, 3 if family == "int64"
                             else 4, wide=family == "int64")
    return IncrementalEncoder(policy).encode(*wave)


def _odd_target(target: dict) -> dict:
    """A group target grown to an odd node count and an odd group count
    (pad nodes and pad groups decide nothing): one wave's packed state is
    then not a multiple of 4 bytes, so in a batched launch every wave
    after the first would start misaligned but for the per-wave stride
    (commit_solver.state_stride)."""
    t = dict(target, N=target["N"] | 1, G=target["G"] | 1)
    t["N1"] = t["N"] + 1
    return t


def _check_taken(taken: dict) -> None:
    """Phase 4d at its full widths: each group of ``_BATCH_INSTANCES``
    took the kernel instance named for it (the seventh flag is the state
    layout: the "odd-global" group and the int64 group with bands keep
    their state in global memory), and each "odd-*" group's state is not
    a multiple of 4 bytes."""
    for name, want in _BATCH_INSTANCES.items():
        got = taken[name]
        if got["instance"] != want:
            raise AssertionError(f"phase 4d group {name}: instance "
                                 f"{got['instance']} ({got['layout']} "
                                 f"layout), want {want}")
        if name.startswith("odd-") and got["state_bytes"] % 4 == 0:
            raise AssertionError(f"phase 4d group {name}: state of "
                                 f"{got['state_bytes']} B, a multiple of 4")


def _batch_phase(dev, n_nodes=1_500, n_pods=120, n_global=6_801,
                 count_launches=True) -> dict:
    """Phase 4d: the waves of ``_BATCH_CASES`` grouped as the solver
    daemon groups them (policy, gangs, resource type, label counts; the
    case's group name splits what would arrive in different windows),
    each group padded to its per-axis maximum (solver/service.py), the
    "odd-*" groups further to an odd node and group count, and all of
    them given to ONE ``solve_commit_batch``. Fails unless every wave
    equals the plain version over its padded inputs and the wave's own
    unpadded single-wave solve (max abs err 0); on the card also unless
    the call launched once per distinct launch key, every group took the
    state layout and kernel instance ``_BATCH_INSTANCES`` names for it
    (the "odd-global" group the global layout), and the odd groups' state
    is not a multiple of 4 bytes."""
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.solver.service import (_dims_of, _pad_inputs,
                                                     _target_dims)

    t0 = time.perf_counter()
    snaps = [_batch_wave(fam, random.Random(seed),
                         int((n_global if g == "odd-global" else n_nodes)
                             * fn), int(n_pods * fp))
             for fam, seed, fn, fp, g in _BATCH_CASES]
    hosts = [bs.snapshot_to_host_inputs(s) for s in snaps]
    groups: dict = {}
    for i, (snap, host) in enumerate(zip(snaps, hosts)):
        key = (_BATCH_CASES[i][4], snap.policy, snap.has_gangs,
               str(host.cap.dtype), host.node_aff_vals.shape[1],
               host.zone_idx.shape[0])
        groups.setdefault(key, []).append(i)
    padded: list = [None] * len(snaps)
    for key, idx in groups.items():
        target = _target_dims([_dims_of(hosts[i]) for i in idx])
        if key[0]:
            target = _odd_target(target)
        for i in idx:
            padded[i] = _pad_inputs(hosts[i], target)
    cis = []
    for i, snap in enumerate(snaps):
        if not commit_solver.eligible(padded[i], snap.policy,
                                      bs.peer_bound_of(snap)):
            raise AssertionError(f"phase 4d wave {i}: outside the kernel's "
                                 f"domain")
        cis.append(commit_solver.prepare(bs.ship_inputs(padded[i], dev),
                                         snap.policy, snap.has_gangs))
    keys = {commit_solver.launch_key(ci) for ci in cis}
    # the instance and layout each group takes, named by its first case's
    # group or family
    taken = {}
    for key, idx in groups.items():
        ci = cis[idx[0]]
        name = key[0] or _BATCH_CASES[idx[0]][0]
        taken[name] = {"instance": commit_solver.instance_of(ci, len(idx)),
                       "layout": _layout(ci)[0], "waves": len(idx),
                       "state_bytes": commit_solver.state_bytes(
                           *commit_solver._dims(ci))}
    l0 = commit_solver.solve_commit.launches
    out = commit_solver.solve_commit_batch(cis)
    launches = commit_solver.solve_commit.launches - l0
    if count_launches:
        if launches != len(keys):
            raise AssertionError(f"phase 4d: {launches} launches for "
                                 f"{len(keys)} launch keys")
        _check_taken(taken)
        for name in _BATCH_INSTANCES:
            if taken[name]["instance"] not in \
                    commit_solver.solve_commit.instances:
                raise AssertionError(f"phase 4d group {name}: "
                                     f"{taken[name]['instance']} never "
                                     f"launched")
    max_abs_err = 0
    waves = []
    for i, (ci, snap, (c, w)) in enumerate(zip(cis, snaps, out)):
        fam, group = _BATCH_CASES[i][0], _BATCH_CASES[i][4]
        pc, pw = commit_solver.solve_commit_reference(ci)
        sc, sw = commit_solver.solve_commit(_inputs(snap, dev))
        P = sc.shape[0]
        for got, want, what in ((c, pc, "plain version"),
                                (w, pw, "plain version"),
                                (c[:P], sc, "unpadded solo solve"),
                                (w[:P], sw, "unpadded solo solve")):
            if not torch.equal(got, want):
                k = int((got != want).nonzero()[0])
                raise AssertionError(f"phase 4d wave {i} ({fam}): differs "
                                     f"from the {what} at pod {k}")
        max_abs_err = max(max_abs_err, int((c - pc).abs().max()),
                          int((w - pw).abs().max()))
        waves.append({"family": fam, "group": group or fam,
                      "nodes": len(snap.node_names), "pods": P,
                      "padded_nodes": ci.cap.shape[1],
                      "padded_pods": ci.smask.shape[0],
                      "padded_groups": ci.counts0.shape[0],
                      "resource_type": str(ci.cap.dtype).split(".")[-1],
                      "bands": ci.band.shape[0],
                      "placed": int((c[:P] >= 0).sum())})
    return {"waves": waves, "groups": len(groups), "taken": taken,
            "launch_keys": len(keys), "launches": launches,
            "max_abs_err": max_abs_err,
            "seconds": time.perf_counter() - t0}


def _timed_ms(dev, fn, runs: int):
    """``kernel_time.event_ms`` on a card (CUDA events); on the CPU the
    host clock around each call, the same (median, all, last result)."""
    from kubernetes_tpu_torch.tools.kernel_time import event_ms

    if _device_type(dev) == "cuda":
        return event_ms(fn, runs)
    times, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, out


def _wave_phase(name: str, dev, kernel_runs: int, reencode: bool = False,
                size=None, count_launches: bool = True) -> dict:
    """One wave of ``name`` at full width through ``encode_snapshot`` and
    ``solve``, held against the plain version. With ``reencode`` the same
    objects are encoded a second time after the wave, every pod's rows a
    hit of the encoder's row cache, and the two encodes' arrays must be
    equal. ``size`` (nodes, pending pods) builds the shape's cluster at
    another size (a CPU run's; the priority shape has none)."""
    import dataclasses

    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import gang
    from kubernetes_tpu_torch.models.fixtures import (FULL_SHAPES,
                                                      build_cluster,
                                                      build_shape)
    from kubernetes_tpu_torch.models.policy import batch_policy_from
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler.plugins import load_policy

    n_nodes, n_pods, kw, policy_json = FULL_SHAPES[name]
    t0 = time.perf_counter()
    if size is None:
        cluster = build_shape(name)
    else:
        n_nodes, n_pods = size
        cluster = build_cluster(n_nodes, n_pods, **kw)
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
    chosen, scores = bs.solve(snap, device=dev)
    names = bs.decisions_to_names(snap, chosen)
    t2 = time.perf_counter()
    launches = commit_solver.solve_commit.launches
    if count_launches and launches != 1:
        raise AssertionError(f"{name}: the wave launched commit_solve "
                             f"{launches} times, want exactly 1")
    if count_launches and commit_solver.solve_commit_reference.calls:
        raise AssertionError(f"{name}: the main path ran the plain version")

    # ---- the kernel against its plain version on the same inputs -------
    ci = _inputs(snap, dev)
    layout, dyn_bytes = _layout(ci)
    kernel_ms, kernel_all, (kc, kw_) = _timed_ms(
        dev, lambda: commit_solver.solve_commit(ci), kernel_runs)
    stats: dict = {}
    plain_ms, _, (pc, pw) = _timed_ms(
        dev, lambda: commit_solver.solve_commit_reference(ci, stats), 1)
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

    if reencode:
        # the row cache: every spec now holds its rows, so this encode
        # walks no container; its arrays must be the first encode's
        if not all("_ktpu_rows" in p.spec.__dict__
                   for p in cluster[1] + cluster[2]):
            raise AssertionError(f"{name}: a pod's spec holds no cached rows "
                                 f"after the first encode")
        t3 = time.perf_counter()
        again = encode_snapshot(*cluster, policy=policy)
        extra["reencode_s"] = time.perf_counter() - t3
        for f in dataclasses.fields(snap):
            a, b = getattr(snap, f.name), getattr(again, f.name)
            if isinstance(a, np.ndarray):
                same = a.dtype == b.dtype and np.array_equal(a, b)
            else:
                same = f.name == "policy" or a == b
            if not same:
                raise AssertionError(f"{name}: the cached re-encode's "
                                     f"{f.name} differs from the first "
                                     f"encode's")

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
        "instance": commit_solver.instance_of(ci),
        "groups": ci.counts0.shape[0], "count_bytes": ci.count_bytes,
        "peer_bound": bs.peer_bound_of(snap),
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
    again = (f"; the same objects re-encoded (every pod's rows cached) in "
             f"{w['reencode_s']:.3f}s, arrays equal" if "reencode_s" in w
             else "")
    _log(f"[{tag}] {w['shape']} {w['nodes']}x{w['pods']} "
         f"({w['resource_type']} planes, {w['bands']} bands{pre}): launches "
         f"{w['launches']}, state in {w['layout']} memory "
         f"({w['dyn_shared_bytes']} B dynamic shared), bound "
         f"{w['bound_pods']}, encode "
         f"{w['encode_s']:.3f}s, wave {w['wave_s']:.3f}s "
         f"({w['pods_per_s']:.1f} pods/s), kernel {w['kernel_ms']:.3f} ms "
         f"(runs {[round(t, 3) for t in w['kernel_ms_runs']]}), plain "
         f"{w['plain_ms']:.1f} ms, bound {w['bound_ms']:.4f} ms "
         f"({w['bound_by']}){again}")


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
                     plain_wave=1, count_launches=True, n_services=8,
                     churn=True, plain_device="cpu") -> dict:
    """Phase 7: the scheduler's causal wave loop (BatchScheduler over the
    port's ConfigFactory and FakeClient) binds a north_star cluster wave
    by wave, then churn, then a node add. Each wave's bindings are held
    against solve(encode_snapshot(...)) of the same state on ``dev``, one
    delta wave also against the plain version on ``plain_device`` (the
    CPU). Phase 20 (b) runs it on the planet cluster (``n_services`` 2)
    without the churn and the node add (``churn`` False), holding its
    delta wave against the plain version on the card (a 40,000-node wave
    of 1,024 pods takes the CPU's plain version about a minute)."""
    import gc

    import numpy as np

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import gang
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
        n_nodes, n_pending + n_churn + n_last, n_services=n_services)
    first, churn_pods, last = (pending[:n_pending],
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

        def _solve_snap(self, snap, n_pending, tctx=None):
            d = super()._solve_snap(snap, n_pending, tctx)
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
        churn_bound = node_bound = 0
        churn_s = node_s = None
        if churn:
            fc.delete_bound(existing[:n_deleted])
            deleted.update(f"default/{p.metadata.name}"
                           for p in existing[:n_deleted])
            fc.add_pending(churn_pods)
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
    total = n_pending + (n_churn + n_last if churn else 0)
    gone = n_deleted if churn else 0
    if len(fc.bind_log) != total or len(fc.bound()) != \
            len(existing) - gone + total:
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
    # the plain version itself (solve_scan), on a card too
    p_chosen, p_scores = bs.solve_scan(
        bs.ship_inputs(bs.snapshot_to_host_inputs(snap), plain_device),
        snap.policy, snap.has_gangs)
    p_chosen, p_scores = p_chosen.cpu().numpy(), p_scores.cpu().numpy()
    if snap.has_gangs:
        p_chosen = gang.apply_all_or_nothing(snap.pod_rid, p_chosen)
        p_scores = np.where(p_chosen < 0, -1, p_scores)
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
        "churn_pods_per_s": churn_bound / churn_s if churn else None,
        "node_add_pods_per_s": node_bound / node_s if churn else None,
        "full_encode_s": [w["encode_s"] for w in waves
                          if w["path"] == "full"],
        "delta_encode_s": [w["encode_s"] for w in split("north_star")[1:]
                           + split("churn")],
        "full_encode_check_s": full_check_s,
        "plain_wave": plain_wave, "plain_device": str(plain_device),
        "plain_s": plain_s,
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


# ---- phase 7p: the pipelined loop against the causal loop -----------------

def _pipeline_phase(dev, n_nodes=5_000, n_pending=10_000, wave_size=1_024,
                    count_launches=True) -> dict:
    """Phase 7p: the causal and the pipelined loop each drive a fresh,
    identical north_star cluster (phase 7's: ``n_nodes`` nodes, 2 bound
    pods each, 8 services) behind a FakeClient through ``run()``, the
    backlog of ``n_pending`` fully synced first; then both again with one
    foreign bind injected during the first solve. Fails unless each pair
    places every pod identically, the clean pipelined run hit at least one
    speculation, the injected one invalidated at least one on
    ``store_delta``, every launch is a solve (one each) — the loop's
    committed waves plus the discarded speculative solves — and the plain
    version never ran."""
    from kubernetes_tpu_torch.tools.loop_time import drive

    runs = {}
    for inject in (False, True):
        for pipeline in (False, True):
            key = f"{'pipelined' if pipeline else 'causal'}" \
                  f"{'_injected' if inject else ''}"
            runs[key] = drive(dev, pipeline, inject, n_nodes, n_pending,
                              wave_size)
    for tag in ("", "_injected"):
        c, p = runs[f"causal{tag}"], runs[f"pipelined{tag}"]
        for r in (c, p):
            if r["bound"] != n_pending:
                raise AssertionError(f"phase 7p: {r['bound']} bound")
        if c["placements"] != p["placements"]:
            diff = sum(1 for k, v in c["placements"].items()
                       if p["placements"].get(k) != v)
            raise AssertionError(f"phase 7p{tag}: {diff} placements of the "
                                 f"pipelined loop differ from the causal "
                                 f"loop's")
        if p["pipeline_waves"] != p["consumed"]:
            raise AssertionError(f"phase 7p{tag}: {p['pipeline_waves']} "
                                 f"pipeline waves, {p['consumed']} "
                                 f"committed")
    if runs["pipelined"]["hits"] < 1:
        raise AssertionError("phase 7p: no speculation hit in the clean run")
    if runs["pipelined_injected"]["invalidations"].get("store_delta", 0) < 1:
        raise AssertionError(f"phase 7p: no store_delta invalidation: "
                             f"{runs['pipelined_injected']['invalidations']}")
    for key, r in runs.items():
        if r["pipeline"] and r["consumed"] + r["discarded"] != r["solves"]:
            raise AssertionError(f"phase 7p {key}: solves unaccounted")
        if not r["pipeline"] and r["discarded"]:
            raise AssertionError(f"phase 7p {key}: the causal loop dropped "
                                 f"a solve")
        if count_launches and (r["launches_per_solve"] != [1]
                               or r["launches"] != r["solves"]):
            raise AssertionError(
                f"phase 7p {key}: {r['launches']} commit_solve launches for "
                f"{r['solves']} solves ({r['consumed']} committed, "
                f"{r['discarded']} discarded), per solve "
                f"{r['launches_per_solve']}")
        if count_launches and r["plain_calls"]:
            raise AssertionError(f"phase 7p {key}: the plain version ran")
        r.pop("placements")
    return {"nodes": n_nodes, "pending": n_pending, "wave_size": wave_size,
            "runs": runs}


# ---- phase 7e: the diagnosis on the card against the CPU -------------------

def _explain_phase(dev, n_nodes=5_000, n_pending=10_000) -> dict:
    """Phase 7e: the north_star wave with 256 unschedulable pods appended —
    64 oversized, 64 whose node selector no node matches, 64 oversized
    with a host port the residents hold on some nodes, 64 pinned to a node
    that is not in the cluster — solved on ``dev``, then ``explain_wave`` on
    ``dev`` and on the CPU: the counts must be equal pod for pod, the
    messages string for string, every count sum the node count, and each
    constructed pod's dominant reason the one it was built for."""
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import explain
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot

    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    kinds = ("Insufficient cpu", "Node selector mismatch", "Insufficient cpu",
             "Host mismatch")
    extra = _explain_extra(256)
    snap = encode_snapshot(nodes, existing, pending + extra, services)
    chosen, scores = bs.solve(snap, device=dev)
    t0 = time.perf_counter()
    on_dev = explain.explain_wave(snap, chosen, scores, device=dev)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = explain.explain_wave(snap, chosen, scores, device="cpu")
    cpu_s = time.perf_counter() - t0
    if set(on_dev) != set(on_cpu) or any(
            on_dev[j] != on_cpu[j] for j in on_dev):
        raise AssertionError("phase 7e: counts on the card differ from the "
                             "CPU's")
    msgs = {j: explain.format_message(d) for j, d in on_dev.items()}
    if msgs != {j: explain.format_message(d) for j, d in on_cpu.items()}:
        raise AssertionError("phase 7e: messages differ")
    base = len(pending)
    for k in range(256):
        d = on_dev.get(base + k)
        if d is None or sum(d.counts.values()) != n_nodes or \
                explain.dominant_reason(d) != kinds[k // 64]:
            raise AssertionError(f"phase 7e: pod x-{k:03d}: {d}")
    mixed = on_dev[base + 128].counts
    if "Port conflict" not in mixed:
        raise AssertionError(f"phase 7e: no port conflict in {mixed}")
    return {"nodes": n_nodes, "pods": len(pending) + 256,
            "diagnosed": len(on_dev), "explain_dev_s": dev_s,
            "explain_cpu_s": cpu_s,
            "examples": [msgs[base + 64 * i] for i in range(4)]}


# ---- phases 9 and 9b: the scheduler binary against an apiserver process ----

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http_get(url: str, timeout: float = 10.0):
    """-> (status, body text); a refused connection raises OSError."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_http(url: str, proc, what: str, deadline_s: float = 120.0) -> str:
    """Poll ``url`` until it answers 200 -> the body; fails when ``proc``
    exits or the deadline passes."""
    deadline = time.monotonic() + deadline_s
    while True:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what} exited with {proc.returncode}")
        try:
            code, body = _http_get(url, timeout=2.0)
            if code == 200:
                return body
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} did not answer {url} within "
                                 f"{deadline_s:.0f} s")
        time.sleep(0.1)


def _spawn(tag: str, module: str, args, ready: str, env=None,
           respawn: bool = False, deadline_s: float = 120.0):
    """``python -m module args`` as a separate OS process in ``env`` (this
    process's environment by default), its output in
    chiprun_out/<tag>.log (appended to on a ``respawn``); waits until the
    process prints ``ready`` -> (process, seconds from the spawn to that
    line). Fails when the process exits or the deadline passes first."""
    import subprocess

    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.log")
    offset = os.path.getsize(path) if respawn and os.path.exists(path) else 0
    t0 = time.perf_counter()
    # faulthandler on: _abort_children leaves each stack in the log
    env = dict(os.environ if env is None else env, PYTHONFAULTHANDLER="1")
    with open(path, "ab" if respawn else "wb") as log:
        proc = subprocess.Popen([sys.executable, "-m", module,
                                 *map(str, args)], cwd=_ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + deadline_s
    try:
        while True:
            with open(path, "rb") as fh:
                fh.seek(offset)
                if ready.encode() in fh.read():
                    return proc, time.perf_counter() - t0
            if proc.poll() is not None:
                raise AssertionError(f"{tag}: {module} exited with "
                                     f"{proc.returncode} (chiprun_out/"
                                     f"{tag}.log)")
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: {module} not ready within "
                                     f"{deadline_s:.0f} s")
            time.sleep(0.05)
    except BaseException:
        _stop_process(proc)
        raise


def _start_apiserver(tag: str, env=None, args=(), port=None,
                     respawn: bool = False):
    """The port's apiserver binary (``kubernetes_tpu_torch.cmd.apiserver``
    with ``args``, on ``port`` or a free one) as a separate OS process,
    standing in the cluster's place, in ``env`` (this process's
    environment by default); its output goes to
    chiprun_out/<tag>_apiserver.log (appended to on a ``respawn``).
    Ready once it prints that it listens and its /healthz answers.
    -> (process, URL)."""
    port = port or _free_port()
    proc, _s = _spawn(f"{tag}_apiserver", "kubernetes_tpu_torch.cmd.apiserver",
                      ["--port", port, *args], "kube-apiserver listening on",
                      env=env, respawn=respawn)
    url = f"http://127.0.0.1:{port}"
    try:
        _wait_http(url + "/healthz", proc, f"{tag}: the apiserver", 120.0)
    except BaseException:
        _stop_process(proc)
        raise
    return proc, url


def _stop_process(proc) -> None:
    import subprocess

    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _parallel(n_threads: int, items, fn) -> None:
    """fn(item) over ``items`` from ``n_threads`` threads (round robin);
    the first error is raised after every thread ended."""
    import threading

    errors: list = []

    def run(chunk):
        try:
            for it in chunk:
                fn(it)
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(items[k::n_threads],),
                                daemon=True) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _check_placements(pods, nodes, tag: str) -> None:
    """No node over capacity in any resource, no host port twice on a
    node."""
    from kubernetes_tpu_torch.scheduler.predicates import (
        capacity_values, get_resource_request)

    caps = {n.metadata.name: capacity_values(n.spec.capacity) for n in nodes}
    used: dict = {}
    ports: dict = {}
    for p in pods:
        host = p.spec.host
        if not host:
            continue
        u = used.setdefault(host, {})
        for k, v in get_resource_request(p).items():
            u[k] = u.get(k, 0) + v
        for c in p.spec.containers:
            for cp in c.ports:
                if cp.host_port:
                    key = (host, cp.host_port)
                    if key in ports:
                        raise AssertionError(
                            f"{tag}: host port {cp.host_port} twice on "
                            f"{host} ({ports[key]}, {p.metadata.name})")
                    ports[key] = p.metadata.name
    for host, u in used.items():
        for k, v in u.items():
            if v > caps[host].get(k, 0):
                raise AssertionError(f"{tag}: {host} over capacity in {k}")


def _seed_cluster(client, nodes, existing, services, seeders: int,
                  tag: str):
    """Create the nodes and services, then the resident pods unbound, from
    ``seeders`` threads, and bind the residents in batches of 1,000 ->
    seconds of (nodes and services, pods, binds)."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.runtime.clone import deep_clone

    t0 = time.perf_counter()
    _parallel(seeders, nodes, lambda n: client.nodes().create(n))
    for svc in services:
        client.services(svc.metadata.namespace).create(svc)
    seed_nodes_s = time.perf_counter() - t0
    unbound = []
    for p in existing:
        q = deep_clone(p)
        q.spec.host = q.status.host = ""
        unbound.append(q)
    t0 = time.perf_counter()
    _parallel(seeders, unbound, lambda p: client.pods().create(p))
    seed_pods_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(0, len(existing), 1_000):
        res = client.pods().bind_many(api.BindingList(items=[
            api.Binding(metadata=api.ObjectMeta(
                name=p.metadata.name, namespace=p.metadata.namespace),
                pod_name=p.metadata.name, host=p.spec.host)
            for p in existing[k:k + 1_000]]))
        bad = [r for r in res.items if r.error]
        if bad:
            raise AssertionError(f"{tag}: seeding bind failed: {bad[0]}")
    return seed_nodes_s, seed_pods_s, time.perf_counter() - t0


class _CreateWatch:
    """Watches of every pod and node create on an apiserver, each read by a
    thread of its own from before the first create: each stream's
    resourceVersions must rise strictly, and ``check`` waits until the
    ADDED events name every created object."""

    def __init__(self, url: str):
        import threading

        from kubernetes_tpu_torch.client.client import Client
        from kubernetes_tpu_torch.client.http import HTTPTransport

        client = Client(HTTPTransport(url))
        self.watches = {"pods": client.pods("").watch(),
                        "nodes": client.nodes().watch()}
        self.added = {k: set() for k in self.watches}
        self.order_faults: list = []
        self.threads = [threading.Thread(target=self._read, args=(k, w),
                                         daemon=True, name=f"watch-{k}")
                        for k, w in self.watches.items()]
        for t in self.threads:
            t.start()

    def _read(self, kind, w) -> None:
        last = 0
        while True:
            ev = w.next_event()
            if ev is None:
                return
            rv = int(ev.object.metadata.resource_version)
            if rv <= last:
                self.order_faults.append((kind, last, rv))
            last = rv
            if ev.type == "ADDED":
                self.added[kind].add(ev.object.metadata.name)

    def check(self, want: dict, tag: str, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        while any(not want[k] <= self.added[k] for k in want):
            if time.monotonic() > deadline:
                missing = {k: len(want[k] - self.added[k]) for k in want}
                raise AssertionError(f"{tag}: the watch missed creates "
                                     f"{missing}")
            time.sleep(0.05)
        if self.order_faults:
            raise AssertionError(f"{tag}: watch resourceVersions not "
                                 f"strictly increasing: "
                                 f"{self.order_faults[:3]}")

    def stop(self) -> None:
        for w in self.watches.values():
            w.stop()
        for t in self.threads:
            t.join(timeout=10)


class _WaveLog:
    """The scheduler binary's ``on_built`` for the phases that run it in
    this process: wraps the scheduler's wave steps on the instance to keep
    each wave's pods, nodes, snapshot (copied: the incremental encoder
    mutates its planes in place), decisions, placements with the names
    whose bind succeeded, and seconds in ``rows``, and the garbage
    collector's pauses inside each wave (``on_gc``, a ``gc.callbacks``
    entry). ``after_wave(row)``, when given, runs in the loop's thread
    after each wave, between the waves. With ``keep_state`` each row also
    holds the pods the scheduler's incremental encoder held when it
    encoded the wave (``existing``, mirrored from the encoder's own full
    encodes, deltas, checkpoints and restores) and the encode's path
    (``encode_path``: full, delta or replay), for a cluster whose pods
    are also deleted while it runs."""

    def __init__(self, after_wave=None, keep_state: bool = False):
        from kubernetes_tpu_torch.util import metrics

        reg = metrics.default_registry()
        self.hist = {k: reg.histogram(f"scheduler_wave_{k}_seconds")
                     for k in ("encode", "solve", "commit")}
        self.gc = {"s": 0.0, "full": 0, "t": 0.0}
        self.rows: list = []
        self.sched = None
        self.after_wave = after_wave
        self.keep_state = keep_state

    def on_gc(self, phase, info) -> None:
        if phase == "start":
            self.gc["t"] = time.perf_counter()
        else:
            self.gc["s"] += time.perf_counter() - self.gc["t"]
            self.gc["full"] += info["generation"] == 2

    def __call__(self, sched) -> None:
        from kubernetes_tpu_torch.ops import commit_solver

        rows, hist, gc_acc = self.rows, self.hist, self.gc
        prepare, solve_snap, commit, wave = (
            sched._prepare_wave, sched._solve_snap, sched._commit_wave,
            sched.schedule_wave)
        row: dict = {}

        def _prepare_wave(pods):
            prep = prepare(pods)
            if prep is not None:
                row["order"], row["nodes"] = prep[0], prep[1]
                row["services"] = prep[2]
            return prep

        def _solve_snap(snap, n_pending, tctx=None):
            # counted around the solve: the loop thread may enter a drain
            # before the counter is set to 0 for the load window
            l0 = commit_solver.solve_commit.launches
            d = solve_snap(snap, n_pending, tctx)
            row["launches"] = commit_solver.solve_commit.launches - l0
            if self.keep_state:
                row["existing"] = list(shadow["pods"].values())
                row["encode_path"] = shadow["path"]
            t0 = time.perf_counter()
            row["snap"] = _copy_snapshot(snap)
            row["copy_s"] = time.perf_counter() - t0
            row["chosen"], row["scores"] = d.chosen, d.scores
            return d

        def _commit_wave(placed, assumed=None, tctx=None, preempt_t0=None):
            outcomes, bound = commit(placed, assumed, tctx, preempt_t0)
            row["placed"] = [(p.metadata.name, h) for p, h, _v in placed]
            row["acked"] = [(p.metadata.name, h) for (p, h, _v), e
                            in zip(placed, outcomes) if not e]
            row["bound_names"] = [n for n, _h in row["acked"]]
            row["errors"] = [repr(e) for e in outcomes if e]
            return outcomes, bound

        def schedule_wave(timeout=None):
            before = {k: h.sum() for k, h in hist.items()}
            gc0 = dict(gc_acc)
            row.clear()
            row.update(order=[], nodes=[], placed=[], acked=[],
                       bound_names=[], errors=[], launches=0, copy_s=0.0)
            t_w = time.perf_counter()
            n = wave(timeout)
            r = dict(row, bound=n, wave_s=time.perf_counter() - t_w,
                     gc_s=gc_acc["s"] - gc0["s"],
                     gc_full=gc_acc["full"] - gc0["full"],
                     t_end=time.perf_counter())
            for k, h in hist.items():
                r[f"{k}_s"] = h.sum() - before[k]
            rows.append(r)
            if self.after_wave is not None:
                self.after_wave(r)
            return n

        sched._prepare_wave, sched._solve_snap = _prepare_wave, _solve_snap
        sched._commit_wave, sched.schedule_wave = _commit_wave, schedule_wave
        self.sched = sched
        shadow: dict = {"pods": {}, "path": ""}
        if self.keep_state:
            self._mirror(sched._encoder, shadow)

    @staticmethod
    def _mirror(enc, shadow: dict) -> None:
        """Keep ``shadow["pods"]`` (uid -> pod) equal to what ``enc``, the
        scheduler's IncrementalEncoder, holds: a full encode takes the
        list it was given, a delta that returns a snapshot applies its
        upserts, then its removes (the modeler's contract), a checkpoint
        saves the mirror and a restore brings it back."""
        if enc is None:
            raise AssertionError("the scheduler has no incremental encoder "
                                 "to mirror")
        encode, delta = enc.encode, enc.encode_delta
        checkpoint, restore = enc.checkpoint, enc.restore
        saved: dict = {}

        def mirror_encode(nodes, existing, pending, services=(), **kw):
            snap = encode(nodes, existing, pending, services, **kw)
            shadow["pods"] = {p.metadata.uid: p for p in existing}
            shadow["path"] = "full"
            return snap

        def mirror_delta(nodes, upserted, removed, pending, services=(),
                         **kw):
            snap = delta(nodes, upserted, removed, pending, services, **kw)
            if snap is not None:
                pods = shadow["pods"]
                for p in upserted:
                    pods[p.metadata.uid] = p
                for p in removed:
                    pods.pop(p.metadata.uid, None)
                shadow["path"] = ("replay" if shadow["path"] == "restored"
                                  else "delta")
            return snap

        def mirror_checkpoint():
            # the scheduler keeps its latest checkpoint only
            state = checkpoint()
            saved.update(state=state, pods=dict(shadow["pods"]))
            return state

        def mirror_restore(state):
            restore(state)
            if saved.get("state") is not state:
                raise AssertionError("restored a checkpoint the mirror did "
                                     "not see")
            shadow["pods"] = dict(saved["pods"])
            shadow["path"] = "restored"

        enc.encode, enc.encode_delta = mirror_encode, mirror_delta
        enc.checkpoint, enc.restore = mirror_checkpoint, mirror_restore


def _check_waves(rows, final, names, svcs, dev, tag: str,
                 count_launches: bool, launches: int,
                 plain_calls: int, gone=frozenset()) -> dict:
    """The checks of a run of the scheduler binary recorded by
    ``_WaveLog`` (``rows``, the waves that placed pods), against ``final``,
    every pod read back after the run (``names`` the pending ones): each
    wave launched commit_solve once and the plain version never ran
    (``count_launches``); each wave's decisions on ``dev`` equal the plain
    version's on the CPU over the wave's own snapshot, bit for bit; each
    wave's placements equal ``solve(encode_snapshot(...))`` of its state
    (the resident pods and those whose bind an earlier wave saw succeed,
    or the encoder's own pods where ``_WaveLog(keep_state=True)`` kept
    them: ``existing``; ``svcs`` the services, or None for each wave's
    own as its admission listed them); every bind a wave saw succeed
    reads back where it was placed, but for the pods of ``gone``, deleted
    since, and no pod is bound without one. On the card the kernel alone is timed on
    each wave's inputs (``kernel_ms``). -> the checks' seconds and the
    largest difference from the plain version."""
    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    if count_launches and (any(r["launches"] != 1 for r in rows)
                           or launches != len(rows)):
        raise AssertionError(f"{tag}: commit_solve launches per wave "
                             f"{[r['launches'] for r in rows]}, {launches} "
                             f"in all")
    if count_launches and plain_calls:
        raise AssertionError(f"{tag}: the plain version ran")
    by_name = {p.metadata.name: p for p in final}
    acked = {}
    wave_of = {}
    for k, r in enumerate(rows):
        acked.update(r["acked"])
        wave_of.update((n, k) for n, _h in r["acked"])
    wrong = [n for n, h in acked.items()
             if n not in gone and by_name[n].spec.host != h]
    if wrong:
        n = wrong[0]
        raise AssertionError(
            f"{tag}: {len(wrong)} acknowledged binds do not read back, "
            f"e.g. {n}: acknowledged on {acked[n]} in wave {wave_of[n]} "
            f"of {len(rows)}, reads back on {by_name[n].spec.host!r} "
            f"(resourceVersion {by_name[n].metadata.resource_version})")
    unacked = [n for n in names if n not in gone and by_name[n].spec.host
               and n not in acked]
    if unacked:
        raise AssertionError(f"{tag}: {len(unacked)} pods bound without an "
                             f"acknowledged bind, e.g. {unacked[0]}")
    # each wave's decisions on ``dev`` against the plain version on the CPU
    # over the wave's own snapshot (bit-equal), and the kernel alone timed
    # on those inputs
    max_abs_err, plain_check_s = _hold_against_plain(rows, tag)
    if _device_type(dev) == "cuda":
        from kubernetes_tpu_torch.tools.kernel_time import event_ms
        for r in rows:
            ci = _inputs(r["snap"], dev)
            r["kernel_ms"] = event_ms(
                lambda: commit_solver.solve_commit(ci), 3)[0]
    residents = [p for p in final if p.metadata.name not in names]
    t0 = time.perf_counter()
    placed_before: list = []
    for k, r in enumerate(rows):
        state = r.get("existing")
        if state is None:
            state = residents + [by_name[n] for n in placed_before]
        snap = encode_snapshot(r["nodes"], state, r["order"],
                               r["services"] if svcs is None else svcs)
        chosen, _ = bs.solve(snap, device=dev)
        want = [(p.metadata.name, h) for p, h in
                zip(r["order"], bs.decisions_to_names(snap, chosen)) if h]
        if sorted(want) != sorted(r["placed"]):
            raise AssertionError(f"{tag} wave {k}: bindings differ from "
                                 f"solve(encode_snapshot(...)) of its state")
        placed_before += r["bound_names"]
    return {"replay_check_s": time.perf_counter() - t0,
            "plain_check_s": plain_check_s, "max_abs_err": max_abs_err}


def _hold_against_plain(rows, tag: str):
    """Each ``_WaveLog`` row's decisions against the plain version on the
    CPU over the wave's own snapshot, bit for bit -> (the largest
    difference, the check's seconds)."""
    import numpy as np

    from kubernetes_tpu_torch.models import batch_solver as bs

    t0 = time.perf_counter()
    max_abs_err = 0
    for k, r in enumerate(rows):
        p_chosen, p_scores = bs.solve(r["snap"], device="cpu")
        if not (np.array_equal(p_chosen, r["chosen"])
                and np.array_equal(p_scores, r["scores"])):
            raise AssertionError(f"{tag} wave {k}: decisions differ from "
                                 f"the plain version")
        max_abs_err = max(max_abs_err, *(
            int(np.abs(np.asarray(a, np.int64) - b).max())
            for a, b in ((p_chosen, r["chosen"]), (p_scores, r["scores"]))))
    return max_abs_err, time.perf_counter() - t0


def _wave_rows(rows, t_first: float) -> list:
    """The per-wave numbers a phase keeps of ``_WaveLog`` rows."""
    return [{k: r[k] for k in ("bound", "wave_s", "launches", "encode_s",
                               "solve_s", "commit_s", "gc_s", "gc_full",
                               "copy_s")}
            | {"wave": i, "pods": len(r["order"]),
               "kernel_ms": r.get("kernel_ms"),
               "binds_failed": len(r["errors"]),
               "t_end_s": r["t_end"] - t_first}
            for i, r in enumerate(rows)]


def _binary_phase(dev, n_nodes=5_000, n_pending=10_000, seeders=8,
                  creators=4, count_launches=True) -> dict:
    """Phase 9: the port's scheduler binary (cmd/scheduler.scheduler_server
    with --algorithm tpu-batch --prewarm, in a thread of this process so
    the kernel's launch counter can be read) against the port's
    apiserver in its own process, over HTTP and the v1 wire. The cluster
    (north_star: ``n_nodes`` nodes, 2 bound pods each, 8 services) is
    seeded through the port's client, watched create by create
    (``_CreateWatch``), and the creates/s logged; once
    compile_prewarm_ready reads 1 on /metrics and the scheduler's caches
    hold the cluster, ``n_pending`` pods are created from ``creators``
    threads. Fails unless every pod
    reads back bound, no node is over capacity and no host port doubled,
    each wave launched commit_solve once and the plain version never ran,
    each wave's decisions equal the plain version's on the CPU over the
    wave's own snapshot (bit for bit), each wave's bindings equal
    solve(encode_snapshot(...)) of its state on ``dev``, and /healthz
    answers healthy JSON. On the card the kernel alone is timed on each
    wave's inputs."""
    import gc
    import threading

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver

    t_phase = time.perf_counter()
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    names = {p.metadata.name for p in pending}
    wl = _WaveLog()

    proc, url = _start_apiserver("phase9")
    client = Client(HTTPTransport(url))
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = None
    watch = creates = None
    try:
        # ---- seed the cluster over HTTP, watching every create -----------
        creates = _CreateWatch(url)
        seed_nodes_s, seed_pods_s, seed_bind_s = _seed_cluster(
            client, nodes, existing, services, seeders, "phase 9")
        creates.check({"nodes": {n.metadata.name for n in nodes},
                       "pods": {p.metadata.name for p in existing}},
                      "phase 9")
        creates.stop()
        n_creates = len(nodes) + len(services) + len(existing)
        creates_per_s = n_creates / (seed_nodes_s + seed_pods_s)
        _log(f"phase 9: the port's apiserver took {n_creates} creates "
             f"({len(nodes)} nodes and {len(services)} services in "
             f"{seed_nodes_s:.3f} s, {len(existing)} pods in "
             f"{seed_pods_s:.3f} s, {seeders} threads): "
             f"{creates_per_s:.1f} creates/s; a watch saw every create, "
             f"resourceVersions strictly increasing")

        # ---- the binary, its prewarm and its caches ----------------------
        mport = _free_port()
        argv = ["--master", url, "--algorithm", "tpu-batch", "--prewarm",
                "--metrics-port", str(mport), "--device",
                _device_type(dev)]
        t_boot = time.perf_counter()
        thread = threading.Thread(
            target=lambda: result.update(rc=cmd.scheduler_server(
                argv, ready, stop, on_built=wl)), daemon=True,
            name="phase9-binary")
        thread.start()
        murl = f"http://127.0.0.1:{mport}"
        deadline = time.monotonic() + 600
        while "compile_prewarm_ready 1" not in _wait_http(
                murl + "/metrics", None,
                "phase 9: the scheduler binary").splitlines():
            if "rc" in result or time.monotonic() > deadline:
                raise AssertionError(f"phase 9: no prewarm (binary "
                                     f"returned {result.get('rc')})")
            time.sleep(0.2)
        prewarm_ready_s = time.perf_counter() - t_boot
        sched, rows = wl.sched, wl.rows
        f = sched.factory
        while not (len(f.node_store) == n_nodes
                   and len(f.scheduled_pods) == len(existing)
                   and len(f.service_store) == len(services)):
            if time.monotonic() > deadline:
                raise AssertionError("phase 9: the scheduler's caches never "
                                     "held the cluster")
            time.sleep(0.05)
        synced_s = time.perf_counter() - t_boot

        # ---- the load window ---------------------------------------------
        seen: dict = {}
        watch = Client(HTTPTransport(url)).pods("").watch(
            field_selector="spec.host!=")

        def watch_binds():
            while len(seen) < len(names):
                ev = watch.next_event()
                if ev is None:
                    return
                n = ev.object.metadata.name
                if n in names and ev.object.spec.host and n not in seen:
                    seen[n] = time.perf_counter()

        watcher = threading.Thread(target=watch_binds, daemon=True,
                                   name="phase9-watch")
        watcher.start()
        gc.callbacks.append(wl.on_gc)
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t_first = time.perf_counter()
        _parallel(creators, pending, lambda p: client.pods().create(p))
        create_s = time.perf_counter() - t_first
        watcher.join(timeout=600)
        if len(seen) != len(names):
            raise AssertionError(f"phase 9: {len(seen)} of {len(names)} "
                                 f"binds seen through the watch")
        t_last = max(seen.values())
        while sum(r["bound"] for r in rows) < len(names):
            if time.monotonic() > deadline or "rc" in result:
                raise AssertionError("phase 9: the loop did not record "
                                     "every bind")
            time.sleep(0.05)
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        code, body = _http_get(murl + "/healthz")
        health = json.loads(body)
        if code != 200 or health.get("healthy") is not True:
            raise AssertionError(f"phase 9: /healthz {code} {body}")
        final = client.pods("").list().items
        svcs = f.service_store.list()
    finally:
        if wl.on_gc in gc.callbacks:
            gc.callbacks.remove(wl.on_gc)
        if watch is not None:
            watch.stop()
        if creates is not None:
            creates.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        _stop_process(proc)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"phase 9: the binary returned "
                             f"{result.get('rc')}")

    # ---- the checks, after the run -----------------------------------------
    rows = [r for r in rows if r["order"]]
    by_name = {p.metadata.name: p for p in final}
    unbound_left = [n for n in names if not by_name[n].spec.host]
    if unbound_left:
        raise AssertionError(f"phase 9: {len(unbound_left)} pods unbound")
    _check_placements(final, nodes, "phase 9")
    if any(r["errors"] for r in rows):
        raise AssertionError("phase 9: a bind failed")
    checks = _check_waves(rows, final, names, svcs, dev, "phase 9",
                          count_launches, launches, plain_calls)
    waves = _wave_rows(rows, t_first)
    return {
        "nodes": n_nodes, "existing": len(existing), "pending": n_pending,
        "services": len(services), "seeders": seeders, "creators": creators,
        "seed_nodes_s": seed_nodes_s, "seed_pods_s": seed_pods_s,
        "seed_bind_s": seed_bind_s, "creates_per_s": creates_per_s,
        "prewarm_s": sched.prewarm_s, "prewarm_ready_s": prewarm_ready_s,
        "caches_synced_s": synced_s,
        "window_start_s": t_first - t_phase, "window_end_s": t_last - t_phase,
        "create_s": create_s, "loop_s": t_last - t_first,
        "pods_per_s": n_pending / (t_last - t_first),
        "waves": waves, "launches": launches, "plain_calls": plain_calls,
        "gc_s": wl.gc["s"], "gc_full": wl.gc["full"], "health": health,
        **checks, "phase_s": time.perf_counter() - t_phase,
    }


def _parse_breakdown(msg: str) -> dict:
    """'0/N nodes available: a R1, b R2' -> {"N": N, R1: a, R2: b}."""
    head, _, tail = msg.partition(": ")
    out = {"N": int(head.split("/")[1].split()[0])}
    for part in tail.split(", ") if tail else ():
        n, _, reason = part.partition(" ")
        out[reason] = int(n)
    return out


def _pipeline_binary_phase(dev, n_nodes=5_000, n_pending=5_000, seeders=8,
                           creators=4, count_launches=True) -> dict:
    """Phase 9c: the binary with ``--algorithm tpu-batch --pipeline --trace
    --flightrec --prewarm`` (``scheduler_server`` in a thread) against a
    fresh JAX-package apiserver process seeded as in phase 9; once it is
    ready, ``n_pending`` pods are created, of which every 50th asks for
    more cpu than any node has and every 50th (offset 25) carries a node
    selector no node matches and asks for almost nothing. Fails unless
    every other pod binds to a valid host and those stay unbound, the loop
    ran pipelined (its waves counter equals the waves it committed, plus
    one left in flight at stop), a FailedScheduling event of each kind
    read from the apiserver carries the breakdown line summing to the
    node count with the constructed dominant reason,
    ``scheduler_unschedulable_total`` sums to
    ``scheduler_unschedulable_pods_total``, /debug/trace holds the wave
    stages with a speculative encode, /debug/vars?since=0 holds
    ``scheduler_pipeline_waves_total`` and its rate, and every
    commit_solve launch is a solve (one each: the committed waves plus
    the discarded speculative ones) with no call of the plain version."""
    import threading

    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.models import explain
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler import tpu_batch
    from kubernetes_tpu_torch.tools.loop_time import stage_medians
    from kubernetes_tpu_torch.util import metrics, tracing

    t_phase = time.perf_counter()
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    big, nosel = set(), set()
    for i, p in enumerate(pending):
        if i % 50 == 0:
            p.spec.containers[0].resources.limits["cpu"] = Quantity("32")
            big.add(p.metadata.name)
        elif i % 50 == 25:
            p.spec.containers[0].resources.limits = {
                "cpu": Quantity("10m"), "memory": Quantity("16Mi")}
            p.spec.node_selector = {"zone": "z99"}
            nosel.add(p.metadata.name)
    fits = {p.metadata.name for p in pending} - big - nosel
    pm = tpu_batch._pipeline_metrics()
    em = metrics.explain_metrics()
    held: dict = {"solves": [], "consumed": 0, "last": None}

    def record(sched):
        """on_built: count each solve's launches, each committed wave,
        and keep the wave left in flight by the last pipelined cycle."""
        solve_snap, split, cycle = (sched._solve_snap, sched._split_decisions,
                                    sched._pipelined_cycle)

        def _solve_snap(snap, n, tctx=None):
            l0 = commit_solver.solve_commit.launches
            d = solve_snap(snap, n, tctx)
            held["solves"].append(commit_solver.solve_commit.launches - l0)
            return d

        def _split_decisions(pending_, decisions):
            held["consumed"] += 1
            return split(pending_, decisions)

        def _pipelined_cycle(*args):
            held["last"] = out = cycle(*args)
            return out

        sched._solve_snap, sched._split_decisions = _solve_snap, \
            _split_decisions
        sched._pipelined_cycle = _pipelined_cycle
        held["sched"] = sched

    proc, url = _start_apiserver("phase9c")
    client = Client(HTTPTransport(url))
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = watch = None
    try:
        seed_s = _seed_cluster(client, nodes, existing, services, seeders,
                               "phase 9c")
        mport = _free_port()
        argv = ["--master", url, "--algorithm", "tpu-batch", "--pipeline",
                "--trace", "--flightrec", "--prewarm", "--metrics-port",
                str(mport), "--device", _device_type(dev)]
        t_boot = time.perf_counter()
        thread = threading.Thread(
            target=lambda: result.update(rc=cmd.scheduler_server(
                argv, ready, stop, on_built=record)), daemon=True,
            name="phase9c-binary")
        thread.start()
        murl = f"http://127.0.0.1:{mport}"
        deadline = time.monotonic() + 600
        while "compile_prewarm_ready 1" not in _wait_http(
                murl + "/metrics", None,
                "phase 9c: the scheduler binary").splitlines():
            if "rc" in result or time.monotonic() > deadline:
                raise AssertionError(f"phase 9c: no prewarm (binary "
                                     f"returned {result.get('rc')})")
            time.sleep(0.2)
        f = held["sched"].factory
        while not (len(f.node_store) == n_nodes
                   and len(f.scheduled_pods) == len(existing)
                   and len(f.service_store) == len(services)):
            if time.monotonic() > deadline:
                raise AssertionError("phase 9c: the scheduler's caches "
                                     "never held the cluster")
            time.sleep(0.05)
        synced_s = time.perf_counter() - t_boot

        # ---- the load window ---------------------------------------------
        seen: dict = {}
        watch = Client(HTTPTransport(url)).pods("").watch(
            field_selector="spec.host!=")

        def watch_binds():
            while len(seen) < len(fits):
                ev = watch.next_event()
                if ev is None:
                    return
                n = ev.object.metadata.name
                if n in fits and ev.object.spec.host and n not in seen:
                    seen[n] = time.perf_counter()

        watcher = threading.Thread(target=watch_binds, daemon=True,
                                   name="phase9c-watch")
        watcher.start()
        m0 = {"waves": pm.waves.value(), "hits": pm.hits.value(),
              "inval": pm.invalidations.by_label(),
              "overlap": pm.overlap.value(),
              "unspec": pm.unspeculated.value(), "pods": em.pods.value(),
              "reasons": em.reasons.by_label(),
              "skipped": em.skipped.by_label(),
              "invocations": em.invocations.value()}
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        held["solves"].clear()
        held["consumed"] = 0
        t_first = time.perf_counter()
        _parallel(creators, pending, lambda p: client.pods().create(p))
        create_s = time.perf_counter() - t_first
        watcher.join(timeout=600)
        if len(seen) != len(fits):
            raise AssertionError(f"phase 9c: {len(seen)} of {len(fits)} "
                                 f"binds seen through the watch")
        t_last = max(seen.values())

        # ---- the breakdown lines in the apiserver's events -----------------
        lines: dict = {}
        while len(lines) < 2:
            for ev in client.events("default").list().items:
                kind = ("big" if ev.involved_object.name in big else
                        "nosel" if ev.involved_object.name in nosel
                        else None)
                if kind and ev.reason == "FailedScheduling" \
                        and "nodes available" in ev.message:
                    lines.setdefault(kind, ev.message)
            if len(lines) < 2:
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 9c: breakdown events "
                                         f"seen: {lines}")
                time.sleep(0.5)
        code, body = _http_get(murl + "/debug/trace")
        shard = json.loads(body)
        code_v, body_v = _http_get(murl + "/debug/vars?since=0")
        fr = json.loads(body_v)
        final = client.pods("").list().items
    finally:
        if watch is not None:
            watch.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        _stop_process(proc)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"phase 9c: the binary returned "
                             f"{result.get('rc')}")
    in_flight = held["last"]
    if in_flight is not None:
        in_flight.fut.exception(timeout=120)   # its solve still launches
    launches = commit_solver.solve_commit.launches
    plain_calls = commit_solver.solve_commit_reference.calls

    # ---- the checks, after the run -----------------------------------------
    by_name = {p.metadata.name: p for p in final}
    if any(not by_name[n].spec.host for n in fits) or \
            any(by_name[n].spec.host for n in big | nosel):
        raise AssertionError("phase 9c: bound set differs from the pods "
                             "that fit")
    _check_placements(final, nodes, "phase 9c")
    waves = pm.waves.value() - m0["waves"]
    consumed = held["consumed"]
    if waves != consumed + (in_flight is not None):
        raise AssertionError(f"phase 9c: {waves} pipeline waves, "
                             f"{consumed} committed (in flight at stop: "
                             f"{in_flight is not None})")
    inval = {k[0]: v - m0["inval"].get(k, 0.0)
             for k, v in pm.invalidations.by_label().items()
             if v - m0["inval"].get(k, 0.0)}
    solves = held["solves"]
    discarded = len(solves) - consumed - (in_flight is not None)
    if discarded < 0 or discarded > sum(inval.values()):
        raise AssertionError(f"phase 9c: {len(solves)} solves, {consumed} "
                             f"committed, invalidations {inval}")
    if count_launches and (set(solves) != {1} or launches != len(solves)):
        raise AssertionError(f"phase 9c: {launches} commit_solve launches "
                             f"for {len(solves)} solves, per solve "
                             f"{sorted(set(solves))}")
    if count_launches and plain_calls:
        raise AssertionError("phase 9c: the plain version ran")
    want = {"big": "Insufficient cpu", "nosel": "Node selector mismatch"}
    for kind, msg in lines.items():
        parts = _parse_breakdown(msg)
        total = parts.pop("N")
        if total != n_nodes or sum(parts.values()) != n_nodes or \
                max(parts, key=parts.get) != want[kind]:
            raise AssertionError(f"phase 9c: {kind} event {msg!r}")
    reasons = {k[0]: v - m0["reasons"].get(k, 0.0)
               for k, v in em.reasons.by_label().items()
               if v - m0["reasons"].get(k, 0.0)}
    unsched = em.pods.value() - m0["pods"]
    if sum(reasons.values()) != unsched or \
            em.reasons.total() != em.pods.value():
        raise AssertionError(f"phase 9c: unschedulable by reason {reasons} "
                             f"vs {unsched} pods")
    skipped = {k[0]: v - m0["skipped"].get(k, 0.0)
               for k, v in em.skipped.by_label().items()
               if v - m0["skipped"].get(k, 0.0)}
    spans = shard["spans"]
    names = {s["name"] for s in spans}
    stages = stage_medians(spans)
    if code != 200 or not {"wave.drain", "wave.prepare", "wave.encode",
                           "wave.solve", "wave.commit"} <= names \
            or stages["speculative_encodes"] < 1:
        raise AssertionError(f"phase 9c: /debug/trace {code}: {names}, "
                             f"{stages['speculative_encodes']} speculative "
                             f"encodes")
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    tracing.dump_chrome([shard], os.path.join(_ROOT, "chiprun_out",
                                              "phase9c_trace.json"))
    series = fr.get("series", {})
    if code_v != 200 or not fr.get("armed") or \
            "scheduler_pipeline_waves_total" not in series or \
            "scheduler_pipeline_waves_total:rate" not in series:
        raise AssertionError(f"phase 9c: /debug/vars {code_v}: "
                             f"{sorted(series)[:20]}")
    return {
        "nodes": n_nodes, "existing": len(existing), "pending": n_pending,
        "oversized": len(big), "selector_mismatch": len(nosel),
        "seed_s": list(seed_s), "caches_synced_s": synced_s,
        "create_s": create_s, "loop_s": t_last - t_first,
        "pods_per_s": len(fits) / (t_last - t_first),
        "waves": waves, "solves": len(solves), "discarded": discarded,
        "in_flight_at_stop": in_flight is not None,
        "launches": launches, "plain_calls": plain_calls,
        "hits": pm.hits.value() - m0["hits"], "invalidations": inval,
        "unspeculated": pm.unspeculated.value() - m0["unspec"],
        "overlap_s": pm.overlap.value() - m0["overlap"],
        "stages": stages, "spans": len(spans),
        "spans_dropped": shard["dropped"], "events": lines,
        "unschedulable_pods": unsched, "unschedulable_by_reason": reasons,
        "explain_invocations": em.invocations.value() - m0["invocations"],
        "explain_skipped": skipped,
        "vars_series": len(series),
        "waves_series": series["scheduler_pipeline_waves_total"]["samples"],
        "phase_s": time.perf_counter() - t_phase,
    }


# ---- phases 10 and 10b: the solver daemon ----------------------------------

def _seeded_north_star(seed: int, n_nodes: int, n_pending: int):
    """north_star's objects (``n_nodes`` nodes, 2 bound pods each, 8
    services, ``n_pending`` pending) made distinct by ``seed``: a tenth
    of the bound pods gone and the pending order shuffled."""
    from kubernetes_tpu_torch.models.fixtures import build_cluster

    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    rng = random.Random(seed)
    existing = [p for p in existing if rng.random() >= 0.1]
    rng.shuffle(pending)
    return nodes, existing, pending, services


def _daemon_phase(dev, n_nodes=5_000, wave_size=1_024, rounds=6, clients=4,
                  gather_window_s=0.05, count_launches=True) -> dict:
    """Phase 10: a SolverService on ``dev`` in this process (so the
    kernel's launch counter can be read) and ``clients`` threads, each
    with its own RemoteSolver (delta wire on) and its own north_star
    cluster (``_seeded_north_star``), each shipping ``rounds`` waves of
    ``wave_size`` pods through its IncrementalEncoder, released together
    at a barrier every round. Fails unless some device solve coalesced 2
    or more waves, commit_solve launched once per kernel-path device solve
    of the daemon and the plain version never ran, every reply equals the
    in-process single-wave ``solve(snap, device=dev)`` of the same wave,
    and every wave after each client's first rode the delta wire. On the
    card it then times ``solve_commit_batch`` alone over k = 1, 2, 4, 8
    and 16 of the first round's waves (padded to one shape), and holds
    the k = 4 launch against the plain version."""
    import threading

    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.solver.client import RemoteSolver
    from kubernetes_tpu_torch.solver.service import (SolverService, _dims_of,
                                                     _pad_inputs,
                                                     _target_dims)

    t_phase = time.perf_counter()
    clusters = [_seeded_north_star(900 + c, n_nodes, rounds * wave_size)
                for c in range(clients)]
    srv = SolverService(gather_window_s=gather_window_s, max_batch=16,
                        device=dev)
    sizes: list = []
    solve_group = srv._solve_group

    def record_group(reqs):
        sizes.append(len(reqs))
        solve_group(reqs)

    srv._solve_group = record_group
    solvers = [RemoteSolver(srv.address, fallback=False, device=dev)
               for _ in range(clients)]
    held: list = [[] for _ in range(clients)]
    barrier = threading.Barrier(clients)
    errors: list = []

    def client(c):
        try:
            nodes, existing, pending, services = clusters[c]
            enc = IncrementalEncoder()
            for r in range(rounds):
                wave = pending[r * wave_size:(r + 1) * wave_size]
                snap = enc.encode(nodes, existing, wave, services)
                barrier.wait(timeout=600)
                t0 = time.perf_counter()
                chosen, scores = solvers[c].solve(snap)
                held[c].append({"snap": _copy_snapshot(snap),
                                "chosen": chosen, "scores": scores,
                                "remote_s": time.perf_counter() - t0})
                for p, h in zip(wave, bs.decisions_to_names(snap, chosen)):
                    if h:
                        p.spec.host = p.status.host = h
                        existing.append(p)
        except Exception as e:  # re-raised after the threads end
            errors.append(e)
            barrier.abort()

    commit_solver.solve_commit.launches = 0
    commit_solver.solve_commit_batch.launches = 0
    commit_solver.solve_commit_reference.calls = 0
    srv.start()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                    name=f"phase10-client{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        run_s = time.perf_counter() - t0
    finally:
        srv.stop()
        joined = srv.join(60)
    if not joined:
        raise AssertionError("phase 10: the daemon's threads did not end")
    # read once the solver thread has ended: a prewarm launch may run
    # after the last reply
    launches = commit_solver.solve_commit.launches
    batched = commit_solver.solve_commit_batch.launches
    plain_calls = commit_solver.solve_commit_reference.calls
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("phase 10: a client thread did not finish")

    # ---- the checks, after the run -------------------------------------
    waves = clients * rounds
    if srv.waves_served != waves:
        raise AssertionError(f"phase 10: {srv.waves_served} of {waves} "
                             f"waves served")
    if max(sizes) < 2:
        raise AssertionError(f"phase 10: no device solve coalesced two "
                             f"waves (group sizes {sizes})")
    multi = sum(1 for k in sizes if k > 1)
    if count_launches and (launches != srv.batched_solves or srv.scan_waves
                           or plain_calls or not multi <= batched
                           <= multi + srv.prewarm_launches):
        raise AssertionError(
            f"phase 10: {launches} launches ({batched} of several waves) "
            f"for {srv.batched_solves} kernel-path device solves ({multi} "
            f"live groups of several waves, {srv.prewarm_launches} "
            f"prewarm), {srv.scan_waves} waves outside the kernel's "
            f"domain, {plain_calls} plain calls")
    for c, rs in enumerate(solvers):
        if (rs.remote_waves, rs.full_waves, rs.delta_waves,
                rs.resync_waves) != (rounds, 1, rounds - 1, 0):
            raise AssertionError(
                f"phase 10 client {c}: remote {rs.remote_waves}, full "
                f"{rs.full_waves}, delta {rs.delta_waves}, resync "
                f"{rs.resync_waves}")
    t0 = time.perf_counter()
    for c in range(clients):
        for r, h in enumerate(held[c]):
            want = bs.solve(h["snap"], device=dev)
            if not (np.array_equal(want[0], h["chosen"])
                    and np.array_equal(want[1], h["scores"])):
                raise AssertionError(f"phase 10 client {c} wave {r}: the "
                                     f"reply differs from the in-process "
                                     f"solve")
            if (h["chosen"][:len(h["snap"].pod_names)] < 0).any():
                raise AssertionError(f"phase 10 client {c} wave {r}: a pod "
                                     f"found no node")
    check_s = time.perf_counter() - t0
    out = {
        "nodes": n_nodes, "wave_size": wave_size, "rounds": rounds,
        "clients": clients, "gather_window_s": gather_window_s,
        "waves": waves, "group_sizes": sizes,
        "device_solves": srv.solve_calls,
        "batched_solves": srv.batched_solves,
        "prewarm_launches": srv.prewarm_launches,
        "prewarm_skipped": srv.prewarm_skipped,
        "prewarm_s": srv.prewarm_s, "launches": launches,
        "batched_launches": batched,
        "plain_calls": plain_calls, "run_s": run_s,
        "remote_s": [[h["remote_s"] for h in hc] for hc in held],
        "delta_bytes_shipped": sum(rs.delta_bytes_shipped for rs in solvers),
        "delta_bytes_full": sum(rs.delta_bytes_full for rs in solvers),
        "check_s": check_s,
    }

    # ---- the batched launch alone, k waves of the first round ----------
    if _device_type(dev) == "cuda":
        from kubernetes_tpu_torch.tools.kernel_time import event_ms

        hosts = [bs.snapshot_to_host_inputs(held[c][0]["snap"])
                 for c in range(clients)]
        target = _target_dims([_dims_of(h) for h in hosts])
        pol = held[0][0]["snap"].policy
        cis = [commit_solver.prepare(
            bs.ship_inputs(_pad_inputs(h, target), dev), pol, False)
            for h in hosts]
        # the planes are stacked before the timed region: the times are
        # the launch alone
        if len({commit_solver.launch_key(ci) for ci in cis}) != 1:
            raise AssertionError("phase 10: the first round's padded waves "
                                 "differ in launch key")
        batch_ms = {}
        for k in (1, 2, 4, 8, 16):
            planes = commit_solver.stack_planes(
                [cis[i % clients] for i in range(k)])
            batch_ms[k], _, res = event_ms(
                lambda: commit_solver.launch_stacked(cis[0], planes, k),
                3)
            if k == clients:
                got4 = list(zip(*res))
        plain_ms = 0.0
        max_abs_err = 0
        bound_ms = 0.0
        bound_by = ""
        for ci, (c, w) in zip(cis, got4):
            stats: dict = {}
            ms, _, (pc, pw) = event_ms(
                lambda: commit_solver.solve_commit_reference(ci, stats), 1)
            plain_ms += ms
            if not (torch.equal(c, pc) and torch.equal(w, pw)):
                raise AssertionError("phase 10: the batched launch differs "
                                     "from the plain version")
            max_abs_err = max(max_abs_err, int((c - pc).abs().max()),
                              int((w - pw).abs().max()))
            b_ms, bound_by, _nb, _ops = _bound(
                ci, int(stats["feasible"].sum()))
            bound_ms += b_ms
        out.update(batch_ms=batch_ms, batch_k=clients,
                   batch_plain_ms=plain_ms, batch_bound_ms=bound_ms,
                   batch_bound_by=bound_by, max_abs_err=max_abs_err,
                   layout=_layout(cis[0]))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _metric_value(body: str, name: str, default=None) -> float:
    """The value of a series in Prometheus text (``name`` with its labels,
    as exposed); ``default`` where it is absent, else a failure."""
    for line in body.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    if default is not None:
        return default
    raise AssertionError(f"no {name} on /metrics")


def _daemon_binary_phase(dev, n_nodes=5_000, n_pending=2_000, seeders=8,
                         creators=4) -> dict:
    """Phase 10b: ``python -m kubernetes_tpu_torch.cmd.solverd`` as its own
    process (``--prewarm``), and the port's scheduler binary
    (``--algorithm tpu-batch --prewarm --solver-addr``, in a thread) against
    the port's apiserver process seeded with north_star's nodes,
    bound pods and services; then ``n_pending`` pending pods. Fails unless
    every pod binds within capacity, every wave went to the daemon
    (``remote_waves`` > 0, no fallback, no busy wave, no launch in the
    scheduler's process), and the daemon's
    ``solverd_coalesced_waves_total`` equals the remote waves."""
    import subprocess
    import threading

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver

    t_phase = time.perf_counter()
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    names = {p.metadata.name for p in pending}
    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    dport, dmport = _free_port(), _free_port()
    log = open(os.path.join(out_dir, "phase10b_solverd.log"), "w")
    daemon = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.solverd", "--port",
         str(dport), "--metrics-port", str(dmport), "--device",
         _device_type(dev), "--prewarm", "--prewarm-nodes", str(n_nodes)],
        cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    proc = None
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    held: dict = {}
    thread = None
    try:
        durl = f"http://127.0.0.1:{dmport}"
        deadline = time.monotonic() + 600
        while "compile_prewarm_ready 1" not in _wait_http(
                durl + "/metrics", daemon,
                "phase 10b: the solver daemon").splitlines():
            if time.monotonic() > deadline or daemon.poll() is not None:
                raise AssertionError("phase 10b: the daemon's prewarm never "
                                     "finished")
            time.sleep(0.2)
        daemon_ready_s = time.perf_counter() - t_phase
        proc, url = _start_apiserver("phase10b")
        client = Client(HTTPTransport(url))
        seed_s = sum(_seed_cluster(client, nodes, existing, services,
                                   seeders, "phase 10b"))
        mport = _free_port()
        argv = ["--master", url, "--algorithm", "tpu-batch", "--prewarm",
                "--metrics-port", str(mport), "--device", _device_type(dev),
                "--solver-addr", f"127.0.0.1:{dport}"]
        thread = threading.Thread(
            target=lambda: result.update(rc=cmd.scheduler_server(
                argv, ready, stop, on_built=lambda s: held.update(sched=s))),
            daemon=True, name="phase10b-binary")
        thread.start()
        if not ready.wait(120):
            raise AssertionError("phase 10b: the binary never started")
        sched = held["sched"]
        f = sched.factory
        while not (len(f.node_store) == n_nodes
                   and len(f.scheduled_pods) == len(existing)
                   and len(f.service_store) == len(services)):
            if time.monotonic() > deadline or "rc" in result:
                raise AssertionError("phase 10b: the scheduler's caches "
                                     "never held the cluster")
            time.sleep(0.05)
        commit_solver.solve_commit.launches = 0
        t_first = time.perf_counter()
        _parallel(creators, pending, lambda p: client.pods().create(p))
        while True:
            final = client.pods("").list().items
            left = [p for p in final
                    if p.metadata.name in names and not p.spec.host]
            if not left:
                break
            if time.monotonic() > deadline or "rc" in result:
                raise AssertionError(f"phase 10b: {len(left)} pods unbound")
            time.sleep(0.25)
        loop_s = time.perf_counter() - t_first
        local_launches = commit_solver.solve_commit.launches
        code, body = _http_get(f"http://127.0.0.1:{mport}/healthz")
        health = json.loads(body)
        solver_item = [i for i in health.get("items", ())
                       if i.get("name") == "solver"]
        if code != 200 or not solver_item \
                or solver_item[0]["status"] != "success":
            raise AssertionError(f"phase 10b: /healthz {code} {body}")
        _code, dmetrics = _http_get(durl + "/metrics")
        coalesced = _metric_value(dmetrics, "solverd_coalesced_waves_total")
        solves = _metric_value(dmetrics, "solverd_device_solves_total")
        rs = sched.solver
        remote = (rs.remote_waves, rs.fallback_waves, rs.busy_waves,
                  rs.delta_waves, rs.full_waves)
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        if proc is not None:
            _stop_process(proc)
        _stop_process(daemon)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"phase 10b: the binary returned "
                             f"{result.get('rc')}")
    _check_placements(final, nodes, "phase 10b")
    remote_waves, fallback_waves, busy_waves, delta_waves, full_waves = remote
    if remote_waves == 0 or fallback_waves or busy_waves or local_launches:
        raise AssertionError(
            f"phase 10b: remote {remote_waves}, fallback {fallback_waves}, "
            f"busy {busy_waves} waves, {local_launches} launches in the "
            f"scheduler's process")
    if coalesced != remote_waves:
        raise AssertionError(f"phase 10b: the daemon served {coalesced} "
                             f"waves, the scheduler sent {remote_waves}")
    return {"nodes": n_nodes, "existing": len(existing),
            "pending": n_pending, "daemon_ready_s": daemon_ready_s,
            "seed_s": seed_s, "loop_s": loop_s,
            "pods_per_s": n_pending / loop_s,
            "remote_waves": remote_waves, "delta_waves": delta_waves,
            "full_waves": full_waves, "daemon_waves": coalesced,
            "daemon_solves": solves, "local_launches": local_launches,
            "phase_s": time.perf_counter() - t_phase}


def _device_type(dev) -> str:
    """``cuda`` or ``cpu`` for a torch.device or a device string."""
    return getattr(dev, "type", None) or str(dev).split(":")[0]


_NEG_POLICY_JSON = json.dumps({
    "predicates": [{"name": n} for n in (
        "PodFitsPorts", "PodFitsResources", "NoDiskConflict",
        "MatchNodeSelector", "HostName")],
    "priorities": [{"name": "LeastRequestedPriority", "weight": -1},
                   {"name": "ServiceSpreadingPriority", "weight": 1}]})


def _serial_placements(nodes, pending, policy) -> dict:
    """The port's GenericScheduler one pod at a time, each decision
    committed before the next -> {pod name: host or None}."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.runtime.clone import deep_clone
    from kubernetes_tpu_torch.scheduler import listers, plugins
    from kubernetes_tpu_torch.scheduler.generic import (FitError,
                                                        GenericScheduler)

    committed: list = []
    node_list = api.NodeList(items=list(nodes))
    args = plugins.PluginFactoryArgs(
        pod_lister=listers.FakePodLister(committed),
        service_lister=listers.FakeServiceLister([]),
        node_lister=listers.FakeMinionLister(node_list),
        node_info=listers.FakeNodeInfo(node_list))
    sched = GenericScheduler(plugins.predicates_from_policy(policy, args),
                             plugins.priorities_from_policy(policy, args),
                             args.pod_lister)
    out = {}
    for p in pending:
        try:
            host = sched.schedule(p, args.node_lister)
        except FitError:
            host = None
        if host:
            b = deep_clone(p)
            b.spec.host = b.status.host = host
            committed.append(b)
        out[p.metadata.name] = host
    return out


def _fallback_phase(dev, n_nodes=50, n_pending=200) -> dict:
    """Phase 9b: the binary as its own process, ``--algorithm tpu-batch``
    with a Policy the batch solver cannot model (a negative priority
    weight), against a fresh apiserver process: it must say it falls back
    to serial, bind every pod, and place each where the port's
    GenericScheduler puts it one pod at a time over the same objects."""
    import subprocess

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.scheduler.plugins import load_policy

    t_phase = time.perf_counter()
    nodes, _existing, pending, _services = build_cluster(n_nodes, n_pending)
    out_dir = os.path.join(_ROOT, "chiprun_out")
    policy_path = os.path.join(out_dir, "phase9b_policy.json")
    log_path = os.path.join(out_dir, "phase9b_scheduler.log")
    proc, url = _start_apiserver("phase9b")
    sched_proc = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(policy_path, "w") as fh:
            fh.write(_NEG_POLICY_JSON)
        client = Client(HTTPTransport(url))
        for n in nodes:
            client.nodes().create(n)
        mport = _free_port()
        log = open(log_path, "w")
        sched_proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler",
             "--master", url, "--algorithm", "tpu-batch",
             "--policy-config-file", policy_path, "--metrics-port",
             str(mport), "--device", _device_type(dev)],
            cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        health = json.loads(_wait_http(f"http://127.0.0.1:{mport}/healthz",
                                       sched_proc, "phase 9b: the binary"))
        # the node poller listed before the binary served: every pod
        # arrives through the watch in creation order
        t0 = time.perf_counter()
        for p in pending:
            client.pods().create(p)
        deadline = time.monotonic() + 300
        while True:
            got = {p.metadata.name: p.spec.host
                   for p in client.pods("").list().items}
            if all(got.get(p.metadata.name) for p in pending):
                break
            if sched_proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"phase 9b: "
                                     f"{sum(1 for h in got.values() if h)} "
                                     f"of {n_pending} pods bound")
            time.sleep(0.1)
        bind_s = time.perf_counter() - t0
        final = client.pods("").list().items
    finally:
        if sched_proc is not None:
            _stop_process(sched_proc)
        _stop_process(proc)
    with open(log_path) as fh:
        text = fh.read()
    if "falling back to serial" not in text:
        raise AssertionError(f"phase 9b: no fallback line in {text!r}")
    _check_placements(final, nodes, "phase 9b")
    want = _serial_placements(nodes, pending, load_policy(_NEG_POLICY_JSON))
    if got != want:
        diff = sorted(n for n in want if got.get(n) != want[n])
        raise AssertionError(f"phase 9b: {len(diff)} placements differ from "
                             f"the port's GenericScheduler, first {diff[0]}")
    return {"nodes": n_nodes, "pending": n_pending, "bind_s": bind_s,
            "pods_per_s": n_pending / bind_s,
            "hosts_used": len(set(got.values())), "health": health,
            "fallback_line": next(l for l in text.splitlines()
                                  if "falling back" in l),
            "phase_s": time.perf_counter() - t_phase}


def _log_binary(b: dict) -> None:
    _log(f"[9] scheduler binary over HTTP: {b['nodes']} nodes, "
         f"{b['existing']} resident, {b['services']} services seeded in "
         f"{b['seed_nodes_s']:.2f} + {b['seed_pods_s']:.2f} + "
         f"{b['seed_bind_s']:.2f} s ({b['seeders']} client threads: nodes "
         f"and services, resident pods, their binds); prewarm "
         f"{b['prewarm_s']:.3f} s, ready {b['prewarm_ready_s']:.2f} s after "
         f"boot, caches synced {b['caches_synced_s']:.2f} s after boot")
    _log(f"     load window {b['window_start_s']:.2f}-{b['window_end_s']:.2f}"
         f" s into the phase: {b['pending']} pending created from "
         f"{b['creators']} threads in {b['create_s']:.2f} s, last bind seen "
         f"through a watch after {b['loop_s']:.3f} s: {b['pods_per_s']:.1f} "
         f"pods/s; {len(b['waves'])} waves, {b['launches']} commit_solve "
         f"launches, {b['plain_calls']} plain-version calls; gc "
         f"{b['gc_s']:.4f} s ({b['gc_full']} full)")
    for w in b["waves"]:
        kernel = ("" if w["kernel_ms"] is None
                  else f", kernel {w['kernel_ms']:.3f} ms")
        _log(f"     wave {w['wave']:2d} {w['pods']:5d} pods: encode "
             f"{w['encode_s']:.4f} s, solve {w['solve_s']:.4f} s{kernel}, "
             f"commit {w['commit_s']:.4f} s, wave {w['wave_s']:.4f} s "
             f"(snapshot copy {w['copy_s']:.4f} s), ended "
             f"{w['t_end_s']:.3f} s into the window; gc {w['gc_s']:.4f} s "
             f"({w['gc_full']} full); launches {w['launches']}")
    kms = [w["kernel_ms"] for w in b["waves"] if w["kernel_ms"] is not None]
    if kms:
        _log(f"     kernel alone on each wave's inputs (CUDA events, median "
             f"of 3): median {statistics.median(kms):.3f} ms, max "
             f"{max(kms):.3f} ms, sum {sum(kms):.3f} ms")
    _log(f"     every wave == the plain version on the CPU over its own "
         f"snapshot ({b['plain_check_s']:.1f} s, max abs err "
         f"{b['max_abs_err']}); every wave == solve(encode_snapshot) of its "
         f"state ({b['replay_check_s']:.1f} s); /healthz {b['health']}")


def _log_fallback(f: dict) -> None:
    _log(f"[9b] fallback: {f['fallback_line']!r}; {f['pending']} pods on "
         f"{f['nodes']} nodes bound in {f['bind_s']:.2f} s "
         f"({f['pods_per_s']:.1f} pods/s, {f['hosts_used']} hosts used), "
         f"each where the port's GenericScheduler puts it")


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
         f"plain version on {sc['plain_device']} ({sc['plain_s']:.1f} s)")


def _log_pipeline(pp: dict) -> None:
    _log(f"[7p] pipelined vs causal loop: {pp['nodes']} nodes, "
         f"{pp['pending']} pending in waves of {pp['wave_size']}, each run "
         f"on a fresh cluster through run(); placements equal pod for pod "
         f"in both pairs")
    for key, r in pp["runs"].items():
        st = r["stages"]
        med = ", ".join(
            f"{k} {st[k]['median_s']:.4f} s x{st[k]['n']}"
            for k in ("encode", "solve", "commit")
            if st[k]["median_s"] is not None)
        _log(f"     {key:18s} {r['pods_per_s']:8.1f} pods/s "
             f"({r['loop_s']:.3f} s); solves {r['solves']} = "
             f"{r['consumed']} committed + {r['discarded']} discarded, "
             f"launches {r['launches']}, plain {r['plain_calls']}; pipeline "
             f"waves {r['pipeline_waves']:.0f}, hits {r['hits']:.0f}, "
             f"invalidations {r['invalidations']}, unspeculated "
             f"{r['unspeculated']:.0f}, overlap {r['overlap_s']:.3f} s; "
             f"medians {med} ({st['speculative_encodes']} speculative "
             f"encodes)")


def _log_explain(ex: dict) -> None:
    _log(f"[7e] explain: {ex['diagnosed']} unschedulable of {ex['pods']} "
         f"pods on {ex['nodes']} nodes, counts and messages on the card == "
         f"on the CPU (card {ex['explain_dev_s']:.3f} s, CPU "
         f"{ex['explain_cpu_s']:.3f} s); {ex['examples']}")


def _log_pipeline_binary(b: dict) -> None:
    st = b["stages"]
    _log(f"[9c] binary --pipeline --trace --flightrec: {b['nodes']} nodes, "
         f"{b['existing']} resident seeded in "
         f"{sum(b['seed_s']):.2f} s; {b['pending']} pending "
         f"({b['oversized']} oversized, {b['selector_mismatch']} selector "
         f"mismatched) created in {b['create_s']:.2f} s; last bind seen "
         f"{b['loop_s']:.3f} s after the first create: "
         f"{b['pods_per_s']:.1f} pods/s")
    _log(f"     pipeline waves {b['waves']:.0f}, solves {b['solves']} "
         f"({b['discarded']} discarded, in flight at stop "
         f"{b['in_flight_at_stop']}), launches {b['launches']}, plain "
         f"{b['plain_calls']}; hits {b['hits']:.0f}, invalidations "
         f"{b['invalidations']}, unspeculated {b['unspeculated']:.0f}, "
         f"overlap {b['overlap_s']:.3f} s; medians encode "
         f"{st['encode']['median_s']:.4f} s, solve "
         f"{st['solve']['median_s']:.4f} s, commit "
         f"{st['commit']['median_s']:.4f} s; {b['spans']} spans "
         f"({st['speculative_encodes']} speculative encodes, "
         f"{b['spans_dropped']} dropped) -> chiprun_out/phase9c_trace.json")
    _log(f"     unschedulable {b['unschedulable_pods']:.0f} = "
         f"{b['unschedulable_by_reason']}; explain invocations "
         f"{b['explain_invocations']:.0f}, skipped {b['explain_skipped']}; "
         f"events {b['events']}; /debug/vars {b['vars_series']} series")


def _log_daemon(d: dict) -> None:
    per_group = statistics.median(
        t for ts in d["remote_s"] for t in ts) if d["remote_s"] else 0.0
    _log(f"[10] solver daemon on the card, {d['clients']} clients x "
         f"{d['rounds']} waves of {d['wave_size']} pods on {d['nodes']} "
         f"nodes each (gather window {d['gather_window_s'] * 1e3:.0f} ms): "
         f"{d['waves']} waves in {d['device_solves']} device solves, group "
         f"sizes {d['group_sizes']}; {d['launches']} commit_solve launches "
         f"({d['batched_launches']} of several waves) for "
         f"{d['batched_solves']} kernel-path solves ("
         f"{d['prewarm_launches']} of them prewarm, taking "
         f"{d['prewarm_s']:.3f} s of the solver thread; "
         f"{d['prewarm_skipped']} prewarm jobs skipped, their instance "
         f"launched already), {d['plain_calls']} "
         f"plain calls; every reply == the in-process solve; delta wire "
         f"{d['delta_bytes_shipped']} B shipped for {d['delta_bytes_full']} "
         f"B of full frames; run {d['run_s']:.2f}s, median remote wave "
         f"{per_group:.3f}s")
    if "batch_ms" in d:
        where, dyn = d["layout"]
        _log(f"     batched launch alone (CUDA events, median of 3), state in "
             f"{where} memory ({dyn} B dynamic shared per block): "
             + ", ".join(f"k={k} {ms:.3f} ms" for k, ms in
                         d["batch_ms"].items())
             + f"; k={d['batch_k']} plain {d['batch_plain_ms']:.1f} ms, bound "
             f"{d['batch_bound_ms']:.5f} ms ({d['batch_bound_by']}), max abs "
             f"err {d['max_abs_err']}")


def _log_daemon_binary(b: dict) -> None:
    _log(f"[10b] the binary through a solverd process: {b['nodes']} nodes, "
         f"{b['existing']} bound, {b['pending']} pending bound in "
         f"{b['loop_s']:.2f}s ({b['pods_per_s']:.1f} pods/s); "
         f"{b['remote_waves']} remote waves ({b['full_waves']} full, "
         f"{b['delta_waves']} delta frames), 0 fallback, "
         f"{b['local_launches']} launches in the scheduler; the daemon "
         f"served {b['daemon_waves']:.0f} waves in {b['daemon_solves']:.0f} "
         f"device solves; daemon ready {b['daemon_ready_s']:.1f}s, seeding "
         f"{b['seed_s']:.1f}s")


# ---- phase 11: the serial oracle against the kernel -----------------------

# north_star's first K pending pods for phase 11b: the largest K for which
# the port's solve_serial finished within 60 s on an 8-core build host's CPU
# (kubernetes_tpu_torch/tools/oracle_time.py --limit-s 60)
_ORACLE_NS_PODS = 256
# phase 4b's extension and gang waves, one seed each, and its two wide
# waves (1,500 x 120 and 2,100 x 160); the ghost-anchor cases are left out,
# since the serial scheduler fails a lookup of a node that is not there
_ORACLE_EXT = [(seed, n, p, kw) for seed, n, p, kw in _EXT_CASES
               if not kw.get("ghost")] + _EXT_WIDE[:2]
# phase 4c's preemption waves without gangs (preempt_serial has no gang
# rule), and its 1,500-node wide wave with 32 bands
_ORACLE_PRE = [c for c in _PRE_CASES if not c[4].get("gangs")] \
    + _PRE_WIDE[:1]


def _policy_json(bp) -> str:
    """The JSON Policy file whose batch form is the BatchPolicy ``bp``."""
    preds = [{"name": name} for name, on in (
        ("PodFitsPorts", bp.use_ports), ("PodFitsResources", bp.use_resources),
        ("NoDiskConflict", bp.use_disk), ("MatchNodeSelector", bp.use_selector),
        ("HostName", bp.use_host)) if on]
    for i, (labels, presence) in enumerate(bp.label_presence):
        preds.append({"name": f"presence{i}", "argument": {"labelsPresence": {
            "labels": list(labels), "presence": presence}}})
    if bp.affinity_labels:
        preds.append({"name": "affinity", "argument": {"serviceAffinity": {
            "labels": list(bp.affinity_labels)}}})
    prios = [{"name": name, "weight": w} for name, w in (
        ("LeastRequestedPriority", bp.w_lr),
        ("ServiceSpreadingPriority", bp.w_spread),
        ("EqualPriority", bp.w_equal)) if w]
    for i, (label, w) in enumerate(bp.anti_affinity):
        prios.append({"name": f"anti{i}", "weight": w, "argument": {
            "serviceAntiAffinity": {"label": label}}})
    for i, (label, presence, w) in enumerate(bp.label_prefs):
        prios.append({"name": f"pref{i}", "weight": w, "argument": {
            "labelPreference": {"label": label, "presence": presence}}})
    return json.dumps({"predicates": preds, "priorities": prios})


def _json_policy(bp):
    """``bp`` as the oracle's Policy, read back from its JSON text; fails
    unless the round trip gives ``bp`` again."""
    from kubernetes_tpu_torch.models.policy import batch_policy_from
    from kubernetes_tpu_torch.scheduler.plugins import load_policy

    policy = load_policy(_policy_json(bp))
    if batch_policy_from(policy=policy) != bp:
        raise AssertionError(f"phase 11: {bp} does not round-trip as JSON")
    return policy


def _explain_extra(n: int = 256):
    """Phase 7e's unschedulable pods: a quarter each oversized, with a
    node selector no node matches, oversized with a host port the
    residents hold, and pinned to a node that is not in the cluster."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity

    q = n // 4
    out = []
    for k in range(n):
        kind = min(k // q, 3)
        out.append(api.Pod(
            metadata=api.ObjectMeta(name=f"x-{k:03d}", namespace="default",
                                    uid=f"uid-x-{k:03d}"),
            spec=api.PodSpec(
                host="node-gone" if kind == 3 else "",
                node_selector={"zone": "z99"} if kind == 1 else {},
                containers=[api.Container(
                    name="c", image="img",
                    ports=[api.ContainerPort(container_port=80,
                                             host_port=7000)]
                    if kind == 2 else [],
                    resources=api.ResourceRequirements(limits={
                        "cpu": Quantity(("32", "10m", "17", "10m")[kind]),
                        "memory": Quantity("64Mi")}))])))
    return out


def _explain_state(n_nodes: int, n_pending: int, hosts):
    """Phase 7e's cluster once its ``n_pending`` pods are bound where the
    kernel put them: (nodes, existing, services)."""
    from kubernetes_tpu_torch.models.fixtures import build_cluster

    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    for p, h in zip(pending, hosts):
        if h is not None:
            p.spec.host = p.status.host = h
            existing.append(p)
    return nodes, existing, services


def _oracle_job(kind: str, args: tuple):
    """One oracle run, in a worker process: rebuilds its wave from the
    seed or the sizes and returns (result, seconds)."""
    from kubernetes_tpu_torch.models import gang, oracle
    from kubernetes_tpu_torch.models.fixtures import build_cluster

    t0 = time.perf_counter()
    if kind == "ext":
        seed, n_nodes, n_pods, kw = args
        wave, bp = _ext_wave(random.Random(seed), n_nodes, n_pods, **kw)
        gangs = any(gang.gang_key(p) is not None for p in wave[2])
        out = oracle.solve_serial(*wave, policy=_json_policy(bp),
                                  gangs=gangs)
    elif kind == "north_star":
        n_nodes, k = args
        nodes, existing, pending, services = build_cluster(n_nodes, k)
        out = oracle.solve_serial(nodes, existing, pending, services)
    elif kind == "pre":
        seed, n_nodes, n_pods, n_bands, kw = args
        wave, bp = _pre_wave(random.Random(seed), n_nodes, n_pods, n_bands,
                             **kw)
        names, victims = oracle.preempt_serial(*wave,
                                               policy=_json_policy(bp))
        out = (names, [sorted(v.uid for v in x) if x else None
                       for x in victims])
    elif kind == "explain":
        n_nodes, n_pending, n_extra, hosts = args
        nodes, existing, services = _explain_state(n_nodes, n_pending, hosts)
        names, diags = oracle.explain_serial(nodes, existing,
                                             _explain_extra(n_extra),
                                             services)
        out = (names, {j: (d.n_nodes, dict(d.counts), d.preempt)
                       for j, d in enumerate(diags) if d is not None})
    else:
        raise ValueError(kind)
    return out, time.perf_counter() - t0


def _first_diff(got, want) -> int:
    return next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)


def _oracle_phase(dev, n_nodes=5_000, ns_pods=_ORACLE_NS_PODS,
                  ext=_ORACLE_EXT, pre=_ORACLE_PRE, n_pending=10_000,
                  n_extra=256, workers=4, count_launches=True) -> dict:
    """Phase 11: the port's serial oracle (models/oracle.py) against
    commit_solve's decisions on ``dev``, in four places: (a) phase 4b's
    extension and gang waves == ``solve_serial`` (gangs where the wave has
    them); (b) north_star's node axis with all its bound pods and the first
    ``ns_pods`` pending == ``solve_serial``; (c) phase 4c's preemption
    waves == ``preempt_serial`` (node and victim set); (d) phase 7e's
    unschedulable pods, once 7e's pending pods are bound where the kernel
    put them: ``explain_wave`` on ``dev`` count-identical to
    ``explain_serial``. The oracle runs in ``workers`` spawned processes
    while the card solves; each wave is solved once through ``solve``
    (counted launches) and timed alone with CUDA events."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import explain, preempt
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.tools.kernel_time import event_ms

    on_card = _device_type(dev) == "cuda"
    launches = 0

    def solve(snap):
        nonlocal launches
        before = commit_solver.solve_commit.launches
        chosen, scores = bs.solve(snap, device=dev)
        n = commit_solver.solve_commit.launches - before
        if count_launches and n != 1:
            raise AssertionError(f"phase 11: {n} commit_solve launches for "
                                 f"one wave")
        launches += n
        kernel_ms = None
        if on_card:
            ci = _inputs(snap, dev)
            kernel_ms = event_ms(lambda: commit_solver.solve_commit(ci),
                                 1)[0]
        return chosen, scores, kernel_ms

    t_phase = time.perf_counter()
    # 7e's pending wave first: (d)'s state is where the kernel bound it
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    base = encode_snapshot(nodes, existing, pending, services)
    chosen, _scores = bs.solve(base, device=dev)
    hosts = bs.decisions_to_names(base, chosen)
    del nodes, existing, pending, services, base

    jobs = [("north_star", (n_nodes, ns_pods)),
            ("explain", (n_nodes, n_pending, n_extra, hosts))]
    jobs += [("ext", c) for c in ext] + [("pre", c) for c in pre]
    pool = ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    parts = {k: {"pods": 0, "waves": 0, "oracle_s": 0.0, "kernel_ms": 0.0}
             for k in ("ext", "north_star", "pre", "explain")}
    try:
        futures = [(kind, args, pool.submit(_oracle_job, kind, args))
                   for kind, args in jobs]
        for kind, args, fut in futures:
            part = parts[kind]
            if kind == "ext":
                seed, n, p, kw = args
                wave, bp = _ext_wave(random.Random(seed), n, p, **kw)
                snap = encode_snapshot(*wave, policy=bp)
                chosen, scores, kms = solve(snap)
                got = bs.decisions_to_names(snap, chosen)
                what = f"(a) extension seed {seed} {kw}"
            elif kind == "north_star":
                nodes, existing, pending, services = build_cluster(*args)
                snap = encode_snapshot(nodes, existing, pending, services)
                chosen, scores, kms = solve(snap)
                got = bs.decisions_to_names(snap, chosen)
                what = f"(b) north_star, first {args[1]} pending"
            elif kind == "pre":
                seed, n, p, b, kw = args
                wave, bp = _pre_wave(random.Random(seed), n, p, b, **kw)
                snap = encode_snapshot(*wave, policy=bp)
                chosen, scores, kms = solve(snap)
                index = {x.metadata.name: i for i, x in enumerate(wave[0])}
                victims = preempt.assign_victims(
                    chosen, scores, snap.band_prio, n_pods=len(wave[2]),
                    resident=preempt.resident_from_pods(wave[1], index))
                got = (bs.decisions_to_names(snap, chosen),
                       [sorted(v.uid for v in x) if x else None
                        for x in victims])
                part["preempting"] = part.get("preempting", 0) + sum(
                    1 for v in got[1] if v)
                what = f"(c) preemption seed {seed} {kw}"
            else:
                nodes, existing, services = _explain_state(
                    n_nodes, n_pending, hosts)
                snap = encode_snapshot(nodes, existing,
                                       _explain_extra(n_extra), services)
                chosen, scores, kms = solve(snap)
                diags = explain.explain_wave(snap, chosen, scores,
                                             device=dev)
                got = (bs.decisions_to_names(snap, chosen),
                       {j: (d.n_nodes, dict(d.counts), d.preempt)
                        for j, d in diags.items()})
                if len(got[1]) != n_extra:
                    raise AssertionError(f"phase 11 (d): {len(got[1])} of "
                                         f"{n_extra} pods diagnosed")
                what = "(d) explain"
            want, oracle_s = fut.result()
            if got != want:
                if kind in ("ext", "north_star"):
                    i = _first_diff(got, want)
                    raise AssertionError(
                        f"phase 11 {what}: pod {i} kernel {got[i]} vs "
                        f"oracle {want[i]}")
                raise AssertionError(f"phase 11 {what}: the kernel's "
                                     f"decisions differ from the oracle's")
            part["waves"] += 1
            part["pods"] += len(snap.pod_names)
            part["oracle_s"] += oracle_s
            part["kernel_ms"] += kms or 0.0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if pre and not parts["pre"].get("preempting"):
        raise AssertionError("phase 11 (c): no pod placed by preemption")
    return {"parts": parts, "launches": launches, "ns_pods": ns_pods,
            "workers": workers, "phase_s": time.perf_counter() - t_phase}


def _log_oracle(o: dict) -> None:
    names = {"ext": "(a) extension and gang waves == solve_serial",
             "north_star": f"(b) north_star {o['ns_pods']} pending == "
                           f"solve_serial",
             "pre": "(c) preemption waves == preempt_serial",
             "explain": "(d) explain_wave == explain_serial"}
    _log(f"[11] the serial oracle against the kernel: {o['launches']} "
         f"commit_solve launches, oracle in {o['workers']} worker processes, "
         f"{o['phase_s']:.2f} s")
    for k, p in o["parts"].items():
        extra = (f", {p['preempting']} placed by preemption"
                 if "preempting" in p else "")
        _log(f"     {names[k]}: {p['waves']} waves, {p['pods']} pods "
             f"compared{extra}, oracle {p['oracle_s']:.2f} s, kernel "
             f"{p['kernel_ms']:.3f} ms")


# ---- phase 12: the binaries under KTPU_RACE=1 and KTPU_DEBUG=1 -------------

# what a phase 12 process must never print: a lock-order report, a failed
# self-check, a fallback to the serial scheduler
_RACE_FAULTS = ("[locksmith]", "AssertionError", "diverged",
                "falling back to serial")


def _race_binary_phase(dev, n_nodes=500, n_pending=2_000, n_deleted=200,
                       n_added=400, seeders=4) -> dict:
    """Phase 12: the port's apiserver and scheduler binaries as their own
    processes with ``KTPU_RACE=1`` (a 1 us switch interval and locksmith
    armed at import) and ``KTPU_DEBUG=1`` (the self-checks), the scheduler
    with ``--algorithm tpu-batch --pipeline`` under the zone anti-affinity
    Policy (so the resident zone-count check has planes to check). A
    cluster of ``n_nodes`` nodes (two bound pods each, 8 services) takes
    ``n_pending`` pods from ``seeders`` threads; then ``n_deleted`` bound
    pods are deleted and ``n_added`` created at a priority above every
    bound pod (so the evictable planes are emitted and checked), and the
    delta path runs under the checks. Fails unless every pod binds within
    capacity, /metrics shows the waves solved on ``dev`` through
    commit_solve (on the card), both processes exit cleanly, and neither
    printed a locksmith report, a failed self-check or a fallback to
    serial."""
    import subprocess

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import (AFFINITY_POLICY_JSON,
                                                      build_cluster)

    t_phase = time.perf_counter()
    devtype = _device_type(dev)
    nodes, existing, pending, services = build_cluster(
        n_nodes, n_pending + n_added)
    pending, added = pending[:n_pending], pending[n_pending:]
    for p in added:
        p.spec.priority_class_name = "phase12-high"
    env = dict(os.environ, KTPU_RACE="1", KTPU_DEBUG="1")
    out_dir = os.path.join(_ROOT, "chiprun_out")
    log_path = os.path.join(out_dir, "phase12_scheduler.log")
    policy_path = os.path.join(out_dir, "phase12_policy.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(policy_path, "w") as fh:
        fh.write(AFFINITY_POLICY_JSON)
    proc, url = _start_apiserver("phase12", env=env)
    sched_proc = None
    try:
        client = Client(HTTPTransport(url))
        client.resource("priorityclasses").create(api.PriorityClass(
            metadata=api.ObjectMeta(name="phase12-high"), value=1000))
        seed_s = _seed_cluster(client, nodes, existing, services, seeders,
                               "phase 12")
        mport = _free_port()
        log = open(log_path, "w")
        sched_proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler",
             "--master", url, "--algorithm", "tpu-batch", "--pipeline",
             "--policy-config-file", policy_path, "--prewarm", "--device",
             devtype, "--metrics-port", str(mport)],
            cwd=_ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        murl = f"http://127.0.0.1:{mport}"
        _wait_http(murl + "/healthz", sched_proc, "phase 12: the binary",
                   300.0)
        deadline = time.monotonic() + 300
        while _metric_value(_http_get(murl + "/metrics")[1],
                            "compile_prewarm_ready") != 1:
            if sched_proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("phase 12: the binary's prewarm did "
                                     "not finish")
            time.sleep(0.2)

        def wait_bound(want, tag):
            deadline = time.monotonic() + 600
            while True:
                got = {p.metadata.name: p.spec.host
                       for p in client.pods("").list().items}
                if all(got.get(n) for n in want):
                    return got
                if sched_proc.poll() is not None or \
                        time.monotonic() > deadline:
                    raise AssertionError(
                        f"phase 12 {tag}: {sum(1 for n in want if got.get(n))}"
                        f" of {len(want)} pods bound")
                time.sleep(0.25)

        t0 = time.perf_counter()
        _parallel(seeders, pending, lambda p: client.pods().create(p))
        wait_bound({p.metadata.name for p in pending}, "load")
        load_s = time.perf_counter() - t0
        # churn: delete bound pods, create more, while the loop runs
        t0 = time.perf_counter()
        gone = pending[:n_deleted]
        _parallel(seeders, gone, lambda p: client.pods(
            p.metadata.namespace).delete(p.metadata.name))
        _parallel(seeders, added, lambda p: client.pods().create(p))
        want = {p.metadata.name for p in pending[n_deleted:] + added}
        got = wait_bound(want, "churn")
        churn_s = time.perf_counter() - t0
        final = client.pods("").list().items
        _code, metrics_text = _http_get(murl + "/metrics")
    finally:
        codes = []
        for p in (sched_proc, proc):
            if p is not None:
                _stop_process(p)
                codes.append(p.returncode)
    if {p.metadata.name for p in gone} & {p.metadata.name for p in final}:
        raise AssertionError("phase 12: a deleted pod is still there")
    _check_placements(final, nodes, "phase 12")
    faults = {}
    for tag, path in (("scheduler", log_path),
                      ("apiserver", os.path.join(
                          out_dir, "phase12_apiserver.log"))):
        with open(path) as fh:
            text = fh.read()
        hits = [f for f in _RACE_FAULTS if f in text]
        if hits:
            faults[tag] = hits
    if faults:
        raise AssertionError(f"phase 12: {faults} (logs in chiprun_out/"
                             f"phase12_*.log)")
    if codes != [0, 0]:
        raise AssertionError(f"phase 12: exit codes {codes} (scheduler, "
                             f"apiserver): a process that does not exit "
                             f"cleanly prints no locksmith report")
    solves = {d: _metric_value(metrics_text,
                               f'scheduler_wave_device_solves_total'
                               f'{{device="{d}"}}', default=0.0)
              for d in ("cuda", "cpu")}
    kernel = _metric_value(metrics_text,
                           "scheduler_wave_kernel_launches_total")
    if solves[devtype] == 0 or any(v for d, v in solves.items()
                                   if d != devtype):
        raise AssertionError(f"phase 12: waves solved by device {solves}")
    if devtype == "cuda" and kernel == 0:
        raise AssertionError("phase 12: no commit_solve launch")
    n_bound = len(pending) + len(added)
    return {"nodes": n_nodes, "pending": n_pending, "deleted": n_deleted,
            "added": n_added, "seed_s": list(seed_s), "load_s": load_s,
            "churn_s": churn_s, "pods_per_s": n_bound / (load_s + churn_s),
            "solves": solves, "launches": kernel,
            "replays": _metric_value(metrics_text,
                                     "encoder_resync_replay_total",
                                     default=0.0),
            "full_syncs": _metric_value(
                metrics_text, "scheduler_wave_encode_resyncs_total",
                default=0.0),
            "phase_s": time.perf_counter() - t_phase}


def _log_race_binary(r: dict) -> None:
    _log(f"[12] binaries under KTPU_RACE=1 KTPU_DEBUG=1: {r['nodes']} nodes, "
         f"{r['pending']} pending then {r['deleted']} deleted and "
         f"{r['added']} added, all bound in {r['load_s']:.2f} + "
         f"{r['churn_s']:.2f} s ({r['pods_per_s']:.1f} pods/s, a race "
         f"run: 1 us switch interval, not a speed number); waves solved "
         f"{r['solves']}, {r['launches']:.0f} commit_solve launches, "
         f"{r['replays']:.0f} journal replays, {r['full_syncs']:.0f} "
         f"full encoder syncs; no locksmith report, no failed check")


# ---- phase 13: the device mesh ---------------------------------------------

def _late_churn_cluster(n_nodes: int, n_free: int, n_pending: int,
                        seed: int):
    """A late-churn cluster: all but ``n_free`` nodes (2 cpu each) carry a
    resident pod using their whole cpu, every fifth of those also a
    service peer; ``n_pending`` pods of 250m wait. Most nodes can place
    nothing, so the submesh keep rule drops them."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity

    rng = random.Random(seed)
    free = set(rng.sample(range(n_nodes), n_free))

    def pod(name, mcpu, mem, host="", labels=None):
        return api.Pod(
            metadata=api.ObjectMeta(name=name, namespace="default",
                                    uid=f"uid-{name}", labels=labels or {}),
            spec=api.PodSpec(host=host, containers=[api.Container(
                name="c", image="i",
                resources=api.ResourceRequirements(limits={
                    "cpu": Quantity(f"{mcpu}m"),
                    "memory": Quantity(mem)}))]),
            status=api.PodStatus(host=host))

    nodes = [api.Node(metadata=api.ObjectMeta(name=f"n{i:05d}"),
                      spec=api.NodeSpec(capacity={
                          "cpu": Quantity("2"), "memory": Quantity("4Gi")}))
             for i in range(n_nodes)]
    existing = [pod(f"e{i}", 2000, "3Gi", host=f"n{i:05d}",
                    labels={"app": "web"} if i % 5 == 0 else {})
                for i in range(n_nodes) if i not in free]
    pending = [pod(f"late{i}", 250, "256Mi",
                   labels={"app": "web"} if i % 2 else {})
               for i in range(n_pending)]
    services = [api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(port=80, selector={"app": "web"}))]
    return nodes, existing, pending, services


def _resident_view(prev: dict, host):
    """The solver daemon's copy-on-write reconstruction of one wave, for
    driving a MeshExecutor directly: each resident plane equal to the
    previous wave's is that same object, a changed plane of the same
    shape is a new object with its changed rows as a (base, rows, vals)
    delta -> (inputs, delta, the planes to keep for the next wave)."""
    import numpy as np

    from kubernetes_tpu_torch.parallel.mesh import RESIDENT_FIELDS

    cols, delta, keep = {}, {}, {}
    for name in RESIDENT_FIELDS:
        cur = np.asarray(getattr(host, name))
        base = prev.get(name)
        if base is not None and base.shape == cur.shape \
                and base.dtype == cur.dtype:
            diff = ((base != cur).reshape(cur.shape[0], -1).any(axis=1)
                    if cur.size else np.zeros(0, bool))
            rows = np.flatnonzero(diff).astype(np.int64)
            if rows.size == 0:
                cols[name] = keep[name] = base
                continue
            new = base.copy()
            new[rows] = cur[rows]
            delta[name] = (base, rows, np.ascontiguousarray(cur[rows]))
            cols[name] = keep[name] = new
            continue
        cols[name] = keep[name] = np.array(cur, copy=True)
    return host._replace(**cols), delta, keep


def _mesh_phase(dev, shards=4, mesh_nodes=None, mesh_pods=None,
                cap_nodes=33_152, cap_pods=256, cap_services=8,
                beyond_pods=32, beyond_bands=40,
                ext_nodes=1_500, ext_pods=120, churn_nodes=10_000,
                churn_waves=5, churn_wave=256, late_nodes=10_000,
                late_free=1_500, late_pods=256, count_launches=True) -> dict:
    """Phase 13: a virtual mesh of ``shards`` node shards on ``dev``. (a)
    the ``mesh`` shape through the sharded loop == the single-device
    solve_scan == commit_solve's decisions; (b) the crossover: the same
    wave through ``solve(snap, mesh=...)``, one commit_solve launch and no
    sharded loop (the counted main path); (c) the capacity wave (33,152
    nodes, past the narrow instances) through the crossover: one launch
    of a large instance, no sharded loop, == single-device; a wave beyond
    the kernel's domain at the same node count (``beyond_bands`` priority
    bands, more than its 32) through the sharded loop, a preemption wave
    (the priority cluster's generator) and a zone anti-affinity wave
    (phase 4b's): sharded == single-device; (d) a MeshExecutor (dispatch
    shard, probe all) serving an IncrementalEncoder churn, each wave ==
    solve(); (e) a late-churn wave that compacts (models/submesh.py) ==
    the full solve, counted by the submesh metrics."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import batch_solver as bs
    from kubernetes_tpu_torch.models import preempt
    from kubernetes_tpu_torch.models.fixtures import (
        FULL_SHAPES, build_cluster, build_priority_cluster, build_shape)
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.parallel import mesh as pm
    from kubernetes_tpu_torch.parallel.sharded_scan import sharded_commit
    from kubernetes_tpu_torch.solver.mesh_exec import MeshExecutor
    from kubernetes_tpu_torch.util import metrics

    dev = torch.device(dev)
    mesh = pm.make_mesh([dev] * shards)
    out: dict = {"shards": shards, "device": str(dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def single(host, pol, gangs):
        sync()
        t0 = time.perf_counter()
        c, s = bs.solve_scan(bs.ship_inputs(host, dev), pol, gangs)
        both = torch.stack([c, s]).cpu().numpy()
        return both[0], both[1], time.perf_counter() - t0

    def sharded(host, pol, gangs):
        sync()
        t0 = time.perf_counter()
        c, s = pm.solve_sharded(host, mesh, pol=pol, gangs=gangs,
                                prefer_kernel=False)
        return c, s, time.perf_counter() - t0

    def same(tag, a, b):
        for x, y, what in ((a[0], b[0], "chosen"), (a[1], b[1], "scores")):
            if not np.array_equal(x, y):
                i = int(np.flatnonzero(x != y)[0])
                raise AssertionError(f"phase 13 {tag}: {what} differs at "
                                     f"pod {i}: {x[i]} vs {y[i]}")

    # ---- (a) the mesh shape, three ways --------------------------------
    t_part = time.perf_counter()
    n_nodes, n_pods, _kw, _policy = FULL_SHAPES["mesh"]
    cluster = (build_shape("mesh") if mesh_nodes is None
               else build_cluster(mesh_nodes, mesh_pods))
    n_nodes = len(cluster[0])
    snap = encode_snapshot(*cluster)
    host = bs.snapshot_to_host_inputs(snap)
    pol, gangs = snap.policy, snap.has_gangs
    inp = bs.ship_inputs(host, dev)
    if not commit_solver.eligible(inp, pol, bs.peer_bound_of(snap)):
        raise AssertionError("phase 13 (a): the mesh shape is outside the "
                             "kernel's domain; the check is three-way")
    sh = sharded(host, pol, gangs)
    sg = single(host, pol, gangs)
    sync()
    t0 = time.perf_counter()
    kc, kw = commit_solver.solve_commit(commit_solver.prepare(inp, pol,
                                                              gangs))
    kern = torch.stack([kc, kw]).cpu().numpy()
    kernel_s = time.perf_counter() - t0
    same("(a) sharded vs single-device", sh, sg)
    same("(a) sharded vs commit_solve", sh, (kern[0], kern[1]))
    if sh[0].max(initial=-1) >= n_nodes:
        raise AssertionError("phase 13 (a): a decision reached a pad node")
    if (sh[0] < 0).any():
        raise AssertionError("phase 13 (a): a pod of the mesh shape did "
                             "not bind; the cluster has room for all")
    out["a"] = {"nodes": n_nodes, "pods": len(snap.pod_names),
                "sharded_s": sh[2], "single_s": sg[2],
                "commit_solve_s": kernel_s,
                "memory": pm.shard_memory_report(host, mesh),
                "memory_one_device": pm.shard_memory_report(
                    host, pm.make_mesh([dev])),
                "seconds": time.perf_counter() - t_part}

    # ---- (b) the crossover through solve(snap, mesh=): the main path ---
    t_part = time.perf_counter()
    commit_solver.solve_commit.launches = 0
    commit_solver.solve_commit_reference.calls = 0
    sharded_commit.calls = 0
    floor = pm.DEFAULT_MESH_MIN_NODES
    if n_nodes < floor:
        pm.DEFAULT_MESH_MIN_NODES = n_nodes   # a small run's wave
    try:
        chosen, scores = bs.solve(snap, mesh=mesh)
    finally:
        pm.DEFAULT_MESH_MIN_NODES = floor
    launches = commit_solver.solve_commit.launches
    plain_calls = commit_solver.solve_commit_reference.calls
    loops = sharded_commit.calls
    if loops:
        raise AssertionError(f"phase 13 (b): the crossover ran the sharded "
                             f"loop {loops} times")
    if count_launches and (launches != 1 or plain_calls):
        raise AssertionError(f"phase 13 (b): {launches} commit_solve "
                             f"launches and {plain_calls} plain calls, want "
                             f"1 and 0")
    same("(b) crossover vs sharded", (chosen, scores), sh)
    out["b"] = {"launches": launches, "plain_calls": plain_calls,
                "sharded_loops": loops,
                "seconds": time.perf_counter() - t_part}
    out["launches"] = launches

    # ---- (c) the capacity wave, beyond the domain, preemption, zones ---
    t_part = time.perf_counter()

    def through_mesh(snap_x, n_x):
        """solve(snap_x, mesh=) with the mesh floor at the wave's nodes ->
        (chosen, scores, seconds, launches, plain calls, sharded loops)."""
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        sharded_commit.calls = 0
        floor = pm.DEFAULT_MESH_MIN_NODES
        pm.DEFAULT_MESH_MIN_NODES = min(floor, n_x)
        sync()
        t0 = time.perf_counter()
        try:
            c, s = bs.solve(snap_x, mesh=mesh)
        finally:
            pm.DEFAULT_MESH_MIN_NODES = floor
        return (c, s, time.perf_counter() - t0,
                commit_solver.solve_commit.launches,
                commit_solver.solve_commit_reference.calls,
                sharded_commit.calls)

    cap = build_cluster(cap_nodes, cap_pods, n_services=cap_services)
    csnap = encode_snapshot(*cap)
    chost = bs.snapshot_to_host_inputs(csnap)
    cbound = bs.peer_bound_of(csnap)
    if not commit_solver.eligible(chost, csnap.policy, cbound):
        raise AssertionError("phase 13 (c): the capacity wave is outside "
                             "the kernel's domain")
    cap_instance = commit_solver.instance_for(chost, csnap.policy,
                                              csnap.has_gangs,
                                              peer_bound=cbound)
    cc, cs, cap_s, cap_launches, cap_plain, cap_loops = through_mesh(
        csnap, cap_nodes)
    if cap_loops:
        raise AssertionError("phase 13 (c): the capacity wave ran the "
                             "sharded loop")
    if count_launches and (cap_launches != 1 or cap_plain):
        raise AssertionError(f"phase 13 (c): the capacity wave made "
                             f"{cap_launches} commit_solve launches and "
                             f"{cap_plain} plain calls, want 1 and 0")
    cg = single(chost, csnap.policy, csnap.has_gangs)
    same("(c) capacity", (cc, cs), cg)
    if (cc < 0).any():
        raise AssertionError("phase 13 (c): a capacity pod did not bind")
    beyond, beyond_pol = _pre_wave(random.Random(1315), cap_nodes,
                                   beyond_pods, beyond_bands)
    bsnap = encode_snapshot(*beyond, policy=beyond_pol)
    bhost = bs.snapshot_to_host_inputs(bsnap)
    if bsnap.band_prio.shape[0] <= commit_solver.MAX_B or \
            commit_solver.eligible(bhost, bsnap.policy,
                                   bs.peer_bound_of(bsnap)):
        raise AssertionError("phase 13 (c): the wave beyond the domain is "
                             "inside it")
    bc, bsc, beyond_s, _launches, _plain, beyond_loops = through_mesh(
        bsnap, cap_nodes)
    if beyond_loops != 1:
        raise AssertionError("phase 13 (c): the wave beyond the domain did "
                             "not run the sharded loop once")
    bg = single(bhost, bsnap.policy, bsnap.has_gangs)
    same("(c) beyond the domain", (bc, bsc), bg)
    pre = build_priority_cluster(ext_nodes, ext_pods)
    anti, anti_pol = _ext_wave(random.Random(1313), ext_nodes, ext_pods,
                               anti=1)
    extra = {}
    for tag, snap_x in (
            ("preemption", IncrementalEncoder().encode(*pre)),
            ("anti_affinity", encode_snapshot(*anti, policy=anti_pol))):
        xh = bs.snapshot_to_host_inputs(snap_x)
        xs = sharded(xh, snap_x.policy, snap_x.has_gangs)
        xg = single(xh, snap_x.policy, snap_x.has_gangs)
        same(f"(c) {tag}", xs, xg)
        extra[tag] = {"nodes": len(snap_x.node_names),
                      "pods": len(snap_x.pod_names),
                      "placed": int((xs[0] >= 0).sum()),
                      "by_preemption": int(
                          (xs[1] <= preempt.PREEMPT_SCORE_BASE).sum()),
                      "sharded_s": xs[2], "single_s": xg[2]}
    if not extra["preemption"]["by_preemption"]:
        raise AssertionError("phase 13 (c): no pod placed by preemption")
    out["c"] = {"nodes": cap_nodes, "pods": cap_pods,
                "services": cap_services, "groups": int(
                    csnap.group_counts.shape[0]),
                "instance": cap_instance, "launches": cap_launches,
                "crossover_s": cap_s, "single_s": cg[2],
                "beyond": {"nodes": cap_nodes, "pods": beyond_pods,
                           "bands": int(bsnap.band_prio.shape[0]),
                           "placed": int((bc >= 0).sum()),
                           "sharded_s": beyond_s, "single_s": bg[2],
                           "memory": pm.shard_memory_report(bhost, mesh)},
                **extra, "seconds": time.perf_counter() - t_part}
    out["launches"] += cap_launches

    # ---- (d) the executor over an IncrementalEncoder churn -------------
    t_part = time.perf_counter()
    me = MeshExecutor(devices=[dev] * shards, dispatch="shard", probe="all",
                      min_nodes=1)
    mm = metrics.solverd_mesh_metrics()
    nodes, existing, _p, services = build_cluster(churn_nodes, 0)
    enc = IncrementalEncoder()
    prev: dict = {}
    waves = []
    for w in range(churn_waves):
        pending = build_cluster(1, churn_wave)[2]
        for j, p in enumerate(pending):
            p.metadata.name = p.metadata.uid = f"churn-{w}-{j}"
        wsnap = enc.encode(nodes, existing, pending, services)
        whost = bs.snapshot_to_host_inputs(wsnap)
        view, delta, prev = _resident_view(prev, whost)
        x0, r0 = mm.transfer_bytes.value(), mm.reshard_bytes.value()
        t0 = time.perf_counter()
        got = me.solve(view, wsnap.policy, wsnap.has_gangs,
                       cache_key=("phase13", "churn"), delta=delta)
        solve_s = time.perf_counter() - t0
        want = bs.solve(wsnap, device=dev)
        same(f"(d) wave {w}", got, want)
        waves.append({"wave": w, "delta_planes": sorted(delta),
                      "transfer_bytes": mm.transfer_bytes.value() - x0,
                      "reshard_bytes": mm.reshard_bytes.value() - r0,
                      "placed": int((got[0] >= 0).sum()),
                      "solve_s": solve_s})
        if w and (not delta or waves[-1]["reshard_bytes"]):
            raise AssertionError(f"phase 13 (d) wave {w}: not a delta "
                                 f"scatter with residency kept "
                                 f"({waves[-1]})")
        for p, h in zip(pending, bs.decisions_to_names(wsnap, got[0])):
            if h:
                p.spec.host = p.status.host = h
                existing.append(p)
    if me.parity_divergent or me.parity_checks != churn_waves:
        raise AssertionError(f"phase 13 (d): {me.parity_checks} parity "
                             f"checks, {me.parity_divergent} divergent")
    if waves[0]["transfer_bytes"] <= max(w["transfer_bytes"]
                                         for w in waves[1:]):
        raise AssertionError("phase 13 (d): the first wave was not the "
                             "full transfer")
    out["d"] = {"nodes": churn_nodes, "waves": waves,
                "parity_checks": me.parity_checks,
                "parity_divergent": me.parity_divergent,
                "resident_bytes": mm.resident_bytes.value(),
                "seconds": time.perf_counter() - t_part}

    # ---- (e) a late-churn wave through the submesh ---------------------
    t_part = time.perf_counter()
    sm_m = metrics.solverd_submesh_metrics()
    late = _late_churn_cluster(late_nodes, late_free, late_pods, 1314)
    lsnap = encode_snapshot(*late)
    lhost = bs.snapshot_to_host_inputs(lsnap)
    # the compacted solve timed alone (no probe), then again with the
    # parity probes that re-solve it on the full plane and the mesh
    timed_me = MeshExecutor(devices=[dev] * shards, dispatch="single",
                            probe="off", min_nodes=1)
    commit_solver.solve_commit.launches = 0
    commit_solver.solve_commit_reference.calls = 0
    sync()
    t0 = time.perf_counter()
    lfast = timed_me.solve(lhost, lsnap.policy, lsnap.has_gangs)
    late_s = time.perf_counter() - t0
    # the compacted wave is inside the kernel's domain: one launch
    late_launches = commit_solver.solve_commit.launches
    late_plain = commit_solver.solve_commit_reference.calls
    if count_launches and (late_launches != 1 or late_plain):
        raise AssertionError(f"phase 13 (e): the compacted wave made "
                             f"{late_launches} commit_solve launches and "
                             f"{late_plain} plain calls, want 1 and 0")
    w0, k0 = sm_m.waves.value(), sm_m.parity_checks.value()
    kept0 = sm_m.nodes_kept.value()
    single_me = MeshExecutor(devices=[dev] * shards, dispatch="single",
                             probe="all", min_nodes=1)
    lgot = single_me.solve(lhost, lsnap.policy, lsnap.has_gangs,
                           cache_key=("phase13", "late"))
    lfull = single(lhost, lsnap.policy, lsnap.has_gangs)
    same("(e) compacted vs full", lgot, lfull)
    same("(e) compacted, no probe", lfast, lfull)
    if sm_m.waves.value() != w0 + 1 or single_me.submesh_waves != 1:
        raise AssertionError("phase 13 (e): the late-churn wave did not "
                             "compact")
    if sm_m.parity_checks.value() != k0 + 1 \
            or single_me.submesh_parity_divergent:
        raise AssertionError("phase 13 (e): the submesh parity probe did "
                             "not hold")
    out["e"] = {"nodes": late_nodes, "pods": late_pods,
                "kept": int(sm_m.nodes_kept.value() - kept0),
                "placed": int((lgot[0] >= 0).sum()),
                "compacted_s": late_s, "full_s": lfull[2],
                "launches": late_launches,
                "seconds": time.perf_counter() - t_part}
    out["launches"] += late_launches
    return out


def _log_mesh(m: dict) -> None:
    a, b, c, d, e = (m[k] for k in "abcde")
    _log(f"[13] the mesh: {m['shards']} node shards on {m['device']}")
    _log(f"     (a) {a['nodes']}x{a['pods']}: sharded == single-device == "
         f"commit_solve; sharded {a['sharded_s']:.3f}s, single-device "
         f"{a['single_s']:.3f}s, commit_solve {a['commit_solve_s']:.3f}s "
         f"(host clock, readback included); bytes per device "
         f"{a['memory']['total_bytes_per_device']} over {m['shards']} "
         f"shards vs {a['memory_one_device']['total_bytes_per_device']} on "
         f"one ({a['seconds']:.1f}s)")
    _log(f"     (b) solve(snap, mesh=): {b['launches']} commit_solve "
         f"launch(es), {b['sharded_loops']} sharded loops, "
         f"{b['plain_calls']} plain calls ({b['seconds']:.2f}s)")
    bd = c["beyond"]
    _log(f"     (c) {c['nodes']}x{c['pods']}, {c['groups']} groups, through "
         f"the crossover: {c['launches']} launch of {c['instance']}, "
         f"{c['crossover_s']:.3f}s == single-device {c['single_s']:.3f}s; "
         f"{bd['nodes']}x{bd['pods']} with {bd['bands']} band slots, beyond "
         f"the kernel's domain: sharded {bd['sharded_s']:.3f}s == "
         f"single-device {bd['single_s']:.3f}s, "
         f"{bd['memory']['total_bytes_per_device']} B per device, "
         f"{bd['placed']} placed; preemption {c['preemption']['nodes']}x"
         f"{c['preemption']['pods']} ({c['preemption']['by_preemption']} "
         f"by preemption) sharded {c['preemption']['sharded_s']:.3f}s vs "
         f"{c['preemption']['single_s']:.3f}s; anti-affinity "
         f"{c['anti_affinity']['nodes']}x{c['anti_affinity']['pods']} "
         f"sharded {c['anti_affinity']['sharded_s']:.3f}s vs "
         f"{c['anti_affinity']['single_s']:.3f}s ({c['seconds']:.1f}s)")
    _log(f"     (d) MeshExecutor churn at {d['nodes']} nodes: "
         f"{len(d['waves'])} waves == solve(), {d['parity_checks']} parity "
         f"checks, {d['parity_divergent']} divergent ({d['seconds']:.1f}s)")
    for w in d["waves"]:
        _log(f"         wave {w['wave']}: {w['transfer_bytes']} B moved, "
             f"{w['reshard_bytes']} B resharded, deltas "
             f"{w['delta_planes']}, {w['placed']} placed, "
             f"{w['solve_s']:.3f}s")
    _log(f"     (e) late churn {e['nodes']}x{e['pods']}: compacted to "
         f"{e['kept']} nodes, {e['placed']} placed, {e['launches']} "
         f"commit_solve launch, compacted {e['compacted_s']:.3f}s vs full "
         f"{e['full_s']:.3f}s ({e['seconds']:.1f}s)")


# ---- phase 14: the fleet: kube-store, apiserver workers, kills ------------


class _BindWatch:
    """Every pod's binds, through a watch of ``url`` that outlives the
    kills: when its stream ends (the worker or the store behind it died)
    it resumes from its last resourceVersion, and relists when that
    revision is gone. ``hosts[name]`` holds every host a pod of ``names``
    was seen on, ``first[name]`` when it was first seen bound. The watch
    speaks ``version`` (v1 unless named: phase 16 watches in v1beta1)."""

    def __init__(self, url: str, names, version: str = ""):
        import threading

        from kubernetes_tpu_torch.client.client import Client
        from kubernetes_tpu_torch.client.http import HTTPTransport

        self.client = Client(HTTPTransport(url, version=version))
        self.names = names
        self.hosts: dict = {}
        self.first: dict = {}
        self.resumes = self.relists = 0
        self._w = None
        self._stop = threading.Event()
        rv = self._relist()
        self.thread = threading.Thread(target=self._run, args=(rv,),
                                       daemon=True, name="bind-watch")
        self.thread.start()

    def _resource(self):
        return self.client.pods("")

    def _see(self, pod, kind: str = "") -> None:
        name, host = pod.metadata.name, pod.spec.host
        if host and name in self.names:
            self.hosts.setdefault(name, set()).add(host)
            self.first.setdefault(name, time.perf_counter())

    def _relist(self) -> str:
        lst = self._resource().list()
        for p in lst.items:
            self._see(p)
        return lst.metadata.resource_version

    def _run(self, rv: str) -> None:
        import http.client

        from kubernetes_tpu_torch.api import errors

        while not self._stop.is_set():
            try:
                if not rv:
                    rv = self._relist()
                    self.relists += 1
                self._w = w = self._resource().watch(resource_version=rv)
                while True:
                    ev = w.next_event()
                    if ev is None:
                        break
                    if ev.type == "ERROR":  # dropped to resync
                        rv = ""
                        break
                    rv = ev.object.metadata.resource_version
                    self._see(ev.object, ev.type)
            except errors.StatusError as e:
                if e.code == 410:
                    rv = ""
                self._stop.wait(0.1)
            except (OSError, http.client.HTTPException):
                self._stop.wait(0.1)
            if not self._stop.is_set():
                self.resumes += 1

    def wait_for(self, n: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while len(self.first) < n:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.02)
        return True

    def stop(self) -> None:
        self._stop.set()
        if self._w is not None:
            self._w.stop()
        self.thread.join(timeout=20)


def _create_riding_kills(client, pod, acked: dict, landed: set,
                         deadline_s: float = 300.0) -> None:
    """Create ``pod``, resending through the outages a kill opens (a reset
    connection, a 5xx, a 429) until the create is acknowledged
    (``acked[name] = (time, resourceVersion)``) or a resend answers 409:
    an earlier attempt landed without its acknowledgement (``landed``)."""
    import http.client

    from kubernetes_tpu_torch.api import errors

    name = pod.metadata.name
    deadline = time.monotonic() + deadline_s
    for attempt in itertools.count():
        try:
            out = client.pods().create(pod)
            acked[name] = (time.perf_counter(),
                           int(out.metadata.resource_version))
            return
        except errors.StatusError as e:
            if e.code == 409 and attempt:
                landed.add(name)
                return
            if e.code < 500 and e.code != 429:
                raise
            err: Exception = e
        except (OSError, http.client.HTTPException) as e:
            err = e
        if time.monotonic() > deadline:
            raise AssertionError(f"create of {name} failed for "
                                 f"{deadline_s:.0f} s: {err!r}")
        time.sleep(0.05)


def _api_requests(body: str) -> float:
    """An apiserver's API requests on its /metrics: the sum of
    ``apiserver_request_count`` over every resource (probes of /metrics
    and /healthz carry none)."""
    return sum(float(line.split()[-1]) for line in body.splitlines()
               if line.startswith("apiserver_request_count{")
               and 'resource=""' not in line)


def _worker_metrics(url: str, workers: int, tries: int = 400) -> dict:
    """/metrics of each worker behind one SO_REUSEPORT port: a new
    connection a request (the kernel spreads them over the workers) until
    every worker answered -> {worker index: body}."""
    got: dict = {}
    for _ in range(tries):
        body = _http_get(url + "/metrics")[1]
        got.setdefault(int(_metric_value(body, "apiserver_worker_index")),
                       body)
        if len(got) == workers:
            break
    return got


def _abort_children(procs, tag: str) -> None:
    """After a failed phase: every live child (started by ``_spawn``, so
    with faulthandler on) dumps its threads' stacks into its log on
    SIGABRT, and this process's threads go to chiprun_out/<tag>_threads.log."""
    import faulthandler
    import signal

    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGABRT)
            try:
                proc.wait(timeout=10)
            except Exception:  # _stop_process kills it next
                pass
    with open(os.path.join(_ROOT, "chiprun_out", f"{tag}_threads.log"),
              "w") as fh:
        faulthandler.dump_traceback(file=fh)


def _kill(proc) -> float:
    """SIGKILL ``proc`` and reap it -> the time of the kill."""
    import signal

    t = time.perf_counter()
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    return t


def _drive_under_kills(dev, url: str, tag: str, nodes, existing, services,
                       pending, kills, creators: int, seeders: int,
                       wave_size=None) -> dict:
    """Seed a cluster through ``url`` and run the port's scheduler binary
    against it in a thread of this process (``--algorithm tpu-batch
    --prewarm``, waves recorded by ``_WaveLog``); once it is warm and its
    caches hold the cluster, create ``pending`` from ``creators`` threads
    (``_create_riding_kills``) and count the binds through a watch
    (``_BindWatch``). ``kills`` is a list of ``(fraction, name, kill,
    respawn)``: after the first wave by whose end the watch saw that
    fraction of the pending pods bound, two marker Secrets are written
    (so a write is acknowledged just before), ``kill()`` SIGKILLs a
    component in the loop's thread, between two waves, so that no bind is
    in flight when it dies, and ``respawn()`` brings it back from another
    thread and returns what its recovery disclosed. -> the run's record,
    every pod read back after it, and the binary's /healthz."""
    import gc
    import threading

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.ops import commit_solver

    names = {p.metadata.name for p in pending}
    client = Client(HTTPTransport(url))
    mark = "-".join(re.findall("[a-z0-9]+", tag))
    done: dict = {}
    respawns: list = []
    state: dict = {"watch": None}

    def after_wave(row) -> None:
        try:
            chaos(row)
        except Exception as e:  # the loop would log it and go on
            state.setdefault("error", repr(e))

    def chaos(row) -> None:
        bw = state["watch"]
        if bw is None or not row["bound_names"] or "error" in state:
            return
        # the watch catches up with the loop's binds before it decides
        bw.wait_for(min(len(names), sum(
            len(r["bound_names"]) for r in wl.rows)), 30.0)
        for frac, what, kill, respawn in kills:
            if what in done or len(bw.first) < frac * len(names):
                continue
            marks = [client.secrets("default").create(api.Secret(
                metadata=api.ObjectMeta(name=f"{mark}-{what}-{k}")))
                for k in range(2)]
            t_kill = kill()
            done[what] = {"t_kill": t_kill, "bound_seen": len(bw.first),
                          "wave": len(wl.rows) - 1,
                          "marks": [m.metadata.name for m in marks],
                          "mark_rv": max(int(m.metadata.resource_version)
                                         for m in marks)}

            def back(what=what, respawn=respawn, t_kill=t_kill):
                try:
                    info = respawn()
                    done[what].update(info, healthy_s=time.perf_counter()
                                      - t_kill)
                except BaseException as e:  # re-raised after the load
                    done[what]["error"] = repr(e)

            th = threading.Thread(target=back, daemon=True,
                                  name=f"respawn-{what}")
            th.start()
            respawns.append(th)

    wl = _WaveLog(after_wave)
    t_phase = time.perf_counter()
    seed_s = _seed_cluster(client, nodes, existing, services, seeders, tag)
    mport = _free_port()
    argv = ["--master", url, "--algorithm", "tpu-batch", "--prewarm",
            "--metrics-port", str(mport), "--device", _device_type(dev)]
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}

    def on_built(sched):
        if wave_size is not None:
            sched.wave_size = wave_size
        wl(sched)

    thread = threading.Thread(
        target=lambda: result.update(rc=cmd.scheduler_server(
            argv, ready, stop, on_built=on_built)), daemon=True,
        name=f"{tag}-binary")
    acked: dict = {}
    landed: set = set()
    bw = None
    try:
        thread.start()
        murl = f"http://127.0.0.1:{mport}"
        deadline = time.monotonic() + 600
        while "compile_prewarm_ready 1" not in _wait_http(
                murl + "/metrics", None,
                f"{tag}: the scheduler binary").splitlines():
            if "rc" in result or time.monotonic() > deadline:
                raise AssertionError(f"{tag}: no prewarm (binary returned "
                                     f"{result.get('rc')})")
            time.sleep(0.2)
        f = wl.sched.factory
        while not (len(f.node_store) == len(nodes)
                   and len(f.scheduled_pods) == len(existing)
                   and len(f.service_store) == len(services)):
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: the scheduler's caches never "
                                     f"held the cluster")
            time.sleep(0.05)
        state["watch"] = bw = _BindWatch(url, names)
        gc.callbacks.append(wl.on_gc)
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t_first = time.perf_counter()
        _parallel(creators, pending,
                  lambda p: _create_riding_kills(client, p, acked, landed))
        create_s = time.perf_counter() - t_first
        if not bw.wait_for(len(names), 300.0):
            raise AssertionError(f"{tag}: {len(bw.first)} of {len(names)} "
                                 f"binds seen through the watch")
        t_last = max(bw.first.values())
        while sum(len(r["bound_names"]) for r in wl.rows) < len(names):
            if time.monotonic() > deadline or "rc" in result:
                raise AssertionError(f"{tag}: the loop did not record "
                                     f"every bind")
            time.sleep(0.05)
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        for th in respawns:
            th.join(timeout=300)
        if "error" in state:
            raise AssertionError(f"{tag}: between two waves: "
                                 f"{state['error']}")
        missed = [k[1] for k in kills if k[1] not in done]
        failed = {k: v["error"] for k, v in done.items() if "error" in v}
        if missed or failed:
            raise AssertionError(f"{tag}: kills not made {missed}, respawns "
                                 f"failed {failed}")
        code, body = _http_get(murl + "/healthz")
        health = json.loads(body)
        if code != 200 or health.get("healthy") is not True:
            raise AssertionError(f"{tag}: /healthz {code} {body}")
        final = client.pods("").list().items
        secrets = {s.metadata.name
                   for s in client.secrets("default").list().items}
        svcs = f.service_store.list()
    finally:
        if wl.on_gc in gc.callbacks:
            gc.callbacks.remove(wl.on_gc)
        if bw is not None:
            bw.stop()
        stop.set()
        thread.join(timeout=60)
        for th in respawns:
            th.join(timeout=60)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    return {"rows": [r for r in wl.rows if r["order"]], "final": final,
            "svcs": svcs, "secrets": secrets, "acked": acked,
            "landed": landed, "kills": done, "watch": bw,
            "launches": launches, "plain_calls": plain_calls,
            "health": health, "gc": dict(wl.gc), "seed_s": seed_s,
            "t_phase": t_phase, "t_first": t_first, "t_last": t_last,
            "create_s": create_s}


def _check_run(run: dict, dev, nodes, pending, tag: str,
               count_launches: bool) -> dict:
    """A run of ``_drive_under_kills`` against what was acknowledged:
    every pending pod bound exactly once (the watch saw one host each),
    no node over capacity and no host port twice, every create and marker
    acknowledged before a kill read back after it, and ``_check_waves``."""
    names = {p.metadata.name for p in pending}
    final, rows = run["final"], run["rows"]
    by_name = {p.metadata.name: p for p in final}
    lost = [n for n in run["acked"] if n not in by_name]
    if lost:
        raise AssertionError(f"{tag}: {len(lost)} acknowledged creates "
                             f"lost, e.g. {lost[0]}")
    unbound = [n for n in names if not by_name.get(n)
               or not by_name[n].spec.host]
    if unbound:
        raise AssertionError(f"{tag}: {len(unbound)} pods unbound")
    twice = {n: h for n, h in run["watch"].hosts.items() if len(h) != 1}
    if twice or len(run["watch"].hosts) != len(names):
        raise AssertionError(f"{tag}: pods seen on more than one host "
                             f"{list(twice.items())[:3]}, or never")
    _check_placements(final, nodes, tag)
    for what, k in run["kills"].items():
        gone = [m for m in k["marks"] if m not in run["secrets"]]
        if gone:
            raise AssertionError(f"{tag}: markers written before the "
                                 f"{what} kill lost: {gone}")
    checks = _check_waves(rows, final, names, run["svcs"], dev, tag,
                          count_launches, run["launches"],
                          run["plain_calls"])
    return checks


def _kill_record(run: dict) -> dict:
    """Each kill's numbers, in seconds from the first create."""
    t_first = run["t_first"]
    return {what: {k: (v - t_first if k == "t_kill" else v)
                   for k, v in rec.items()}
            for what, rec in run["kills"].items()}


def _fleet_phase(dev, n_nodes=5_000, n_pending=5_000, workers=2, shards=4,
                 seeders=8, creators=4, wave_size=None,
                 count_launches=True) -> dict:
    """Phase 14 (a): the reference's production topology on the port.
    One kube-store (``cmd.storeserver --shards 4 --data-dir --metrics-port``,
    a ``DurableStripedStore``), a share segment this script creates with
    ``ShareSegment.create(path, workers)``, ``workers`` apiserver processes
    on one port (``--store-server --reuse-port --share-seg
    --share-worker i``), and the scheduler binary in a thread: north_star
    (``n_nodes`` nodes, 2 bound pods each, 8 services) seeded through the
    shared port, then ``n_pending`` pods from ``creators`` threads. Once a
    third of them are bound the kube-store is SIGKILLed and respawned with
    the same flags; once two thirds are, worker 0 is, with the same share
    index. Fails unless ``_check_run`` holds; the respawned store's
    /healthz discloses a recovery that replayed WAL records up to an index
    at or above every resourceVersion acknowledged before its kill; each
    worker served requests and a frame one published was imported by the
    other; and the segment's ledger counted every bind, no more creates
    than there were, and reads a backlog of 0."""
    import shutil
    import tempfile

    from kubernetes_tpu_torch.apiserver.share import (SharedLedger,
                                                      ShareSegment)
    from kubernetes_tpu_torch.models.fixtures import build_cluster

    t_phase = time.perf_counter()
    nodes, existing, pending, services = build_cluster(n_nodes, n_pending)
    work = tempfile.mkdtemp(prefix="phase14-")
    data_dir = os.path.join(work, "store")
    seg_path = os.path.join(work, "share.seg")
    seg = ShareSegment.create(seg_path, workers)
    sport, smport, port = _free_port(), _free_port(), _free_port()
    store_args = ["--port", sport, "--shards", shards, "--data-dir",
                  data_dir, "--metrics-port", smport]
    surl = f"http://127.0.0.1:{smport}"
    procs: dict = {}

    def worker_args(i):
        return ["--store-server", f"127.0.0.1:{sport}", "--reuse-port",
                "--share-seg", seg_path, "--share-worker", i]

    def start_store(respawn=False):
        procs["store"], up_s = _spawn(
            "phase14_store", "kubernetes_tpu_torch.cmd.storeserver",
            store_args, "kube-store listening on", respawn=respawn)
        health = json.loads(_wait_http(surl + "/healthz", procs["store"],
                                       "phase 14: kube-store", 60.0))
        return {"up_s": up_s, "recovery": health.get("recovery")}

    def start_worker(i, respawn=False):
        t0 = time.perf_counter()
        procs[i], url = _start_apiserver(f"phase14_worker{i}",
                                         args=worker_args(i), port=port,
                                         respawn=respawn)
        return {"up_s": time.perf_counter() - t0}

    before_kill: dict = {}

    def kill_worker0():
        before_kill.update(_worker_metrics(url, workers))
        return _kill(procs[0])

    url = f"http://127.0.0.1:{port}"
    try:
        store0 = start_store()
        for i in range(workers):
            start_worker(i)
        run = _drive_under_kills(
            dev, url, "phase 14 (a)", nodes, existing, services, pending,
            [(1 / 3, "kube-store", lambda: _kill(procs["store"]),
              lambda: start_store(respawn=True)),
             (2 / 3, "worker0", kill_worker0,
              lambda: start_worker(0, respawn=True))],
            creators, seeders, wave_size)
        per_worker = _worker_metrics(url, workers)
        store_metrics = _http_get(surl + "/metrics")[1]
        ledger = SharedLedger(seg)
        counters = [seg.worker_counters(w) for w in range(workers)]
        backlog = ledger.backlog()
    except BaseException:
        _abort_children(procs.values(), "phase14")
        raise
    finally:
        for proc in procs.values():
            _stop_process(proc)
        seg.close()
        shutil.rmtree(work, ignore_errors=True)

    tag = "phase 14 (a)"
    checks = _check_run(run, dev, nodes, pending, tag, count_launches)
    kill = run["kills"]["kube-store"]
    rec = kill.get("recovery") or {}
    acked_rv = max([rv for t, rv in run["acked"].values()
                    if t < kill["t_kill"]] + [kill["mark_rv"]])
    if not (rec.get("replayed_records", 0) > 0
            and rec.get("index", 0) >= acked_rv):
        raise AssertionError(f"{tag}: the respawned kube-store's recovery "
                             f"{rec} against resourceVersion {acked_rv} "
                             f"acknowledged before its kill")
    if sorted(per_worker) != list(range(workers)):
        raise AssertionError(f"{tag}: workers answering /metrics: "
                             f"{sorted(per_worker)}")
    requests = {w: _api_requests(b) for w, b in per_worker.items()}
    before = {w: _api_requests(b) for w, b in before_kill.items()}
    if sorted(before) != list(range(workers)) or not all(
            before.values()) or not all(requests[w]
                                        for w in range(1, workers)):
        raise AssertionError(f"{tag}: API requests served per worker "
                             f"{before} before worker 0's kill, {requests} "
                             f"at the end")
    # worker 0's counters restart with it: its life before the kill adds
    seeds = {w: {k: _metric_value(b, f"apiserver_cache_seed_{k}_total")
                 + (_metric_value(before_kill[0],
                                  f"apiserver_cache_seed_{k}_total")
                    if w == 0 else 0.0)
                 for k in ("published", "imported", "ring_drops")}
             for w, b in per_worker.items()}
    if not any(s["published"] for s in seeds.values()) or \
            not any(s["imported"] for s in seeds.values()):
        raise AssertionError(f"{tag}: no frame seed published by one "
                             f"worker and imported by another: {seeds}")
    n_pods = len(existing) + n_pending
    created = sum(c["created"] for c in counters)
    bound = sum(c["bound"] for c in counters)
    if backlog != 0 or bound != n_pods or not (
            len(run["acked"]) <= created <= n_pods):
        raise AssertionError(f"{tag}: ledger backlog {backlog}, created "
                             f"{created}, bound {bound} for {n_pods} pods "
                             f"({len(run['acked'])} creates acknowledged)")
    return {"nodes": n_nodes, "existing": len(existing),
            "pending": n_pending, "workers": workers, "shards": shards,
            "creators": creators, "seed_s": list(run["seed_s"]),
            "create_s": run["create_s"],
            "loop_s": run["t_last"] - run["t_first"],
            "pods_per_s": n_pending / (run["t_last"] - run["t_first"]),
            "store_boot": store0, "kills": _kill_record(run),
            "acked_rv_before_store_kill": acked_rv,
            "creates_landed_unacked": len(run["landed"]),
            "waves": _wave_rows(run["rows"], run["t_first"]),
            "launches": run["launches"], "plain_calls": run["plain_calls"],
            "watch_resumes": run["watch"].resumes,
            "watch_relists": run["watch"].relists,
            "requests": requests, "requests_before_worker0_kill": before,
            "seeds": seeds, "ledger": {"backlog": backlog,
                                       "created": created, "bound": bound,
                                       "workers": counters},
            "wal": {k: _metric_value(store_metrics, f"store_wal_{k}",
                                     default=0.0)
                    for k in ("records_total", "ops_total",
                              "group_commits_total", "bytes_total",
                              "compactions_total", "size_bytes")},
            "health": run["health"], "gc_s": run["gc"]["s"], **checks,
            "phase_s": time.perf_counter() - t_phase}


def _durable_phase(dev, n_nodes=5_000, n_pending=2_000, seeders=8,
                   creators=4, wave_size=None, count_launches=True) -> dict:
    """Phase 14 (b): one apiserver process with ``--data-dir`` (a
    ``DurableStore``) holding north_star's ``n_nodes`` nodes and 8
    services, the scheduler binary in a thread against it, ``n_pending``
    pods from ``creators`` threads; once half are bound the apiserver is
    SIGKILLed and respawned on the same port and directory, which the
    binary rides (its HTTPTransport connect retry). Fails unless
    ``_check_run`` holds and the respawned apiserver's /healthz discloses a
    recovery that replayed WAL records up to an index at or above every
    resourceVersion acknowledged before the kill."""
    import shutil
    import tempfile

    from kubernetes_tpu_torch.models.fixtures import build_cluster

    t_phase = time.perf_counter()
    nodes, _existing, pending, services = build_cluster(n_nodes, n_pending)
    work = tempfile.mkdtemp(prefix="phase14b-")
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    args = ["--data-dir", os.path.join(work, "data")]
    procs: dict = {}

    def respawn():
        procs["apiserver"], _url = _start_apiserver(
            "phase14b", args=args, port=port, respawn=True)
        return {"recovery": json.loads(
            _http_get(url + "/healthz")[1]).get("recovery")}

    try:
        procs["apiserver"], _url = _start_apiserver("phase14b", args=args,
                                                    port=port)
        run = _drive_under_kills(
            dev, url, "phase 14 (b)", nodes, [], services, pending,
            [(1 / 2, "apiserver", lambda: _kill(procs["apiserver"]),
              respawn)], creators, seeders, wave_size)
    except BaseException:
        _abort_children(procs.values(), "phase14b")
        raise
    finally:
        for proc in procs.values():
            _stop_process(proc)
        shutil.rmtree(work, ignore_errors=True)
    tag = "phase 14 (b)"
    checks = _check_run(run, dev, nodes, pending, tag, count_launches)
    kill = run["kills"]["apiserver"]
    rec = kill.get("recovery") or {}
    acked_rv = max([rv for t, rv in run["acked"].values()
                    if t < kill["t_kill"]] + [kill["mark_rv"]])
    if not (rec.get("replayed_records", 0) > 0
            and rec.get("index", 0) >= acked_rv):
        raise AssertionError(f"{tag}: the respawned apiserver's recovery "
                             f"{rec} against resourceVersion {acked_rv} "
                             f"acknowledged before its kill")
    return {"nodes": n_nodes, "pending": n_pending, "creators": creators,
            "seed_s": list(run["seed_s"]), "create_s": run["create_s"],
            "loop_s": run["t_last"] - run["t_first"],
            "pods_per_s": n_pending / (run["t_last"] - run["t_first"]),
            "kills": _kill_record(run),
            "acked_rv_before_kill": acked_rv,
            "creates_landed_unacked": len(run["landed"]),
            "waves": _wave_rows(run["rows"], run["t_first"]),
            "launches": run["launches"], "plain_calls": run["plain_calls"],
            "watch_resumes": run["watch"].resumes,
            "watch_relists": run["watch"].relists,
            "health": run["health"], **checks,
            "phase_s": time.perf_counter() - t_phase}


def _log_fleet(a: dict, b: dict) -> None:
    ks, kw = a["kills"]["kube-store"], a["kills"]["worker0"]
    _log(f"[14] the fleet: kube-store (--shards {a['shards']}, a durable "
         f"striped store), {a['workers']} apiserver workers on one port "
         f"with a share segment, the scheduler binary on the card: "
         f"{a['nodes']} nodes, {a['existing']} resident pods seeded in "
         f"{' + '.join(f'{s:.2f}' for s in a['seed_s'])} s; "
         f"{a['pending']} pending from {a['creators']} threads in "
         f"{a['create_s']:.2f} s, last bind seen through a watch after "
         f"{a['loop_s']:.3f} s: {a['pods_per_s']:.1f} pods/s; "
         f"{len(a['waves'])} waves, {a['launches']} commit_solve launches, "
         f"{a['plain_calls']} plain-version calls")
    _log(f"     kube-store SIGKILLed {ks['t_kill']:.2f} s into the load "
         f"(after wave {ks['wave']}, {ks['bound_seen']} bound), healthy "
         f"again {ks['healthy_s']:.2f} s later; recovery {ks['recovery']}; "
         f"worker 0 SIGKILLed {kw['t_kill']:.2f} s in (after wave "
         f"{kw['wave']}, {kw['bound_seen']} bound), healthy again "
         f"{kw['healthy_s']:.2f} s later; {a['creates_landed_unacked']} "
         f"creates landed unacknowledged; the bind watch resumed "
         f"{a['watch_resumes']} times, relisted {a['watch_relists']}")
    _log(f"     WAL {a['wal']}; API requests per worker "
         f"{a['requests_before_worker0_kill']} before worker 0's kill, "
         f"{a['requests']} at the end; frame seeds {a['seeds']}; ledger "
         f"{a['ledger']}")
    for w in a["waves"] + b["waves"]:
        kernel = ("" if w["kernel_ms"] is None
                  else f", kernel {w['kernel_ms']:.3f} ms")
        _log(f"     wave {w['wave']:2d} {w['pods']:5d} pods: encode "
             f"{w['encode_s']:.4f} s, solve {w['solve_s']:.4f} s{kernel}, "
             f"commit {w['commit_s']:.4f} s ({w['binds_failed']} binds "
             f"failed), ended {w['t_end_s']:.3f} s into the load; launches "
             f"{w['launches']}")
    kb = b["kills"]["apiserver"]
    _log(f"     (b) a durable apiserver alone: {b['nodes']} nodes, "
         f"{b['pending']} pending in {b['loop_s']:.3f} s "
         f"({b['pods_per_s']:.1f} pods/s), {len(b['waves'])} waves, "
         f"{b['launches']} launches; SIGKILLed {kb['t_kill']:.2f} s in "
         f"(after wave {kb['wave']}, {kb['bound_seen']} bound), healthy "
         f"again {kb['healthy_s']:.2f} s later, recovery "
         f"{kb['recovery']}")
    _log(f"     every pod bound exactly once within capacity, every "
         f"acknowledged write read back, every wave == the plain version "
         f"(max abs err {max(a['max_abs_err'], b['max_abs_err'])}) and == "
         f"solve(encode_snapshot) of its state; phase "
         f"{a['phase_s']:.1f} + {b['phase_s']:.1f} s")


class _LifeWatch(_BindWatch):
    """Each object's life through ``_BindWatch``'s resuming watch, for
    pods (``resource="pods"``) or nodes, of those ``want`` keeps: when it
    was first seen (``seen``), its labels, its hosts and first bind (pods),
    when its conditions were first written (nodes, ``conds``) and when it
    was deleted (``deleted``; a relist marks what it no longer lists);
    ``events`` counts what it saw. With ``count_by`` (a label's name) it
    keeps, for each value of that label, how many objects carrying it are
    alive (``alive_by``) and the most that ever were at once
    (``peak_by``)."""

    def __init__(self, url: str, resource: str = "pods",
                 want=lambda obj: True, count_by: str = ""):
        self.resource, self.want = resource, want
        self.seen: dict = {}
        self.labels: dict = {}
        self.conds: dict = {}
        self.deleted: dict = {}
        self.events = 0
        self.count_by = count_by
        self.alive_by: dict = {}
        self.peak_by: dict = {}
        self.peak_at: dict = {}
        super().__init__(url, names=None)

    def _count(self, name: str, step: int) -> None:
        key = self.labels[name].get(self.count_by)
        if self.count_by and key is not None:
            n = self.alive_by[key] = self.alive_by.get(key, 0) + step
            if n > self.peak_by.get(key, 0):
                self.peak_by[key] = n
                self.peak_at[key] = (time.perf_counter(), name,
                                     self.relists, self.resumes)

    def _gone(self, name: str, t: float) -> None:
        if name in self.seen and name not in self.deleted:
            self._count(name, -1)
        self.deleted.setdefault(name, t)

    def _resource(self):
        return (self.client.pods("") if self.resource == "pods"
                else self.client.nodes())

    def _see(self, obj, kind: str = "") -> None:
        if not self.want(obj):
            return
        name, t = obj.metadata.name, time.perf_counter()
        self.events += 1
        if kind == "DELETED":
            self.labels.setdefault(name, dict(obj.metadata.labels))
            self._gone(name, t)
            return
        if name not in self.seen and name not in self.deleted:
            self.labels.setdefault(name, dict(obj.metadata.labels))
            self.seen[name] = t
            self._count(name, 1)
        self.seen.setdefault(name, t)
        self.labels.setdefault(name, dict(obj.metadata.labels))
        if self.resource == "pods":
            if obj.spec.host:
                self.hosts.setdefault(name, set()).add(obj.spec.host)
                self.first.setdefault(name, t)
        elif len(obj.status.conditions) >= 3:
            self.conds.setdefault(name, t)

    def _relist(self) -> str:
        # what the list no longer holds is gone before what it newly holds
        # is counted, so that a pod replaced while the watch was down does
        # not count twice in ``alive_by``
        lst = self._resource().list()
        listed = {obj.metadata.name for obj in lst.items}
        t = time.perf_counter()
        for name in set(self.seen) - listed:
            self._gone(name, t)
        for obj in lst.items:
            self._see(obj)
        return lst.metadata.resource_version

    def alive(self) -> set:
        return set(self.seen) - set(self.deleted)


def _cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of process ``pid`` (Linux /proc)."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _write_inventory(path: str, names, mtime=None) -> None:
    """The inventory cloud's JSON (cloudprovider/inventory.py), written
    through a temporary file and ``os.replace``: one instance per name
    with north_star's capacities and one address, no labels; ``mtime``
    set explicitly, so that a rewrite inside the filesystem's timestamp
    granularity still reloads."""
    instances = [{"name": n, "addresses": [f"10.{k >> 16 & 255}."
                                           f"{k >> 8 & 255}.{k & 255}"],
                  "cpu": "16", "memory": "64Gi"}
                 for k, n in enumerate(names)]
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"zone": {"failure_domain": "z0", "region": "local"},
                   "instances": instances}, fh)
    os.replace(tmp, path)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def _rc_object(name: str, app: str, replicas: int, k: int, host_port: int):
    """An RC of ``replicas`` pods of one container: cpu ``100 + (k % 8) *
    100`` m and memory ``128 + (k % 6) * 256`` Mi (north_star's pending
    pods), labelled ``app`` (its service's selector) and ``rc`` (its own,
    so that two RCs of one app do not count each other's pods), with
    ``host_port`` when it is not 0."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity

    labels = {"app": app, "rc": name}
    ports = ([api.ContainerPort(container_port=80, host_port=host_port)]
             if host_port else [])
    return api.ReplicationController(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=replicas, selector=dict(labels),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels=dict(labels)),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", image="img", ports=ports,
                    resources=api.ResourceRequirements(limits={
                        "cpu": Quantity(f"{100 + (k % 8) * 100}m"),
                        "memory": Quantity(f"{128 + (k % 6) * 256}Mi")}))]))))


def _waiter(tag: str, procs: list, result: dict, elapsed,
            default_s: float):
    """-> wait(cond, what, deadline_s=default_s, poll_s=0.05,
    progress=None) for a phase that runs ``procs`` and the scheduler
    binary in a thread (its return code lands in ``result``): polls
    ``cond`` until it holds; fails when a process exited, the binary
    returned or the deadline passed; every 30 s logs ``progress()``."""
    def wait(cond, what: str, deadline_s: float = default_s,
             poll_s: float = 0.05, progress=None):
        deadline = time.monotonic() + deadline_s
        next_log = time.monotonic() + 30.0
        while not cond():
            if progress is not None and time.monotonic() > next_log:
                next_log += 30.0
                _log(f"     {tag}: {elapsed()} waiting for {what}: "
                     f"{progress()}")
            for p in procs:
                if p.poll() is not None:
                    raise AssertionError(f"{tag}: a process exited with "
                                         f"{p.returncode} while waiting "
                                         f"for {what}")
            if "rc" in result:
                raise AssertionError(f"{tag}: the binary returned "
                                     f"{result['rc']} while waiting for "
                                     f"{what}")
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag}: {what} not within "
                                     f"{deadline_s:.0f} s")
            time.sleep(poll_s)
    return wait


def _controller_phase(dev, n_nodes=5_000, apps=8, versions=5, replicas=250,
                      n_gone=100, scale=(("rc-0-1", 100), ("rc-1-1", 400)),
                      host_ports=True, seeders=8, wave_size=None,
                      wave_period=2.0, count_launches=True,
                      keep_rows=False) -> dict:
    """Phase 15: the controller manager feeding the card. The port's
    kube-apiserver (``--cloud-provider inventory``) and
    kube-controller-manager (``--cloud-provider inventory
    --node-sync-period 1``, ``KTPU_CLOUD_INVENTORY`` this phase's
    inventory file) as processes, the scheduler binary (``--algorithm
    tpu-batch --prewarm --wave-period`` ``wave_period``: the RCs' pods
    arrive a few dozen a second, and a wave that gathers them that long
    keeps the per-wave checks to a few hundred waves) in a thread, waves
    recorded with the encoder's state (``_WaveLog(keep_state=True)``).
    (1) The NodeController registers the inventory's ``n_nodes``
    instances and writes their conditions (a watch of nodes times both).
    (2) north_star's 8 services and resident pods are seeded, bound. (3)
    ``apps * versions`` RCs ``rc-{a}-{v}`` of ``replicas`` each, app
    ``app-{a}``; the ``v = 0`` templates carry host port ``7000 + a``
    when ``host_ports``. (4) The inventory is rewritten without
    ``n_gone`` instances: their nodes and pods must go, the RCs recreate
    what they lost and the new pods bind on the nodes left. (5)
    ``scale``: each named RC set to its count. After each step the RCs
    must stand settled: every RC's active pods at its count and bound,
    none on a departed node, ``status.replicas`` at ``spec.replicas``,
    steady for 2 s through a watch of pods and then read back over HTTP;
    each step has 400 s, and logs each process's CPU seconds per second.
    Fails unless each wave launched commit_solve once and never the plain
    version (``count_launches``), each wave == the plain version and ==
    ``solve(encode_snapshot(...))`` of the encoder's own state, every
    failed bind is of a pod deleted since, no node is over capacity and
    no host port doubled, the scale-down took only pre-existing pods of
    its RC, the manager exits 0 on SIGTERM, and the RCs created exactly
    the pods their counts and the shrink needed (the reference's watch
    and periodic syncs of one RC race, and create beyond the targets; the
    port runs one sync of an RC at a time). ``keep_rows`` returns the
    waves with their states (for the CPU tests' check against the JAX
    package)."""
    import gc
    import shutil
    import signal
    import tempfile
    import threading

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver

    tag = "phase 15"
    t_phase = time.perf_counter()

    def elapsed() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s in,"
    _nodes, existing, _pending, services = build_cluster(n_nodes, 0)
    names = [f"node-{i:05d}" for i in range(n_nodes)]
    gone_nodes = set(names[::max(1, n_nodes // n_gone)][:n_gone])
    rcs = {}
    for a in range(apps):
        for v in range(versions):
            k = 5 * a + v
            rcs[f"rc-{a}-{v}"] = _rc_object(
                f"rc-{a}-{v}", f"app-{a}", replicas, k,
                7000 + a if host_ports and v == 0 else 0)
    targets = {n: replicas for n in rcs}
    work = tempfile.mkdtemp(prefix="phase15-")
    inventory = os.path.join(work, "inventory.json")
    t_inv = time.time()
    _write_inventory(inventory, names, mtime=t_inv)
    env = dict(os.environ, KTPU_CLOUD_INVENTORY=inventory)

    wl = _WaveLog(keep_state=True)
    procs: list = []
    watches: list = []
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = None
    steps: dict = {}
    try:
        api_proc, url = _start_apiserver(
            "phase15", env=env, args=["--cloud-provider", "inventory"])
        procs.append(api_proc)
        client = Client(HTTPTransport(url))
        nodes_w = _LifeWatch(url, "nodes")
        pods_w = _LifeWatch(url, "pods",
                            want=lambda p: "rc" in p.metadata.labels,
                            count_by="rc")
        watches += [nodes_w, pods_w]

        # ---- (1) the NodeController registers the inventory -------------
        t0 = time.perf_counter()
        mgr, mgr_ready_s = _spawn(
            "phase15_manager", "kubernetes_tpu_torch.cmd.controller_manager",
            ["--master", url, "--cloud-provider", "inventory",
             "--node-sync-period", "1"], "kube-controller-manager running",
            env=env)
        procs.append(mgr)

        wait = _waiter(tag, procs, result, elapsed, 400.0)

        wait(lambda: len(nodes_w.seen) >= n_nodes,
             f"the registration of {n_nodes} nodes",
             progress=lambda: f"{len(nodes_w.seen)} registered")
        t_reg = max(nodes_w.seen.values())
        if set(nodes_w.seen) != set(names):
            raise AssertionError(f"{tag}: registered nodes are not the "
                                 f"inventory's")
        wait(lambda: len(nodes_w.conds) >= n_nodes,
             "the conditions of every node",
             progress=lambda: f"{len(nodes_w.conds)} written")
        t_cond = max(nodes_w.conds.values())
        _log(f"     {tag}: {elapsed()} {n_nodes} nodes registered, their "
             f"conditions written")
        first_reg = min(nodes_w.seen.values())
        steps["register"] = {
            "manager_ready_s": mgr_ready_s, "registered_s": t_reg - t0,
            "nodes_per_s": n_nodes / (t_reg - t0),
            "nodes_per_s_first_to_last": (n_nodes - 1) / max(
                t_reg - first_reg, 1e-9),
            "conditions_s": t_cond - t0, "conditions_after_last_s":
                t_cond - t_reg}

        # ---- (2) seed services and residents; the binary -----------------
        seed_s = _seed_cluster(client, [], existing, services, seeders, tag)
        _log(f"     {tag}: {elapsed()} residents and services seeded")
        thread, murl = _start_binary("phase15", url, dev, wl, result, stop,
                                     ready, wave_size=wave_size,
                                     wave_period=wave_period)
        wait(lambda: "rc" in result or "compile_prewarm_ready 1" in
             _wait_http(murl + "/metrics", None,
                        f"{tag}: the scheduler binary").splitlines(),
             "the binary's prewarm", 600.0)
        if "rc" in result:
            raise AssertionError(f"{tag}: the binary returned "
                                 f"{result['rc']}")
        f = wl.sched.factory
        wait(lambda: (len(f.node_store) == n_nodes
                      and len(f.scheduled_pods) == len(existing)
                      and len(f.service_store) == len(services)),
             "the scheduler's caches to hold the cluster")
        _log(f"     {tag}: {elapsed()} the binary warm, its caches full")

        live_nodes = set(names)
        mark = {"events": -1, "since": 0.0}

        def cpu_mark():
            return (time.perf_counter(), _cpu_seconds(api_proc.pid),
                    _cpu_seconds(mgr.pid), time.process_time())

        def cpu_share(m0) -> dict:
            """Each process's CPU seconds per second since ``m0``: where
            a step's host time went (the script's process runs the
            scheduler binary and the watches)."""
            m1 = cpu_mark()
            return {k: round((b - a) / (m1[0] - m0[0]), 3) for k, a, b in
                    zip(("apiserver", "manager", "script"), m0[1:], m1[1:])}

        def watch_settled() -> bool:
            alive = pods_w.alive()
            count = {n: 0 for n in targets}
            for p in alive:
                hosts = pods_w.hosts.get(p)
                if not hosts or not hosts <= live_nodes:
                    return False
                count[pods_w.labels[p]["rc"]] += 1
            if count != targets:
                return False
            got = {rc.metadata.name: (rc.spec.replicas, rc.status.replicas)
                   for rc in client.replication_controllers().list().items}
            return got == {n: (t, t) for n, t in targets.items()}

        def settle(what: str) -> float:
            """Wait until the RCs stand settled through the watch for 2 s
            with no pod event, then read it back over HTTP -> the time it
            first stood settled."""
            first: list = []

            def steady() -> bool:
                if not watch_settled():
                    first.clear()
                    mark["events"] = -1
                    return False
                if not first:
                    first.append(time.perf_counter())
                if pods_w.events != mark["events"]:
                    mark["events"], mark["since"] = (pods_w.events,
                                                     time.perf_counter())
                    return False
                if time.perf_counter() - mark["since"] < 2.0:
                    return False
                final = [p for p in client.pods("").list().items
                         if "rc" in p.metadata.labels]
                if ({p.metadata.name for p in final} != pods_w.alive()
                        or any(p.spec.host not in live_nodes
                               for p in final)):
                    mark["events"] = -1
                    return False
                return True

            def counts() -> str:
                alive = pods_w.alive()
                return (f"{len(alive)} RC pods alive, "
                        f"{sum(1 for p in alive if p in pods_w.first)} "
                        f"bound, {len(pods_w.seen)} created, "
                        f"{len(wl.rows)} waves")

            wait(steady, f"the RCs settled after {what}", poll_s=0.2,
                 progress=counts)
            _log(f"     {tag}: {elapsed()} the RCs settled after {what}: "
                 f"{counts()}")
            return first[0]

        # ---- (3) the load: the RCs, their pods bound on the card ---------
        gc.callbacks.append(wl.on_gc)
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        m0 = cpu_mark()
        t_first = time.perf_counter()
        for rc in rcs.values():
            client.replication_controllers().create(rc)
        t_settled = settle("the load")
        t_last = max(pods_w.first.values())
        steps["load"] = {"cpu_share": cpu_share(m0),
                         "rcs": len(rcs), "replicas": replicas,
                         "pods": sum(targets.values()),
                         "created": len(pods_w.seen),
                         "loop_s": t_last - t_first,
                         "pods_per_s": sum(targets.values())
                         / (t_last - t_first),
                         "settled_s": t_settled - t_first,
                         "waves": len(wl.rows)}

        # ---- (4) the inventory shrinks ------------------------------------
        before = pods_w.alive()
        lost = {p for p in before if pods_w.hosts.get(p, set()) & gone_nodes}
        created0, waves0 = len(pods_w.seen), len(wl.rows)
        m0 = cpu_mark()
        t_rw = time.perf_counter()
        _write_inventory(inventory, [n for n in names if n not in gone_nodes],
                         mtime=t_inv + 10)
        live_nodes = set(names) - gone_nodes
        wait(lambda: gone_nodes <= set(nodes_w.deleted),
             f"the deletion of {len(gone_nodes)} departed nodes",
             progress=lambda: f"{len(gone_nodes & set(nodes_w.deleted))} "
                              f"deleted")
        t_nodes_gone = max(nodes_w.deleted[n] for n in gone_nodes)
        t_settled = settle("the shrink")
        steps["shrink"] = {"cpu_share": cpu_share(m0),
            "nodes_gone": len(gone_nodes), "rc_pods_lost": len(lost),
            "nodes_deleted_s": t_nodes_gone - t_rw,
            "recovered_s": t_settled - t_rw,
            "created": len(pods_w.seen) - created0,
            "waves": len(wl.rows) - waves0}

        # ---- (5) scale one RC down and one up ----------------------------
        before = pods_w.alive()
        created0, waves0 = len(pods_w.seen), len(wl.rows)
        m0 = cpu_mark()
        t_sc = time.perf_counter()
        for name, n in scale:
            rc = client.replication_controllers().get(name)
            rc.spec.replicas = targets[name] = n
            client.replication_controllers().update(rc)
        t_settled = settle("the scale")
        taken = {pods_w.labels[p]["rc"] for p in before - pods_w.alive()}
        down = {name for name, n in scale if n < replicas}
        if taken - down:
            raise AssertionError(f"{tag}: the scale-down took pods of "
                                 f"{sorted(taken - down)}")
        steps["scale"] = {"cpu_share": cpu_share(m0),
                          "scale": dict(scale), "settled_s": t_settled - t_sc,
                          "taken_from": sorted(taken),
                          "created": len(pods_w.seen) - created0,
                          "waves": len(wl.rows) - waves0}
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls

        code, body = _http_get(murl + "/healthz")
        health = json.loads(body)
        if code != 200 or health.get("healthy") is not True:
            raise AssertionError(f"{tag}: /healthz {code} {body}")
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items
        final_rcs = client.replication_controllers().list().items
        svcs = f.service_store.list()
        mgr.send_signal(signal.SIGTERM)
        mgr_rc = mgr.wait(timeout=30)
    except BaseException:
        _abort_children(procs, "phase15")
        raise
    finally:
        if wl.on_gc in gc.callbacks:
            gc.callbacks.remove(wl.on_gc)
        for w in watches:
            w.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        for p in procs:
            _stop_process(p)
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    if mgr_rc != 0:
        raise AssertionError(f"{tag}: the manager exited {mgr_rc} on "
                             f"SIGTERM")

    # ---- the checks, after the run -----------------------------------------
    t_check = time.perf_counter()
    if {n.metadata.name for n in final_nodes} != live_nodes:
        raise AssertionError(f"{tag}: the registered nodes are not the "
                             f"inventory's")
    stranded = [p.metadata.name for p in final
                if p.spec.host and p.spec.host not in live_nodes]
    if stranded:
        raise AssertionError(f"{tag}: {len(stranded)} pods on departed "
                             f"nodes, e.g. {stranded[0]}")
    active: dict = {}
    for p in final:
        rc = p.metadata.labels.get("rc")
        if rc is not None and p.status.phase not in ("Succeeded", "Failed"):
            if not p.spec.host:
                raise AssertionError(f"{tag}: {p.metadata.name} unbound")
            active[rc] = active.get(rc, 0) + 1
    for rc in final_rcs:
        n = rc.metadata.name
        if not (rc.spec.replicas == rc.status.replicas == targets[n]
                == active.get(n, 0)):
            raise AssertionError(f"{tag}: {n} spec {rc.spec.replicas} "
                                 f"status {rc.status.replicas} active "
                                 f"{active.get(n, 0)}, want {targets[n]}")
    _check_placements(final, final_nodes, tag)
    rows = [r for r in wl.rows if r["order"]]
    gone = set(pods_w.seen) - {p.metadata.name for p in final}
    failed = [n for r in rows for n, _h in r["placed"]
              if n not in set(r["bound_names"]) and n not in gone]
    if failed:
        raise AssertionError(f"{tag}: {len(failed)} binds failed for pods "
                             f"that still exist, e.g. {failed[0]}")
    checks = _check_waves(rows, final, set(pods_w.seen), svcs, dev, tag,
                          count_launches, launches, plain_calls, gone=gone)
    needed = (sum(replicas for _ in rcs) + steps["shrink"]["rc_pods_lost"]
              + sum(max(0, n - replicas) for _n, n in scale))
    # a replica beyond its target: more of an RC's pods alive at once than
    # the most it ever asked for (deletions come before the replacements
    # in the watch, and no kubelet fails a pod here)
    cap = {n: max(replicas, dict(scale).get(n, 0)) for n in targets}
    beyond = {n: pods_w.peak_by.get(n, 0) - cap[n] for n in targets
              if pods_w.peak_by.get(n, 0) > cap[n]}
    if beyond:
        seen = {n: [(round(pods_w.seen[p] - t_first, 3),
                     round(pods_w.deleted[p] - t_first, 3)
                     if p in pods_w.deleted else None, p)
                    for p in pods_w.seen
                    if pods_w.labels[p].get("rc") == n] for n in beyond}
        raise AssertionError(
            f"{tag}: replicas beyond their targets {beyond}; at their "
            f"peaks (s, pod, relists, resumes): "
            f"{ {n: (round(pods_w.peak_at[n][0] - t_first, 3), *pods_w.peak_at[n][1:]) for n in beyond} }; "
            f"their pods deleted (seen s, deleted s, name): "
            f"{ {n: [x for x in v if x[1] is not None] for n, v in seen.items()} }; "
            f"last seen: { {n: sorted(v)[-3:] for n, v in seen.items()} }")
    out = {
        "nodes": n_nodes, "existing": len(existing), "services": len(services),
        "rcs": len(rcs), "replicas": replicas, "steps": steps,
        "seed_s": seed_s, "prewarm_s": wl.sched.prewarm_s,
        "created": len(pods_w.seen), "needed": needed,
        "over_created": sum(beyond.values()),
        "deleted": len(gone), "watch_resumes": pods_w.resumes,
        "watch_relists": pods_w.relists,
        "encodes": {k: sum(r.get("encode_path") == k for r in rows)
                    for k in ("full", "delta", "replay")},
        "binds_failed": sum(len(r["errors"]) for r in rows),
        "waves": _wave_rows(rows, t_first), "launches": launches,
        "plain_calls": plain_calls, "gc_s": wl.gc["s"],
        "gc_full": wl.gc["full"], "health": health, **checks,
        "checks_s": time.perf_counter() - t_check,
        "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"], out["svcs"] = rows, svcs
    return out


def _log_controller(c: dict) -> None:
    st = c["steps"]
    reg, load, sh, sc = st["register"], st["load"], st["shrink"], st["scale"]
    _log(f"[15] the controller manager feeding the card: the "
         f"NodeController registered {c['nodes']} inventory nodes in "
         f"{reg['registered_s']:.3f} s from its spawn "
         f"({reg['nodes_per_s']:.1f} nodes/s; "
         f"{reg['nodes_per_s_first_to_last']:.1f} from the first to the "
         f"last), their conditions written {reg['conditions_after_last_s']:.3f}"
         f" s after the last; {c['existing']} residents and "
         f"{c['services']} services seeded in "
         f"{' + '.join(f'{s:.2f}' for s in c['seed_s'])} s")
    _log(f"     load: {load['rcs']} RCs of {load['replicas']}, "
         f"{load['pods']} pods bound {load['loop_s']:.3f} s after the first "
         f"RC create ({load['pods_per_s']:.1f} pods/s), settled at "
         f"{load['settled_s']:.3f} s, {load['waves']} waves; "
         f"{load['created']} pods created; CPU per second "
         f"{load['cpu_share']}")
    _log(f"     shrink: {sh['nodes_gone']} instances left the inventory; "
         f"their nodes deleted {sh['nodes_deleted_s']:.3f} s after the "
         f"rewrite, {sh['rc_pods_lost']} RC pods lost, every RC back at its "
         f"count and bound {sh['recovered_s']:.3f} s after the rewrite "
         f"({sh['created']} created, {sh['waves']} waves); CPU per second "
         f"{sh['cpu_share']}")
    _log(f"     scale {sc['scale']}: settled in {sc['settled_s']:.3f} s, "
         f"pods taken only from {sc['taken_from']} ({sc['created']} "
         f"created, {sc['waves']} waves); CPU per second {sc['cpu_share']}")
    _log(f"     {c['created']} RC pods created for {c['needed']} needed: "
         f"{c['over_created']} beyond the targets; {c['deleted']} deleted; "
         f"{c['binds_failed']} binds failed (pods deleted meanwhile); "
         f"encodes {c['encodes']}; {len(c['waves'])} waves, "
         f"{c['launches']} commit_solve launches, {c['plain_calls']} "
         f"plain-version calls; every wave == the plain version (max abs "
         f"err {c['max_abs_err']}) and == solve(encode_snapshot) of the "
         f"encoder's state; checks {c['checks_s']:.1f} s, phase "
         f"{c['phase_s']:.1f} s")


def _kubectl_runner(env: dict, tag: str, times: list):
    """-> kubectl(*args, timeout_s=120) running ``python -m
    kubernetes_tpu_torch.cmd.kubectl args`` as a process of its own in
    ``env``: its standard output, its seconds appended to ``times``;
    fails on a non-zero exit, with the command's standard error."""
    import subprocess

    def kubectl(*args, timeout_s: float = 120.0) -> str:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.kubectl",
             *map(str, args)], cwd=_ROOT, env=env, capture_output=True,
            text=True, timeout=timeout_s)
        times.append(time.perf_counter() - t0)
        if proc.returncode != 0:
            raise AssertionError(f"{tag}: kubectl {' '.join(map(str, args))}"
                                 f" exited {proc.returncode}: "
                                 f"{proc.stderr.strip()[-2000:]}")
        return proc.stdout
    return kubectl


def _json_stream(text: str) -> list:
    """The JSON documents of kubectl's ``-o json`` output, one a
    resource, printed one after another."""
    dec, out, i = json.JSONDecoder(), [], 0
    while True:
        while i < len(text) and text[i].isspace():
            i += 1
        if i == len(text):
            return out
        doc, i = dec.raw_decode(text, i)
        out.append(doc)


def _legacy_file(path: str, kind: str, version: str, objs) -> None:
    """``objs`` as one ``kind`` document of wire version ``version``,
    each item encoded in that version with its own kind and apiVersion
    (what kubectl's Builder reads out of a list)."""
    from kubernetes_tpu_torch.api.latest import scheme

    with open(path, "w") as fh:
        json.dump({"kind": kind, "apiVersion": version,
                   "items": [scheme.encode_to_wire(o, version)
                             for o in objs]}, fh)


def _kubectl_phase(dev, n_nodes=5_000, n_legacy=3_000, web=(1_000, 2_000),
                   n_cordon=50, small=10, seeders=8, wave_size=None,
                   wave_period=1.0, count_launches=True,
                   keep_rows=False) -> dict:
    """Phase 16: an operator's kubectl session feeding the card. The
    port's kube-apiserver and kube-controller-manager (no cloud) as
    processes, the scheduler binary (``--algorithm tpu-batch --prewarm
    --wave-period`` ``wave_period``) in a thread with its waves recorded
    with the encoder's state (``_WaveLog(keep_state=True)``), and kubectl
    as processes (``python -m kubernetes_tpu_torch.cmd.kubectl``,
    ``KUBECONFIG`` and ``HOME`` in this phase's temporary directory).
    (1) ``config set-cluster``/``set-context``/``use-context``;
    ``api-versions`` prints v1, v1beta1 and v1beta2; ``cluster-info``,
    ``version``; ``proxy --port 0 --once`` relays one GET of the nodes.
    (2) north_star's ``n_nodes`` nodes as one v1beta1 MinionList file and
    its 8 services as a v1beta2 List, each through ``kubectl create
    -f``; the 10,000 residents seeded as phase 9 seeds them. (3) Under a
    v1beta1 watch of pods, the first ``n_legacy`` of north_star's pending
    pods as a v1beta1 PodList through ``kubectl create -f``; every one
    bound, ``--api-version v1beta1 get pods -o json`` gives each one's
    ``desiredState.host`` equal to its binding read over v1, the v1beta1
    watch saw each bind, and a v1beta1 list under the legacy field
    selector ``DesiredState.Host=`` holds none of them. (4) ``cordon``
    of the ``n_cordon`` nodes with the most free CPU, ``run-container
    web`` of ``web[0]`` replicas, ``resize rc web`` to ``web[1]``: every
    web pod bound, none on a cordoned node; ``uncordon`` of one prints
    ``uncordoned``, a second ``cordon`` of another ``already cordoned``.
    (5) ``run-container small`` of ``small``, ``rolling-update small -f``
    a v1beta1 ``small-v2``: its pods bound, ``small`` gone. (6) One pod
    that fits no node (64 CPUs); ``describe pod`` prints its
    FailedScheduling event with explain's breakdown over the nodes the
    binary schedules onto. (7) ``resize rc web`` to 0 (the reaper of
    ``stop`` waits 30 s, and the ReplicationManager deletes 64 pods a
    sync), ``stop rc web``, ``stop rc small-v2``, ``delete -f`` of step
    3's file and of the unfit pod's: ``get pods -o json`` holds none of
    them, and every resident. Every kubectl exits 0. Fails unless each wave launched
    commit_solve once and never the plain version (``count_launches``),
    each wave == the plain version and == ``solve(encode_snapshot(...))``
    of the encoder's state, every acknowledged bind reads back, no node
    is over capacity and no host port doubled, and the manager exits 0
    on SIGTERM. ``keep_rows`` returns the waves with their states (for
    the CPU tests' check against the JAX package)."""
    import gc
    import shutil
    import signal
    import subprocess
    import tempfile
    import threading

    from kubernetes_tpu_torch.api import errors
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.scheduler.predicates import (
        capacity_values, get_resource_request)

    tag = "phase 16"
    t_phase = time.perf_counter()

    def elapsed() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s in,"
    nodes, existing, pending, services = build_cluster(n_nodes, n_legacy)
    legacy = {p.metadata.name for p in pending}
    work = tempfile.mkdtemp(prefix="phase16-")
    files = {k: os.path.join(work, f"{k}.json") for k in
             ("nodes", "services", "pods", "small-v2", "unfit")}
    _legacy_file(files["nodes"], "MinionList", "v1beta1", nodes)
    _legacy_file(files["services"], "List", "v1beta2", services)
    _legacy_file(files["pods"], "PodList", "v1beta1", pending)
    from kubernetes_tpu_torch.api.latest import scheme
    v2 = api.ReplicationController(
        metadata=api.ObjectMeta(name="small-v2", namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=small, selector={"run": "small-v2"},
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels={"run": "small-v2"}),
                spec=api.PodSpec(containers=[api.Container(
                    name="small", image="nginx:v2")]))))
    unfit = api.Pod(
        metadata=api.ObjectMeta(name="unfit", namespace="default"),
        spec=api.PodSpec(containers=[api.Container(
            name="c", image="img", resources=api.ResourceRequirements(
                limits={"cpu": Quantity("64"),
                        "memory": Quantity("1Gi")}))]))
    for key, obj in (("small-v2", v2), ("unfit", unfit)):
        with open(files[key], "w") as fh:
            json.dump(scheme.encode_to_wire(obj, "v1beta1"), fh)
    env_k = {k: v for k, v in os.environ.items()
             if k != "KUBERNETES_AUTH_PATH"}
    env_k.update(KUBECONFIG=os.path.join(work, "kubeconfig"), HOME=work)
    kubectl_s: list = []
    kubectl = _kubectl_runner(env_k, tag, kubectl_s)

    wl = _WaveLog(keep_state=True)
    procs: list = []
    watches: list = []
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = None
    steps: dict = {}
    try:
        api_proc, url = _start_apiserver("phase16")
        procs.append(api_proc)
        mgr, mgr_ready_s = _spawn(
            "phase16_manager", "kubernetes_tpu_torch.cmd.controller_manager",
            ["--master", url], "kube-controller-manager running")
        procs.append(mgr)
        client = Client(HTTPTransport(url))

        wait = _waiter(tag, procs, result, elapsed, 300.0)

        # ---- (1) configure ------------------------------------------------
        kubectl("config", "set-cluster", "local", f"--server={url}")
        kubectl("config", "set-context", "c", "--cluster=local")
        kubectl("config", "use-context", "c")
        got = kubectl("api-versions")
        if got != "Available Server Api Versions: v1, v1beta1, v1beta2\n":
            raise AssertionError(f"{tag}: api-versions printed {got!r}")
        info = kubectl("cluster-info")
        if not info.startswith("Kubernetes master is running"):
            raise AssertionError(f"{tag}: cluster-info printed {info!r}")
        version = kubectl("version").strip()
        proxy = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.kubectl",
             "proxy", "--port", "0", "--once"], cwd=_ROOT, env=env_k,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            line = proxy.stdout.readline()
            m = re.match(r"Starting to serve on 127\.0\.0\.1:(\d+)", line)
            if m is None:
                raise AssertionError(f"{tag}: kubectl proxy printed "
                                     f"{line!r}")
            code, body = _http_get(f"http://127.0.0.1:{m.group(1)}"
                                   f"/api/v1/nodes")
            proxy_rc = proxy.wait(timeout=30)
        finally:
            _stop_process(proxy)
        if code != 200 or json.loads(body)["kind"] != "NodeList" \
                or proxy_rc != 0:
            raise AssertionError(f"{tag}: the proxy relayed {code}, "
                                 f"exited {proxy_rc}")
        _log(f"     {tag}: {elapsed()} kubectl configured; api-versions, "
             f"cluster-info, version ({version}) and the proxy answer")

        # ---- (2) nodes and services in the legacy wire; residents --------
        nodes_w = _LifeWatch(url, "nodes")
        watches.append(nodes_w)
        t0 = time.perf_counter()
        kubectl("create", "-f", files["nodes"], timeout_s=600)
        nodes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        kubectl("create", "-f", files["services"])
        services_s = time.perf_counter() - t0
        if len(client.nodes().list().items) != n_nodes:
            raise AssertionError(f"{tag}: the MinionList did not create "
                                 f"{n_nodes} nodes")
        seed_s = _seed_cluster(client, [], existing, [], seeders, tag)
        steps["create"] = {
            "nodes_v1beta1_s": nodes_s, "nodes_per_s": n_nodes / nodes_s,
            "services_v1beta2_s": services_s,
            "services_per_s": len(services) / services_s,
            "seed_s": seed_s}
        _log(f"     {tag}: {elapsed()} {n_nodes} v1beta1 minions and "
             f"{len(services)} v1beta2 services created, residents seeded")
        thread, murl = _start_binary("phase16", url, dev, wl, result, stop,
                                     ready, wave_size=wave_size,
                                     wave_period=wave_period)
        wait(lambda: "compile_prewarm_ready 1" in _wait_http(
            murl + "/metrics", None, f"{tag}: the scheduler binary"
        ).splitlines(), "the binary's prewarm", 600.0, poll_s=0.2)
        f = wl.sched.factory
        wait(lambda: (len(f.node_store) == n_nodes
                      and len(f.scheduled_pods) == len(existing)
                      and len(f.service_store) == len(services)),
             "the scheduler's caches to hold the cluster")
        _log(f"     {tag}: {elapsed()} the binary warm, its caches full")

        # ---- (3) a legacy load ------------------------------------------
        beta_w = _BindWatch(url, legacy, version="v1beta1")
        pods_w = _LifeWatch(url, "pods")
        watches += [beta_w, pods_w]
        gc.callbacks.append(wl.on_gc)
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t_first = time.perf_counter()
        kubectl("create", "-f", files["pods"], timeout_s=600)
        create_s = time.perf_counter() - t_first
        wait(lambda: all(n in pods_w.first for n in legacy),
             f"the binds of {n_legacy} v1beta1 pods",
             progress=lambda: f"{sum(n in pods_w.first for n in legacy)} "
                              f"bound")
        t_last = max(pods_w.first[n] for n in legacy)
        wait(lambda: len(beta_w.first) == n_legacy,
             "the v1beta1 watch to see every bind", 60.0)
        v1_hosts = {p.metadata.name: p.spec.host
                    for p in client.pods("").list().items}
        docs = _json_stream(kubectl("--api-version", "v1beta1", "get",
                                    "pods", "-o", "json"))
        beta_hosts = {d["id"]: d["desiredState"].get("host", "")
                      for d in docs if d["apiVersion"] == "v1beta1"}
        wrong = [n for n in legacy if not v1_hosts.get(n)
                 or beta_hosts.get(n) != v1_hosts[n]
                 or beta_w.hosts.get(n) != {v1_hosts[n]}]
        if wrong or len(docs) != len(v1_hosts):
            raise AssertionError(f"{tag}: {len(wrong)} legacy pods' "
                                 f"desiredState.host or v1beta1 watch "
                                 f"differ from their v1 binding, e.g. "
                                 f"{wrong[:1]}")
        beta_w.stop()
        beta = Client(HTTPTransport(url, version="v1beta1"))
        unbound = {p.metadata.name for p in beta.pods("").list(
            field_selector="DesiredState.Host=").items}
        if unbound & legacy:
            raise AssertionError(f"{tag}: DesiredState.Host= lists "
                                 f"{len(unbound & legacy)} bound pods")
        steps["legacy"] = {
            "pods": n_legacy, "create_s": create_s,
            "pods_v1beta1_per_s": n_legacy / create_s,
            "loop_s": t_last - t_first,
            "pods_per_s": n_legacy / (t_last - t_first),
            "waves": sum(1 for r in wl.rows if r["order"])}
        _log(f"     {tag}: {elapsed()} {n_legacy} v1beta1 pods bound, "
             f"read back in v1beta1 and v1")

        # ---- (4) cordon, run, resize --------------------------------------
        wait(lambda: len(nodes_w.conds) >= n_nodes,
             "the node controller's conditions on every node",
             progress=lambda: f"{len(nodes_w.conds)} written")
        all_pods = client.pods("").list().items
        free = {n.metadata.name: capacity_values(n.spec.capacity)["cpu"]
                for n in nodes}
        for p in all_pods:
            if p.spec.host:
                free[p.spec.host] -= get_resource_request(p).get("cpu", 0)
        cordoned = sorted(free, key=lambda n: (-free[n], n))[:n_cordon]
        cordon_out: list = []
        t0 = time.perf_counter()
        _parallel(8, cordoned,
                  lambda n: cordon_out.append(kubectl("cordon", n)))
        cordon_s = time.perf_counter() - t0
        if sorted(cordon_out) != sorted(f"node/{n} cordoned\n"
                                        for n in cordoned):
            raise AssertionError(f"{tag}: cordon printed "
                                 f"{sorted(cordon_out)[:2]}")
        # the binary polls its nodes (10 s) and drops the cordoned ones
        wait(lambda: not {n.metadata.name for n in f.node_store.list()}
             & set(cordoned), "the scheduler's nodes to drop the cordoned")

        def rc_settled(rc_name: str, n: int) -> bool:
            alive = [p for p in pods_w.alive()
                     if pods_w.labels[p].get("run") == rc_name]
            if len(alive) != n or any(p not in pods_w.first for p in alive):
                return False
            try:
                rc = client.replication_controllers().get(rc_name)
            except errors.StatusError:
                return False
            return rc.spec.replicas == rc.status.replicas == n

        def settle(rc_name: str, n: int) -> float:
            """Wait until RC ``rc_name`` stands at ``n`` bound pods, its
            status at its spec, steady for 1 s without a pod event ->
            the time its last pod was first seen bound."""
            mark = {"events": -1, "since": 0.0}

            def steady() -> bool:
                if not rc_settled(rc_name, n):
                    mark["events"] = -1
                    return False
                if pods_w.events != mark["events"]:
                    mark["events"], mark["since"] = (pods_w.events,
                                                     time.perf_counter())
                    return False
                return time.perf_counter() - mark["since"] >= 1.0

            wait(steady, f"{rc_name} at {n} bound pods", poll_s=0.1,
                 progress=lambda: f"{len(pods_w.first)} bound, "
                                  f"{len(wl.rows)} waves")
            return max((pods_w.first[p] for p in pods_w.alive()
                        if pods_w.labels[p].get("run") == rc_name),
                       default=time.perf_counter())

        t0 = time.perf_counter()
        kubectl("run-container", "web", "--image=nginx",
                f"--replicas={web[0]}")
        t_run = settle("web", web[0])
        t1 = time.perf_counter()
        out = kubectl("resize", "rc", "web", f"--replicas={web[1]}")
        if out != "resized\n":
            raise AssertionError(f"{tag}: resize printed {out!r}")
        t_resize = settle("web", web[1])
        web_pods = [p for p in pods_w.seen
                    if pods_w.labels[p].get("run") == "web"]
        on_cordoned = [p for p in web_pods
                       if pods_w.hosts.get(p, set()) & set(cordoned)]
        if on_cordoned:
            raise AssertionError(f"{tag}: {len(on_cordoned)} web pods on "
                                 f"cordoned nodes, e.g. {on_cordoned[0]}")
        out = kubectl("uncordon", cordoned[0])
        again = kubectl("cordon", cordoned[1])
        if (out, again) != (f"node/{cordoned[0]} uncordoned\n",
                            f"node/{cordoned[1]} already cordoned\n"):
            raise AssertionError(f"{tag}: uncordon printed {out!r}, "
                                 f"cordon again {again!r}")
        steps["web"] = {
            "cordoned": n_cordon, "cordon_s": cordon_s,
            "run_s": t_run - t0, "run_pods_per_s": web[0] / (t_run - t0),
            "resize_s": t_resize - t1,
            "resize_pods_per_s": (web[1] - web[0]) / (t_resize - t1),
            "created": len(web_pods)}
        _log(f"     {tag}: {elapsed()} {web[1]} web pods bound, none on "
             f"the {n_cordon} cordoned nodes")

        # ---- (5) rolling update --------------------------------------------
        kubectl("run-container", "small", "--image=nginx",
                f"--replicas={small}")
        settle("small", small)
        t0 = time.perf_counter()
        out = kubectl("rolling-update", "small", "-f", files["small-v2"],
                      "--update-period", "0")
        if out != "small-v2\n":
            raise AssertionError(f"{tag}: rolling-update printed {out!r}")
        roll_s = time.perf_counter() - t0
        settle("small-v2", small)
        try:
            client.replication_controllers().get("small")
            raise AssertionError(f"{tag}: rc small outlived its update")
        except errors.StatusError as e:
            if e.code != 404:
                raise
        steps["rolling_update"] = {"replicas": small, "update_s": roll_s}
        _log(f"     {tag}: {elapsed()} small rolled to small-v2")

        # ---- (6) diagnosis -------------------------------------------------
        kubectl("create", "-f", files["unfit"])
        wait(lambda: any(ev.reason == "FailedScheduling"
                         and "nodes available" in ev.message
                         for ev in client.events("default").list(
                             field_selector="involvedObject.name=unfit"
                         ).items), "unfit's FailedScheduling event",
             120.0, poll_s=0.2)
        text = kubectl("describe", "pod", "unfit")
        lines = [ln for ln in text.splitlines() if "FailedScheduling" in ln
                 and "nodes available" in ln]
        if not lines:
            raise AssertionError(f"{tag}: describe pod unfit printed no "
                                 f"breakdown:\n{text}")
        describe_line = lines[-1].strip()
        msg = re.search(r"0/\d+ nodes available: .*$", describe_line).group(0)
        breakdown = _parse_breakdown(msg)
        # over the nodes the binary schedules onto: all but the cordoned,
        # with the uncordoned one once its node poll has seen it
        if breakdown["N"] not in (n_nodes - n_cordon, n_nodes - n_cordon + 1) \
                or breakdown.get("Insufficient cpu") != breakdown["N"]:
            raise AssertionError(f"{tag}: the breakdown {msg!r} is not "
                                 f"every schedulable node short of cpu")
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items
        svcs = f.service_store.list()

        # ---- (7) tear down -------------------------------------------------
        # the reaper of ``stop`` waits 30 s for the RC's pods to go; the
        # ReplicationManager deletes 64 a sync, too few a second for
        # 2,000 on a loaded host, so the session resizes web to 0 first
        t0 = time.perf_counter()
        kubectl("resize", "rc", "web", "--replicas=0")
        settle("web", 0)
        web_down_s = time.perf_counter() - t0
        stopped = (kubectl("stop", "rc", "web"),
                   kubectl("stop", "rc", "small-v2"))
        if stopped != ("web stopped\n", "small-v2 stopped\n"):
            raise AssertionError(f"{tag}: stop printed {stopped}")
        kubectl("delete", "-f", files["pods"], timeout_s=600)
        kubectl("delete", "-f", files["unfit"])
        teardown_s = time.perf_counter() - t0
        left = {d["metadata"]["name"] for d in _json_stream(
            kubectl("get", "pods", "-o", "json"))}
        residents = {p.metadata.name for p in existing}
        mine = set(pods_w.seen) - residents
        if left & mine:
            raise AssertionError(f"{tag}: {len(left & mine)} of the "
                                 f"session's pods outlived the tear-down")
        if left != residents:
            raise AssertionError(f"{tag}: {len(residents - left)} of the "
                                 f"{len(residents)} residents are gone")
        steps["teardown"] = {"s": teardown_s, "web_to_0_s": web_down_s,
                             "web_deleted_per_s": web[1] / web_down_s,
                             "pods_left": len(left)}
        mgr.send_signal(signal.SIGTERM)
        mgr_rc = mgr.wait(timeout=30)
    except BaseException:
        _abort_children(procs, "phase16")
        raise
    finally:
        if wl.on_gc in gc.callbacks:
            gc.callbacks.remove(wl.on_gc)
        for w in watches:
            w.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        for p in procs:
            _stop_process(p)
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    if mgr_rc != 0:
        raise AssertionError(f"{tag}: the manager exited {mgr_rc} on "
                             f"SIGTERM")
    launches = commit_solver.solve_commit.launches
    plain_calls = commit_solver.solve_commit_reference.calls

    # ---- the checks, after the run -----------------------------------------
    t_check = time.perf_counter()
    _check_placements(final, final_nodes, tag)
    rows = [r for r in wl.rows if r["order"]]
    live = {p.metadata.name for p in final}
    gone = set(pods_w.seen) - live
    names = mine & live
    checks = _check_waves(rows, final, names, svcs, dev, tag,
                          count_launches, launches, plain_calls, gone=gone)
    out = {
        "nodes": n_nodes, "existing": len(existing),
        "services": len(services), "legacy_pods": n_legacy, "web": web,
        "small": small, "steps": steps, "manager_ready_s": mgr_ready_s,
        "prewarm_s": wl.sched.prewarm_s,
        "kubectl_runs": len(kubectl_s),
        "kubectl_median_s": statistics.median(kubectl_s),
        "describe": describe_line, "breakdown": breakdown,
        "created": len(mine), "deleted_before_check": len(gone),
        "encodes": {k: sum(r.get("encode_path") == k for r in rows)
                    for k in ("full", "delta", "replay")},
        "binds_failed": sum(len(r["errors"]) for r in rows),
        "waves": _wave_rows(rows, t_first), "launches": launches,
        "plain_calls": plain_calls, "gc_s": wl.gc["s"],
        "gc_full": wl.gc["full"], **checks,
        "checks_s": time.perf_counter() - t_check,
        "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"], out["svcs"] = rows, svcs
    return out


def _log_kubectl(k: dict) -> None:
    st = k["steps"]
    cr, lg, wb = st["create"], st["legacy"], st["web"]
    _log(f"[16] an operator's kubectl session feeding the card: "
         f"{k['kubectl_runs']} kubectl processes, median "
         f"{k['kubectl_median_s']:.3f} s each; create -f of {k['nodes']} "
         f"v1beta1 minions {cr['nodes_v1beta1_s']:.3f} s "
         f"({cr['nodes_per_s']:.1f} objects/s), {k['services']} v1beta2 "
         f"services {cr['services_v1beta2_s']:.3f} s "
         f"({cr['services_per_s']:.1f} objects/s); {k['existing']} "
         f"residents seeded in {' + '.join(f'{s:.2f}' for s in cr['seed_s'])}"
         f" s")
    _log(f"     legacy load: create -f of {lg['pods']} v1beta1 pods "
         f"{lg['create_s']:.3f} s ({lg['pods_v1beta1_per_s']:.1f} "
         f"objects/s), all bound {lg['loop_s']:.3f} s after its start "
         f"({lg['pods_per_s']:.1f} pods/s), {lg['waves']} waves; "
         f"desiredState.host == the v1 binding, the v1beta1 watch saw each "
         f"bind, DesiredState.Host= lists none")
    _log(f"     {wb['cordoned']} nodes cordoned in {wb['cordon_s']:.3f} s; "
         f"web {k['web'][0]} bound {wb['run_s']:.3f} s after run-container "
         f"({wb['run_pods_per_s']:.1f} pods/s), resized to {k['web'][1]} "
         f"in {wb['resize_s']:.3f} s ({wb['resize_pods_per_s']:.1f} "
         f"pods/s), {wb['created']} web pods created, none on a cordoned "
         f"node; rolling update of {k['small']} in "
         f"{st['rolling_update']['update_s']:.3f} s; tear-down "
         f"{st['teardown']['s']:.3f} s (web resized to 0 in "
         f"{st['teardown']['web_to_0_s']:.3f} s, "
         f"{st['teardown']['web_deleted_per_s']:.1f} pods/s, before its "
         f"stop)")
    _log(f"     describe pod unfit: {k['describe']}")
    _log(f"     {k['created']} pods created in the session; encodes "
         f"{k['encodes']}; {len(k['waves'])} waves, {k['launches']} "
         f"commit_solve launches, {k['plain_calls']} plain-version calls; "
         f"every wave == the plain version (max abs err "
         f"{k['max_abs_err']}) and == solve(encode_snapshot) of the "
         f"encoder's state; checks {k['checks_s']:.1f} s, phase "
         f"{k['phase_s']:.1f} s")


class _PathWatch(_LifeWatch):
    """Pods through ``_LifeWatch``'s resuming watch, with the hosts each
    was bound to in order (``path``: a bind, then each migration's
    target), the uids seen under each name (``uids``), the wall time of
    each pod's last host change (``moved_at``), when each was first seen
    Running where it is bound (``running``: a status whose host is the
    pod's and whose containers all started after its last host change, so
    the Running that a migration carries over from the source node does
    not count), and the pods seen Failed with the status's message
    (``failed``)."""

    def __init__(self, url: str):
        self.path: dict = {}
        self.uids: dict = {}
        self.moved_at: dict = {}
        self.running: dict = {}
        self.failed: dict = {}
        super().__init__(url, "pods")

    def _see(self, obj, kind: str = "") -> None:
        super()._see(obj, kind)
        if kind == "DELETED":
            return
        name, host, st = obj.metadata.name, obj.spec.host, obj.status
        self.uids.setdefault(name, set()).add(obj.metadata.uid)
        if host:
            path = self.path.setdefault(name, [])
            if not path or path[-1] != host:
                path.append(host)
                self.moved_at[name] = time.time()
                self.running.pop(name, None)
        if st.phase == "Failed":
            self.failed[name] = st.message
        if not host or st.phase != "Running" or st.host != host:
            return
        since = self.moved_at.get(name, 0.0) if len(self.path[name]) > 1 \
            else 0.0
        started = [cs.state.running.started_at for cs in
                   st.container_statuses if cs.state.running is not None]
        if len(started) == len(obj.spec.containers) and all(
                s is not None and s.timestamp() >= since - 1.0
                for s in started):
            self.running.setdefault(name, time.perf_counter())

    def on(self, hosts) -> set:
        """The live pods whose last host is in ``hosts``."""
        hosts = set(hosts)
        return {n for n in self.alive() if self.path.get(n)
                and self.path[n][-1] in hosts}


def _kubectl_for(url: str, work: str, tag: str, times: list):
    """``_kubectl_runner`` over a kubeconfig in ``work`` that points at
    ``url`` (written by kubectl's own ``config`` commands)."""
    env = {k: v for k, v in os.environ.items()
           if k != "KUBERNETES_AUTH_PATH"}
    env.update(KUBECONFIG=os.path.join(work, "kubeconfig"), HOME=work)
    kubectl = _kubectl_runner(env, tag, times)
    kubectl("config", "set-cluster", "local", f"--server={url}")
    kubectl("config", "set-context", "c", "--cluster=local")
    kubectl("config", "use-context", "c")
    return kubectl


def _defrag_metrics(murl: str) -> dict:
    """The descheduler process's defrag series from its ``/metrics``."""
    code, body = _http_get(murl + "/metrics")
    if code != 200:
        raise AssertionError(f"the descheduler's /metrics answered {code}")
    out = {k: _metric_value(body, f"defrag_{k}", 0.0) for k in (
        "waves_total", "migrations_total", "conflicts_total",
        "nodes_drained_total", "nodes_emptied_total", "wave_seconds_total",
        "score_regressions_total", "fragmentation_score")}
    out["declined"] = {r: _metric_value(
        body, f'defrag_declined_total{{reason="{r}"}}', 0.0)
        for r in ("rate_limited", "pending_work", "error")}
    return out


class _DefragSampler:
    """``_defrag_metrics`` of a descheduler every ``period_s`` s, in a
    thread of its own, into ``samples`` (each with its time ``t``)."""

    def __init__(self, murl: str, period_s: float = 0.2):
        import threading

        self.murl, self.samples = murl, []
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(period_s,),
                                       daemon=True, name="defrag-sampler")
        self.thread.start()

    def _run(self, period_s: float) -> None:
        while not self._stop.is_set():
            try:
                m = _defrag_metrics(self.murl)
                m["t"] = time.perf_counter()
                self.samples.append(m)
            except (OSError, AssertionError):
                pass
            self._stop.wait(period_s)

    def last(self) -> dict:
        if not self.samples:
            return {"waves_total": 0.0, "migrations_total": 0.0,
                    "declined": {"pending_work": 0.0}}
        return self.samples[-1]

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10)


def _check_defrag(samples, tag: str) -> dict:
    """The descheduler's series over a run: no score regression, and the
    fragmentation gauge never rising once a wave has set it -> the
    gauge's values, in order, without repeats."""
    scores: list = []
    for m in samples:
        if m["score_regressions_total"]:
            raise AssertionError(f"{tag}: defrag_score_regressions_total "
                                 f"{m['score_regressions_total']}")
        if m["waves_total"] >= 1:
            if scores and m["fragmentation_score"] > scores[-1]:
                raise AssertionError(f"{tag}: the fragmentation gauge rose "
                                     f"from {scores[-1]} to "
                                     f"{m['fragmentation_score']}")
            if not scores or m["fragmentation_score"] != scores[-1]:
                scores.append(m["fragmentation_score"])
    return scores


def _runtime_procs(root: str) -> dict:
    """pid -> (process group, working directory, argv[0]) of the live
    processes (zombies left out) working under ``root``: the pods' sandbox
    and container processes of the process runtimes rooted there."""
    out = {}
    root = os.path.realpath(root)
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            cwd = os.readlink(f"/proc/{d}/cwd")
            with open(f"/proc/{d}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                argv0 = fh.read().split(b"\0")[0].decode()
            pgid = os.getpgid(int(d))
        except OSError:
            continue
        if state != "Z" and (cwd == root or cwd.startswith(root + os.sep)):
            out[int(d)] = (pgid, cwd, argv0)
    return out


def _kill_runtime_procs(root: str) -> int:
    """SIGKILL the process group of every process working under ``root``
    -> how many processes there were."""
    import signal

    procs = _runtime_procs(root)
    for pgid in {g for g, _c, _e in procs.values()}:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except OSError:
            pass
    return len(procs)


def _gated(sched, gate, stop) -> None:
    """Hold ``sched``'s wave loop before each wave until ``gate`` is set
    (or ``stop``): pods created meanwhile wait unbound."""
    inner = sched.schedule_wave

    def schedule_wave(timeout=None):
        while not gate.is_set() and not stop.is_set():
            gate.wait(0.05)
        return inner(timeout)
    sched.schedule_wave = schedule_wave


def _start_binary(tag: str, url: str, dev, wl, result: dict, stop, ready,
                  on_built=None, wave_size=None, wave_period=1.0):
    """The scheduler binary (``--algorithm tpu-batch --prewarm
    --wave-period``) in a thread of this process, its waves recorded by
    ``wl`` (and ``on_built(sched)`` after) -> (thread, metrics URL)."""
    import threading

    from kubernetes_tpu_torch.cmd import scheduler as cmd

    mport = _free_port()
    argv = ["--master", url, "--algorithm", "tpu-batch", "--prewarm",
            "--wave-period", str(wave_period), "--metrics-port",
            str(mport), "--device", _device_type(dev)]

    def built(sched):
        if wave_size is not None:
            sched.wave_size = wave_size
        wl(sched)
        if on_built is not None:
            on_built(sched)

    thread = threading.Thread(
        target=lambda: result.update(rc=cmd.scheduler_server(
            argv, ready, stop, on_built=built)), daemon=True,
        name=f"{tag}-binary")
    thread.start()
    return thread, f"http://127.0.0.1:{mport}"


def _descheduler_phase(dev, n_nodes=5_000, n_residents=8_000, n_drain=8,
                       n_extra=500, seeders=8, wave_size=None,
                       extra_waves=2, count_launches=True,
                       keep_rows=False) -> dict:
    """Phase 17 (a): ``kubectl drain`` emptying nodes through the
    descheduler, at the reference's fragment-storm width. The port's
    kube-apiserver as a process; north_star's ``n_nodes`` nodes, its 8
    services and its first ``n_residents`` residents seeded and bound;
    the scheduler binary (``--algorithm tpu-batch --prewarm
    --wave-period 1``) in a thread, its waves recorded with the
    encoder's state. ``kubectl drain`` of ``n_drain`` nodes that hold
    residents, as processes; once the binary's node poll has dropped
    them, ``n_extra`` of north_star's pending pods are created while the
    binary's loop is held before its next wave, and the port's
    kube-descheduler starts as a process (``--period 1 --qps 1
    --metrics-port``). Its waves decline with ``pending_work``; the
    first decline releases the binary, which binds the pods; then the
    descheduler migrates. Once every drained node is empty, the phase
    waits for ``extra_waves`` more waves and stops it. Fails unless every
    drained node ends with no pod, a watch of pods saw each pod's host
    change at most once after its bind, the pods (names and uids) before
    the first migration are the pods after the last, every placement fits
    and none is on a cordoned node, no migration came before the first
    ``pending_work`` decline, ``defrag_score_regressions_total`` stays 0
    and the fragmentation gauge never rises (sampled every 0.2 s), the
    descheduler exits 0 on SIGTERM, and each of the binary's waves
    launched commit_solve once and equals the plain version and
    ``solve(encode_snapshot(...))`` of the encoder's state (a pod moved
    since reads back where the descheduler put it)."""
    import shutil
    import signal
    import tempfile
    import threading

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver

    tag = "phase 17 (a)"
    t_phase = time.perf_counter()

    def elapsed() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s in,"
    nodes, existing, pending, services = build_cluster(n_nodes, n_extra)
    residents = existing[:n_residents]
    holding = sorted({p.spec.host for p in residents})
    drained = holding[::max(1, len(holding) // n_drain)][:n_drain]
    extra = {p.metadata.name for p in pending}
    work = tempfile.mkdtemp(prefix="phase17a-")
    kubectl_s: list = []
    wl = _WaveLog(keep_state=True)
    gate = threading.Event()
    procs: list = []
    watches: list = []
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = sampler = None
    steps: dict = {}
    try:
        api_proc, url = _start_apiserver("phase17a")
        procs.append(api_proc)
        client = Client(HTTPTransport(url))
        wait = _waiter(tag, procs, result, elapsed, 300.0)
        seed_s = _seed_cluster(client, nodes, residents, services, seeders,
                               tag)
        _log(f"     {tag}: {elapsed()} {n_nodes} nodes, {len(services)} "
             f"services and {n_residents} residents seeded")
        thread, murl = _start_binary(
            "phase17a", url, dev, wl, result, stop, ready,
            on_built=lambda s: _gated(s, gate, stop), wave_size=wave_size)
        wait(lambda: "compile_prewarm_ready 1" in _wait_http(
            murl + "/metrics", None, f"{tag}: the scheduler binary"
        ).splitlines(), "the binary's prewarm", 600.0, poll_s=0.2)
        f = wl.sched.factory
        wait(lambda: (len(f.node_store) == n_nodes
                      and len(f.scheduled_pods) == n_residents
                      and len(f.service_store) == len(services)),
             "the scheduler's caches to hold the cluster")
        pods_w = _PathWatch(url)
        watches.append(pods_w)
        kubectl = _kubectl_for(url, work, tag, kubectl_s)

        # ---- drain ----------------------------------------------------------
        drain_out: list = []
        t_drain = time.perf_counter()
        _parallel(8, drained,
                  lambda n: drain_out.append(kubectl("drain", n)))
        drain_s = time.perf_counter() - t_drain
        want = sorted(f"node/{n} cordoned\nnode/{n} draining (pods migrate "
                      f"on the next descheduler wave)\n" for n in drained)
        if sorted(drain_out) != want:
            raise AssertionError(f"{tag}: drain printed "
                                 f"{sorted(drain_out)[:1]}")
        on_drained0 = len(pods_w.on(drained))
        wait(lambda: not {n.metadata.name for n in f.node_store.list()}
             & set(drained), "the scheduler's nodes to drop the drained")
        _log(f"     {tag}: {elapsed()} {n_drain} nodes drained by kubectl "
             f"({on_drained0} pods on them), the binary's nodes without "
             f"them")

        # ---- pending work, then the descheduler -----------------------------
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t_first = time.perf_counter()
        _parallel(seeders, pending, lambda p: client.pods().create(p))
        dport = _free_port()
        dsched, dsched_ready_s = _spawn(
            "phase17a_descheduler", "kubernetes_tpu_torch.cmd.descheduler",
            ["--master", url, "--period", "1", "--qps", "1",
             "--metrics-port", dport], "kube-descheduler running")
        procs.append(dsched)
        durl = f"http://127.0.0.1:{dport}"
        sampler = _DefragSampler(durl)
        wait(lambda: sampler.last()["declined"]["pending_work"] >= 1,
             "the descheduler's pending_work decline")
        at_gate = _defrag_metrics(durl)
        if at_gate["migrations_total"] or at_gate["waves_total"]:
            raise AssertionError(f"{tag}: the descheduler solved before "
                                 f"the pending pods were bound: {at_gate}")
        t_gate = time.perf_counter()
        gate.set()
        wait(lambda: extra <= set(pods_w.first),
             f"the binds of {n_extra} pods",
             progress=lambda: f"{len(extra & set(pods_w.first))} bound")
        t_bound = max(pods_w.first[n] for n in extra)
        t_bound_wall = time.time() - (time.perf_counter() - t_bound)
        waves_at_bound = sampler.last()["waves_total"]
        before = {(p.metadata.name, p.metadata.uid)
                  for p in client.pods("").list().items}
        wait(lambda: not pods_w.on(drained), "the drained nodes to empty",
             progress=lambda: f"{len(pods_w.on(drained))} pods left on "
                              f"them, {sampler.last()}")
        t_empty = time.perf_counter()
        waves_at_empty = _defrag_metrics(durl)["waves_total"]
        wait(lambda: sampler.last()["waves_total"] >= waves_at_empty
             + extra_waves, f"{extra_waves} more descheduler waves")
        final_m = _defrag_metrics(durl)
        dsched.send_signal(signal.SIGTERM)
        dsched_rc = dsched.wait(timeout=30)
        sampler.stop()
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items
        svcs = f.service_store.list()
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        _log(f"     {tag}: {elapsed()} {n_extra} pods bound, the drained "
             f"nodes empty, {int(final_m['waves_total'])} descheduler "
             f"waves, {int(final_m['migrations_total'])} migrations")
    except BaseException:
        _abort_children(procs, "phase17a")
        raise
    finally:
        gate.set()
        if sampler is not None:
            sampler.stop()
        for w in watches:
            w.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        for p in procs:
            _stop_process(p)
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    if dsched_rc != 0:
        raise AssertionError(f"{tag}: the descheduler exited {dsched_rc} "
                             f"on SIGTERM")

    # ---- the checks, after the run -----------------------------------------
    t_check = time.perf_counter()
    after = {(p.metadata.name, p.metadata.uid) for p in final}
    if after != before:
        raise AssertionError(f"{tag}: pods before the migrations "
                             f"{len(before)}, after {len(after)}; "
                             f"{len(before - after)} lost, e.g. "
                             f"{sorted(before - after)[:1]}")
    twice = [n for n, path in pods_w.path.items() if len(path) > 2]
    if twice or any(len(u) != 1 for u in pods_w.uids.values()):
        raise AssertionError(f"{tag}: {len(twice)} pods moved more than "
                             f"once, e.g. {twice[:1]}")
    left = [p.metadata.name for p in final if p.spec.host in drained]
    if left:
        raise AssertionError(f"{tag}: {len(left)} pods left on drained "
                             f"nodes, e.g. {left[0]}")
    _check_placements(final, final_nodes, tag)
    if sorted(n.metadata.name for n in final_nodes
              if n.spec.unschedulable) != sorted(drained):
        raise AssertionError(f"{tag}: the cordoned nodes are not the "
                             f"drained ones")
    scores = _check_defrag(sampler.samples, tag)
    moved = {n for n, path in pods_w.path.items() if len(path) == 2}
    move_t = sorted(pods_w.moved_at[n] for n in moved)
    if len(moved) != final_m["migrations_total"] or not moved:
        raise AssertionError(f"{tag}: the watch saw {len(moved)} pods move, "
                             f"the descheduler counts "
                             f"{final_m['migrations_total']} migrations")
    rows = [r for r in wl.rows if r["order"]]
    checks = _check_waves(rows, final, extra, svcs, dev, tag,
                          count_launches, launches, plain_calls, gone=moved)
    waves = final_m["waves_total"]
    out = {
        "nodes": n_nodes, "residents": n_residents,
        "services": len(services), "drained": drained, "extra": n_extra,
        "seed_s": seed_s, "prewarm_s": wl.sched.prewarm_s,
        "drain_s": drain_s, "on_drained": on_drained0,
        "kubectl_runs": len(kubectl_s),
        "kubectl_median_s": statistics.median(kubectl_s),
        "descheduler_ready_s": dsched_ready_s,
        "gate_s": t_gate - t_first, "bind_s": t_bound - t_gate,
        "pods_per_s": n_extra / (t_bound - t_gate),
        "drain_to_empty_s": t_empty - t_drain,
        "bound_to_empty_s": t_empty - t_bound,
        "migrations": len(moved),
        "mandatory": sum(1 for n in moved if pods_w.path[n][0] in drained),
        # from the last bind (no pending work left) to the last move
        "migrations_per_s": len(moved) / (move_t[-1] - t_bound_wall),
        "migrations_per_wave": len(moved) / max(
            waves - waves_at_bound, 1),
        "descheduler": {k: v for k, v in final_m.items()},
        "wave_cpu_s": final_m["wave_seconds_total"] / max(waves, 1),
        "scores": scores,
        "encodes": {k: sum(r.get("encode_path") == k for r in rows)
                    for k in ("full", "delta", "replay")},
        "waves": _wave_rows(rows, t_first), "launches": launches,
        "plain_calls": plain_calls, **checks,
        "checks_s": time.perf_counter() - t_check,
        "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"], out["svcs"] = rows, svcs
    return out


def _kubelet_phase(dev, kubelets=4, replicas=120, node_cpu="5",
                   node_memory="8Gi", wave_size=None, count_launches=True,
                   keep_rows=False) -> dict:
    """Phase 17 (b): kubelets running the pods ``commit_solve`` placed,
    and a drain moving them. The port's kube-apiserver and
    kube-controller-manager (no cloud) as processes, the scheduler binary
    (``--algorithm tpu-batch --prewarm --wave-period 1``) in a thread,
    and ``kubelets`` kubelets as processes (``python -m
    kubernetes_tpu_torch.cmd.kubelet --register-node --container-runtime
    process``, ``node_cpu`` and ``node_memory`` each, each with its own
    root directory and port). A service ``web`` and an RC of ``replicas``
    pods behind it (100m and 64Mi, ``sleep 3600``: density.go's 30 a node
    at the defaults, which leave every node above the descheduler's
    700-permille source line, so that only node-0's pods move). Fails
    unless every pod binds and reaches Running through
    its kubelet's status, each runtime holds a sandbox and a container
    process for each of its pods (the process table: processes working
    under the runtime's root) and the sandboxes are the native pause
    binary, the endpoints name every pod with its IP, and no pod is ever
    Failed (no kubelet rejects a bound pod). Then ``kubectl drain
    node-0`` and the port's kube-descheduler as a process (``--period 1
    --qps 1``): node-0's pods move, node-0's runtime ends with no live
    process, every pod is Running again through the kubelet of its new
    node, the endpoints name every pod again, no pod is lost or moved
    twice, and each of the binary's waves launched commit_solve once and
    equals the plain version and ``solve(encode_snapshot(...))`` of the
    encoder's state. Every process the runtimes started is killed at the
    end."""
    import shutil
    import signal
    import tempfile
    import threading

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.kubelet import process_runtime
    from kubernetes_tpu_torch.ops import commit_solver

    tag = "phase 17 (b)"
    t_phase = time.perf_counter()

    def elapsed() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s in,"
    names = [f"node-{i}" for i in range(kubelets)]
    work = os.path.realpath(tempfile.mkdtemp(prefix="phase17b-"))
    roots = {n: os.path.join(work, n) for n in names}
    labels = {"app": "web"}
    rc = api.ReplicationController(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=replicas, selector=dict(labels),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels=dict(labels)),
                spec=api.PodSpec(containers=[api.Container(
                    name="web", image="busybox",
                    command=["sleep", "3600"],
                    ports=[api.ContainerPort(container_port=8080)],
                    resources=api.ResourceRequirements(limits={
                        "cpu": Quantity("100m"),
                        "memory": Quantity("64Mi")}))]))))
    svc = api.Service(
        metadata=api.ObjectMeta(name="web", namespace="default"),
        spec=api.ServiceSpec(port=80, container_port=8080,
                             selector=dict(labels)))
    kubectl_s: list = []
    wl = _WaveLog(keep_state=True)
    procs: list = []
    watches: list = []
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = sampler = None
    killed = 0
    try:
        api_proc, url = _start_apiserver("phase17b")
        procs.append(api_proc)
        client = Client(HTTPTransport(url))
        wait = _waiter(tag, procs, result, elapsed, 300.0)
        mgr, _s = _spawn(
            "phase17b_manager", "kubernetes_tpu_torch.cmd.controller_manager",
            ["--master", url], "kube-controller-manager running")
        procs.append(mgr)
        kl_ports = {}
        spawned = []
        t0 = time.perf_counter()

        def start_kubelet(n):
            kl_ports[n] = port = _free_port()
            spawned.append(_spawn(
                f"phase17b_kubelet_{n}", "kubernetes_tpu_torch.cmd.kubelet",
                ["--api-servers", url, "--hostname-override", n,
                 "--register-node", "--container-runtime", "process",
                 "--root-dir", roots[n], "--port", port,
                 "--address", "127.0.0.1", "--node-cpu", node_cpu,
                 "--node-memory", node_memory, "--sync-frequency", "2"],
                f"kubelet {n} serving on")[0])
        _parallel(kubelets, names, start_kubelet)
        procs += spawned
        kubelets_ready_s = time.perf_counter() - t0
        thread, murl = _start_binary("phase17b", url, dev, wl, result, stop,
                                     ready, wave_size=wave_size)
        wait(lambda: "compile_prewarm_ready 1" in _wait_http(
            murl + "/metrics", None, f"{tag}: the scheduler binary"
        ).splitlines(), "the binary's prewarm", 600.0, poll_s=0.2)
        f = wl.sched.factory
        wait(lambda: len(f.node_store) == kubelets,
             f"the scheduler's nodes to hold the {kubelets} registered")
        pods_w = _PathWatch(url)
        watches.append(pods_w)
        _log(f"     {tag}: {elapsed()} {kubelets} kubelets registered "
             f"their nodes, the binary warm")

        # ---- the RC behind a service ------------------------------------
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        client.services().create(svc)
        t_first = time.perf_counter()
        client.replication_controllers().create(rc)

        def web_pods() -> set:
            return {n for n in pods_w.alive()
                    if pods_w.labels[n].get("app") == "web"}

        def all_running() -> bool:
            pods = web_pods()
            return len(pods) == replicas and all(
                n in pods_w.running for n in pods)

        def endpoints_full() -> bool:
            try:
                eps = client.endpoints("default").get("web").endpoints
            except Exception:
                return False
            pods = {p.metadata.name: p for p in client.pods().list(
                label_selector="app=web").items}
            refs = {(e.target_ref.name if e.target_ref else "", e.ip)
                    for e in eps}
            return len(eps) == replicas and refs == {
                (n, p.status.pod_ip) for n, p in pods.items()} and all(
                p.status.pod_ip for p in pods.values())

        def runtimes_hold() -> dict:
            return {n: len(_runtime_procs(roots[n])) for n in names}

        wait(all_running, f"{replicas} pods Running",
             progress=lambda: f"{len(web_pods())} created, "
                              f"{len(set(pods_w.first) & web_pods())} bound, "
                              f"{len(set(pods_w.running) & web_pods())} "
                              f"Running")
        t_running = time.perf_counter()
        up = {n: pods_w.running[n] - pods_w.first[n] for n in web_pods()}
        wait(endpoints_full, "the endpoints to name every pod", 120.0)
        t_endpoints = time.perf_counter()
        per_node = {n: len(pods_w.on([n]) & web_pods()) for n in names}
        held = runtimes_hold()
        if held != {n: 2 * per_node[n] for n in names}:
            raise AssertionError(f"{tag}: the runtimes hold {held} "
                                 f"processes for {per_node} pods")
        sandboxes = sorted({e for n in names
                            for _g, _c, e in _runtime_procs(
                                roots[n]).values()
                            if e != "sleep"})
        native = [e for e in sandboxes
                  if os.path.dirname(e) in (process_runtime.BUILD_DIR,
                                            os.path.join(_ROOT, "native",
                                                         "pause"))]
        if native != sandboxes or len(sandboxes) != 1:
            raise AssertionError(f"{tag}: the sandboxes are {sandboxes}, "
                                 f"not the native pause binary")
        _log(f"     {tag}: {elapsed()} {replicas} pods Running on "
             f"{per_node}, {sum(held.values())} runtime processes, "
             f"sandbox {sandboxes[0]}, endpoints full")

        # ---- drain node-0 -----------------------------------------------
        kubectl = _kubectl_for(url, work, tag, kubectl_s)
        moving = pods_w.on([names[0]]) & web_pods()
        t_drain = time.perf_counter()
        kubectl("drain", names[0])
        dport = _free_port()
        dsched, _s = _spawn(
            "phase17b_descheduler", "kubernetes_tpu_torch.cmd.descheduler",
            ["--master", url, "--period", "1", "--qps", "1",
             "--metrics-port", dport], "kube-descheduler running")
        procs.append(dsched)
        sampler = _DefragSampler(f"http://127.0.0.1:{dport}")
        wait(lambda: not pods_w.on([names[0]]),
             f"{names[0]}'s pods to move",
             progress=lambda: f"{len(pods_w.on([names[0]]))} left")
        t_moved = time.perf_counter()
        wait(lambda: not _runtime_procs(roots[names[0]]),
             f"{names[0]}'s runtime to stop its processes", 60.0)
        t_empty = time.perf_counter()
        wait(all_running, f"{replicas} pods Running again",
             progress=lambda: f"{len(set(pods_w.running) & web_pods())} "
                              f"Running")
        t_again = time.perf_counter()
        wait(endpoints_full, "the endpoints to name every pod again", 120.0)
        per_node_after = {n: len(pods_w.on([n]) & web_pods()) for n in names}
        held_after = runtimes_hold()
        if held_after != {n: 2 * per_node_after[n] for n in names}:
            raise AssertionError(f"{tag}: after the drain the runtimes "
                                 f"hold {held_after} processes for "
                                 f"{per_node_after} pods")
        served = {}
        for n in names:
            # a kubelet builds /pods with every pod's status from its
            # runtime: with ~50 pods just started on a loaded host that
            # took over the default 10 s once on the H100 machine
            code, body = _http_get(f"http://127.0.0.1:{kl_ports[n]}/pods",
                                   timeout=60.0)
            items = json.loads(body)["items"] if code == 200 else None
            served[n] = sorted(
                (p["metadata"]["name"], p["status"]["phase"])
                for p in items) if items is not None else None
        want = {n: sorted((p, "Running") for p in pods_w.on([n])
                          & web_pods()) for n in names}
        if served != want:
            raise AssertionError(f"{tag}: the kubelets' /pods differ from "
                                 f"the bindings")
        final_m = _defrag_metrics(f"http://127.0.0.1:{dport}")
        dsched.send_signal(signal.SIGTERM)
        dsched_rc = dsched.wait(timeout=30)
        sampler.stop()
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items
        events = client.events("default").list().items
        svcs = f.service_store.list()
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        _log(f"     {tag}: {elapsed()} {names[0]} drained: {len(moving)} "
             f"pods moved to {per_node_after}, its runtime empty, every "
             f"pod Running again")
    except BaseException:
        _abort_children(procs, "phase17b")
        raise
    finally:
        if sampler is not None:
            sampler.stop()
        for w in watches:
            w.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        for p in procs:
            _stop_process(p)
        killed = _kill_runtime_procs(work)
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    if dsched_rc != 0:
        raise AssertionError(f"{tag}: the descheduler exited {dsched_rc} "
                             f"on SIGTERM")

    # ---- the checks, after the run -----------------------------------------
    t_check = time.perf_counter()
    web = {p.metadata.name for p in final
           if p.metadata.labels.get("app") == "web"}
    if len(web) != replicas or set(pods_w.seen) != web:
        raise AssertionError(f"{tag}: {len(pods_w.seen)} pods seen, "
                             f"{len(web)} left of the RC's {replicas}")
    twice = [n for n, path in pods_w.path.items() if len(path) > 2]
    if twice or any(len(u) != 1 for u in pods_w.uids.values()):
        raise AssertionError(f"{tag}: {len(twice)} pods moved more than "
                             f"once, e.g. {twice[:1]}")
    moved = {n for n, path in pods_w.path.items() if len(path) == 2}
    if moved != moving:
        raise AssertionError(f"{tag}: {len(moved)} pods moved, "
                             f"{len(moving)} were on {names[0]}")
    rejected = [e.reason for e in events if e.reason in (
        "HostPortConflict", "NodeSelectorMismatching", "ExceededCapacity")]
    if pods_w.failed or rejected:
        raise AssertionError(f"{tag}: pods Failed {pods_w.failed}, "
                             f"kubelet rejections {rejected[:3]}")
    _check_placements(final, final_nodes, tag)
    scores = _check_defrag(sampler.samples, tag)
    rows = [r for r in wl.rows if r["order"]]
    checks = _check_waves(rows, final, web, svcs, dev, tag,
                          count_launches, launches, plain_calls, gone=moved)
    up_after = [pods_w.running[n] - t_moved for n in moved]
    out = {
        "kubelets": kubelets, "replicas": replicas,
        "kubelets_ready_s": kubelets_ready_s,
        "prewarm_s": wl.sched.prewarm_s, "sandbox": sandboxes[0],
        "per_node": per_node, "per_node_after": per_node_after,
        "runtime_processes": sum(held.values()),
        "bind_to_running_s": {"median": statistics.median(up.values()),
                              "max": max(up.values())},
        "running_s": t_running - t_first,
        "endpoints_s": t_endpoints - t_first,
        "moved": len(moved), "drain_to_moved_s": t_moved - t_drain,
        "drain_to_empty_s": t_empty - t_drain,
        "drain_to_running_s": t_again - t_drain,
        "moved_running_after_s": max(up_after) if up_after else None,
        "descheduler": final_m, "scores": scores,
        "killed_at_end": killed,
        "waves": _wave_rows(rows, t_first), "launches": launches,
        "plain_calls": plain_calls, **checks,
        "checks_s": time.perf_counter() - t_check,
        "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"], out["svcs"] = rows, svcs
    return out


def _log_descheduler(a: dict, b: dict) -> None:
    d = a["descheduler"]
    _log(f"[17] (a) the descheduler at the fragment storm's width: "
         f"{a['nodes']} nodes, {a['residents']} residents; kubectl drain of "
         f"{len(a['drained'])} nodes ({a['on_drained']} pods on them) "
         f"{a['drain_s']:.3f} s ({a['kubectl_runs']} kubectl processes, "
         f"median {a['kubectl_median_s']:.3f} s); {a['extra']} pods held "
         f"pending {a['gate_s']:.3f} s until the descheduler declined "
         f"(pending_work), then bound in {a['bind_s']:.3f} s "
         f"({a['pods_per_s']:.1f} pods/s)")
    _log(f"     {a['migrations']} migrations ({a['mandatory']} off the "
         f"drained nodes) at {a['migrations_per_s']:.1f} /s after the "
         f"last bind, {a['migrations_per_wave']:.1f} a wave, "
         f"{int(d['waves_total'])} waves ({a['wave_cpu_s']:.3f} CPU s a "
         f"wave), declines {d['declined']}, {int(d['conflicts_total'])} "
         f"conflicts; the drained nodes empty {a['drain_to_empty_s']:.3f} "
         f"s after the drain ({a['bound_to_empty_s']:.3f} s after the last "
         f"bind); fragmentation score {a['scores']}, no regression; "
         f"no pod moved twice or lost")
    _log(f"     {len(a['waves'])} waves, {a['launches']} commit_solve "
         f"launches, {a['plain_calls']} plain-version calls; every wave == "
         f"the plain version (max abs err {a['max_abs_err']}) and == "
         f"solve(encode_snapshot) of the encoder's state; checks "
         f"{a['checks_s']:.1f} s, phase {a['phase_s']:.1f} s")
    _log(f"     (b) {b['kubelets']} kubelet processes (ready "
         f"{b['kubelets_ready_s']:.3f} s), an RC of {b['replicas']}: "
         f"Running on {b['per_node']} {b['running_s']:.3f} s after the RC "
         f"(bind to Running median {b['bind_to_running_s']['median']:.3f} "
         f"s, max {b['bind_to_running_s']['max']:.3f}), endpoints full at "
         f"{b['endpoints_s']:.3f} s; {b['runtime_processes']} runtime "
         f"processes; sandbox {b['sandbox']}")
    _log(f"     kubectl drain node-0: {b['moved']} pods moved in "
         f"{b['drain_to_moved_s']:.3f} s, node-0's runtime empty at "
         f"{b['drain_to_empty_s']:.3f} s, all Running again at "
         f"{b['drain_to_running_s']:.3f} s on {b['per_node_after']}; "
         f"{len(b['waves'])} waves, {b['launches']} launches, "
         f"{b['plain_calls']} plain calls, every wave exact; "
         f"{b['killed_at_end']} runtime processes killed at the end; phase "
         f"{b['phase_s']:.1f} s")



# ---- phase 18: the service path, the addons and the deploy script ---------

# a hostnames backend (test/soak/serve_hostnames' container): binds its
# port, retrying while a deleted predecessor still holds it, prints one
# start line, and answers every connection with its RC's name
_BACKEND = """\
import socket, sys, time
name, port = sys.argv[1], int(sys.argv[2])
s = socket.socket()
s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
t0 = time.monotonic()
while True:
    try:
        s.bind(("127.0.0.1", port))
        break
    except OSError:
        if time.monotonic() - t0 > 10:
            raise
        time.sleep(0.1)
s.listen(128)
print("hostnames backend %s serving on %d" % (name, port), flush=True)
while True:
    c, _ = s.accept()
    try:
        c.settimeout(5)
        c.recv(64)
        c.sendall(name.encode())
    except OSError:
        pass
    c.close()
"""


def _listening_ports(pid: int) -> set:
    """The TCP ports process ``pid`` listens on: its socket inodes
    (/proc/<pid>/fd) matched against the LISTEN rows of
    /proc/<pid>/net/tcp."""
    inodes = set()
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            link = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if link.startswith("socket:["):
            inodes.add(link[8:-1])
    ports = set()
    with open(f"/proc/{pid}/net/tcp") as fh:
        next(fh)
        for line in fh:
            f = line.split()
            if f[3] == "0A" and f[9] in inodes:
                ports.add(int(f[1].rsplit(":", 1)[1], 16))
    return ports


def _port_free(addr: str, port: int, kind: str = "tcp") -> bool:
    """Whether a server could bind ``addr:port`` now (TCP with
    SO_REUSEADDR, as the servers bind: a closed connection's TIME_WAIT
    does not hold the port, a listener does)."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM if kind == "udp"
                      else socket.SOCK_STREAM)
    if kind != "udp":
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind((addr, port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def _below_ephemeral() -> range:
    """The ports above the deploy script's fixed ones (10053-10252) and
    below the kernel's ephemeral range, which no client connection of
    the run takes."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
        return range(10_300, int(fh.read().split()[0]))


def _free_fixed_ports(n: int, addrs, seed: int, taken=()) -> list:
    """``n`` TCP ports of ``_below_ephemeral()`` free on every address of
    ``addrs`` (so that no client connection takes one while a backend is
    away), drawn from a seeded start. Fails naming an address that
    refuses every bind."""
    lo, hi = _below_ephemeral().start, _below_ephemeral().stop
    start = random.Random(seed).randrange(lo, hi)
    out: list = []
    for k in range(hi - lo):
        p = lo + (start - lo + k) % (hi - lo)
        if p in taken or p in out:
            continue
        if all(_port_free(a, p) for a in addrs):
            out.append(p)
            if len(out) == n:
                return out
    bad = [a for a in addrs if not _port_free(a, 0)]
    raise AssertionError(f"no {n} free ports on {list(addrs)}"
                         + (f": {bad[0]} refuses a bind" if bad else ""))


def _dns_query(addr, name: str, qtype: int = 1, txid: int = 0x1234):
    """One RFC 1035 query over UDP -> (rcode, A address or None,
    seconds)."""
    import socket
    import struct

    q = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    for label in name.split("."):
        q += bytes([len(label)]) + label.encode()
    q += b"\x00" + struct.pack(">HH", qtype, 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(5)
    try:
        t0 = time.perf_counter()
        s.sendto(q, addr)
        resp, _ = s.recvfrom(512)
        dt = time.perf_counter() - t0
    finally:
        s.close()
    rtxid, flags, _qd, an = struct.unpack(">HHHH", resp[:8])
    if rtxid != txid:
        raise AssertionError(f"DNS answer for txid {rtxid}, sent {txid}")
    ip = None
    if an:
        pos = 12
        while resp[pos] != 0:
            pos += 1 + resp[pos]
        pos += 5
        (rdlen,) = struct.unpack(">H", resp[pos + 10: pos + 12])
        if rdlen == 4:
            ip = socket.inet_ntoa(resp[pos + 12: pos + 16])
    return flags & 0xF, ip, dt


class _Soak:
    """``clients`` threads connecting to 127.0.0.1:``port`` for
    ``seconds``, one new TCP connection a request (``who``, then the
    answer up to EOF): every answer's name in ``seen``, each request's
    seconds, and the failures (a refused or reset connection, a timeout,
    or an empty answer: the proxy closed it without a backend) with the
    first few reasons."""

    def __init__(self, port: int, seconds: float, clients: int = 4):
        import threading

        self.port, self.seconds = port, seconds
        self.seen: set = set()
        self.lat: list = []
        self.errors = 0
        self.reasons: list = []
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._run, daemon=True,
                                         name=f"soak-{k}")
                        for k in range(clients)]

    def _one(self) -> str:
        import socket

        with socket.create_connection(("127.0.0.1", self.port),
                                      timeout=5) as s:
            s.sendall(b"who")
            data = b""
            while True:
                chunk = s.recv(64)
                if not chunk:
                    return data.decode()
                data += chunk

    def _run(self) -> None:
        end = time.monotonic() + self.seconds
        while time.monotonic() < end:
            t0 = time.perf_counter()
            try:
                name, why = self._one(), "empty answer"
            except OSError as e:
                name, why = "", repr(e)
            dt = time.perf_counter() - t0
            with self._lock:
                self.lat.append(dt)
                if name:
                    self.seen.add(name)
                else:
                    self.errors += 1
                    if len(self.reasons) < 5:
                        self.reasons.append(why)

    def run(self) -> "_Soak":
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def join(self) -> dict:
        for t in self.threads:
            t.join()
        wall = time.perf_counter() - self.t0
        lat = sorted(self.lat)
        pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
               if lat else None)
        return {"requests": len(lat), "errors": self.errors,
                "reasons": self.reasons, "names": len(self.seen),
                "requests_per_s": len(lat) / wall, "p50_s": pct(0.50),
                "p99_s": pct(0.99), "seconds": wall}


class _EndpointsPoll:
    """The Endpoints ``name`` read over HTTP every ``period_s`` s in a
    thread of its own: when each pod was first named (``first``) and the
    latest set of (pod, ip, port) (``now``)."""

    def __init__(self, url: str, name: str, period_s: float = 0.1):
        import threading

        from kubernetes_tpu_torch.client.client import Client
        from kubernetes_tpu_torch.client.http import HTTPTransport

        self.client = Client(HTTPTransport(url))
        self.name = name
        self.first: dict = {}
        self.now: set = set()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(period_s,),
                                       daemon=True, name="endpoints-poll")
        self.thread.start()

    def _run(self, period_s: float) -> None:
        while not self._stop.is_set():
            try:
                eps = self.client.endpoints("default").get(
                    self.name).endpoints
                t = time.perf_counter()
                now = {(e.target_ref.name if e.target_ref else "", e.ip,
                        e.port) for e in eps}
                for n, _ip, _p in now:
                    self.first.setdefault(n, t)
                self.now = now
            except Exception:  # not created yet, or a transient error
                pass
            self._stop.wait(period_s)

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10)


def _backend_rc(name: str, port: int):
    """RC ``name`` of one hostnames backend: labels ``app=hostnames`` and
    its own ``rc``, nodeSelector ``role=serving``, 100m and 64Mi, host
    network, ``port`` as its container and host port."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.quantity import Quantity

    labels = {"app": "hostnames", "rc": name}
    return api.ReplicationController(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.ReplicationControllerSpec(
            replicas=1, selector=dict(labels),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels=dict(labels)),
                spec=api.PodSpec(
                    host_network=True, node_selector={"role": "serving"},
                    containers=[api.Container(
                        name="hostnames", image="serve_hostname",
                        command=[sys.executable, "-c", _BACKEND, name,
                                 str(port)],
                        ports=[api.ContainerPort(container_port=port,
                                                 host_port=port)],
                        resources=api.ResourceRequirements(limits={
                            "cpu": Quantity("100m"),
                            "memory": Quantity("64Mi")}))]))))


def _runtime_procs_after(root: str, timeout_s: float) -> dict:
    """``_runtime_procs(root)`` once it is empty, or after ``timeout_s``
    (a process killed a moment ago may not have exited yet)."""
    deadline = time.monotonic() + timeout_s
    while True:
        left = _runtime_procs(root)
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)


def _hyperkube(tag: str, server: str, args, ready: str, env=None):
    """``python -m kubernetes_tpu_torch.cmd.hyperkube server args`` as a
    process of its own (``_spawn``)."""
    return _spawn(tag, "kubernetes_tpu_torch.cmd.hyperkube",
                  [server, *args], ready, env=env)


def _service_phase(dev, n_nodes=5_000, kubelets=4, backends=120,
                   churn=(4, 12, 5.0), soak_s=10.0, clients=4,
                   wave_size=None, count_launches=True,
                   keep_rows=False) -> dict:
    """Phase 18 (a): the service path on an inventory cluster, the shape
    ``kubernetes_tpu_torch/deploy/inventory-up.sh`` deploys, each server
    a process of its own started by its hyperkube name: ``apiserver`` and
    ``controller-manager`` with ``--cloud-provider inventory`` over
    north_star's ``n_nodes`` instances, each at a loopback address of its
    own (127.0.x.y, x >= 1, so that an addon's dial to a node without a
    kubelet is refused at once); ``kubelets`` of them (127.0.1.1, ...)
    run a ``kubelet`` (process runtime, 5 CPUs and 8Gi, one port free on
    every address) and are labelled ``role=serving`` by ``kubectl
    label`` processes; ``proxy`` (in-memory rule table), ``dns``,
    ``monitoring`` and ``logging`` (``python -m``: hyperkube's table has
    no such name); the scheduler binary (``--algorithm tpu-batch
    --prewarm --wave-period 1``) in a thread. north_star's 8 services,
    then ``backends`` RCs ``hn-000``... of one replica each (host
    network, nodeSelector ``role=serving``, each its own free port as
    container and host port, the ``_BACKEND`` command) behind the
    service ``hostnames``. Gates: every backend binds to a serving node
    and runs; the endpoints name each at 127.0.0.1 and its port; a soak
    of ``clients`` threads through the proxy's port of ``hostnames`` for
    ``soak_s`` has no error and reaches every backend; ``churn`` =
    (rounds, pods, period): that many backend pods deleted each period,
    each of its own RC, while the clients go on (errors recorded, not
    gated), then, settled, a second soak as the first; every wave
    launched commit_solve once over all ``n_nodes`` nodes and equals the
    plain version and ``solve(encode_snapshot(...))`` of the encoder's
    state (``_check_waves``), the plain version never ran; every
    service resolves through the dns process to the portal IP the
    apiserver reports, an unknown name and a deleted service answer
    NXDOMAIN (the latter within 5 s); the logging process returns each
    live backend's start line within 20 s; the monitoring process shows
    ``n_nodes`` nodes and the ``kubelets`` serving ones scraped. At the
    end every process the phase or the runtimes started is stopped."""
    import shutil
    import tempfile
    import threading

    from kubernetes_tpu_torch.addons.logging import (LogAggregator,
                                                     http_kubelet_log_fetcher)
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.models.fixtures import build_cluster
    from kubernetes_tpu_torch.ops import commit_solver

    tag = "phase 18 (a)"
    t_phase = time.perf_counter()

    def elapsed() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s in,"
    _nodes, _existing, _pending, services = build_cluster(n_nodes, 0)
    names = [f"node-{i:05d}" for i in range(n_nodes)]
    addrs = {n: f"127.0.{1 + k // 250}.{1 + k % 250}"
             for k, n in enumerate(names)}
    serving = names[:kubelets]
    rounds, per_round, period_s = churn
    rc_names = [f"hn-{k:03d}" for k in range(backends)]
    work = os.path.realpath(tempfile.mkdtemp(prefix="phase18a-"))
    roots = {n: os.path.join(work, n) for n in serving}
    inventory = os.path.join(work, "inventory.json")
    with open(inventory, "w") as fh:
        json.dump({"zone": {"failure_domain": "z0", "region": "local"},
                   "instances": [{
                       "name": n, "addresses": [addrs[n]],
                       "cpu": "5" if n in roots else "16",
                       "memory": "8Gi" if n in roots else "64Gi"}
                       for n in names]}, fh)
    env = dict(os.environ, KTPU_CLOUD_INVENTORY=inventory)
    kl_port = _free_fixed_ports(1, [addrs[n] for n in serving], 18)[0]
    ports = _free_fixed_ports(backends, ["127.0.0.1"], 1_800,
                              taken={kl_port})
    wl = _WaveLog(keep_state=True)
    procs: dict = {}
    watches: list = []
    stop, ready = threading.Event(), threading.Event()
    result: dict = {}
    thread = ep_poll = None
    kubectl_s: list = []
    killed = 0
    try:
        port = _free_port()
        procs["apiserver"], _s = _hyperkube(
            "phase18a_apiserver", "apiserver",
            ["--port", port, "--cloud-provider", "inventory"],
            "kube-apiserver listening on", env=env)
        url = f"http://127.0.0.1:{port}"
        _wait_http(url + "/healthz", procs["apiserver"], f"{tag}: the "
                   f"apiserver", 120.0)
        client = Client(HTTPTransport(url))
        wait = _waiter(tag, list(procs.values()), result, elapsed, 300.0)
        nodes_w = _LifeWatch(url, "nodes")
        pods_w = _PathWatch(url)
        watches += [nodes_w, pods_w]
        t0 = time.perf_counter()
        procs["manager"], _s = _hyperkube(
            "phase18a_manager", "controller-manager",
            ["--master", url, "--cloud-provider", "inventory",
             "--node-sync-period", "1"], "kube-controller-manager running",
            env=env)
        wait = _waiter(tag, list(procs.values()), result, elapsed, 300.0)
        wait(lambda: len(nodes_w.conds) >= n_nodes,
             f"the registration of {n_nodes} nodes with their conditions",
             progress=lambda: f"{len(nodes_w.seen)} registered, "
                              f"{len(nodes_w.conds)} with conditions")
        registered_s = time.perf_counter() - t0
        got = {n.metadata.name: [a.address for a in n.status.addresses]
               for n in client.nodes().list().items}
        if got != {n: [a] for n, a in addrs.items()}:
            raise AssertionError(f"{tag}: the registered nodes and their "
                                 f"addresses are not the inventory's")
        kubectl = _kubectl_for(url, work, tag, kubectl_s)
        for n in serving:
            kubectl("label", "nodes", n, "role=serving")
        spawned: dict = {}

        def start_kubelet(n):
            spawned[n] = _hyperkube(
                f"phase18a_kubelet_{n}", "kubelet",
                ["--api-servers", url, "--hostname-override", n,
                 "--container-runtime", "process", "--root-dir", roots[n],
                 "--address", addrs[n], "--port", kl_port, "--node-cpu",
                 "5", "--node-memory", "8Gi", "--sync-frequency", "2"],
                f"kubelet {n} serving on")[0]
        _parallel(kubelets, serving, start_kubelet)
        procs.update((f"kubelet {n}", p) for n, p in spawned.items())
        _log(f"     {tag}: {elapsed()} {n_nodes} nodes registered "
             f"({registered_s:.3f} s), {kubelets} labelled role=serving, "
             f"their kubelets serving on port {kl_port}")

        # ---- the addons, the proxy and the binary ------------------------
        for svc in services:
            client.services(svc.metadata.namespace).create(svc)
        dns_port, mon_port, log_port = (_free_port() for _ in range(3))
        procs["proxy"], _s = _hyperkube(
            "phase18a_proxy", "proxy", ["--master", url],
            "kube-proxy running")
        procs["dns"], _s = _hyperkube(
            "phase18a_dns", "dns", ["--master", url, "--port", dns_port],
            "cluster-dns serving")
        procs["monitoring"], _s = _hyperkube(
            "phase18a_monitoring", "monitoring",
            ["--master", url, "--port", mon_port, "--kubelet-port",
             kl_port], "cluster-monitoring on")
        procs["logging"], _s = _spawn(
            "phase18a_logging", "kubernetes_tpu_torch.cmd.logging",
            ["--master", url, "--port", log_port, "--kubelet-port",
             kl_port], "cluster-logging on")
        wait = _waiter(tag, list(procs.values()), result, elapsed, 300.0)
        proxy_pid = procs["proxy"].pid
        wait(lambda: len(_listening_ports(proxy_pid)) == len(services),
             f"the proxy's {len(services)} service ports")
        before = _listening_ports(proxy_pid)
        thread, murl = _start_binary("phase18a", url, dev, wl, result, stop,
                                     ready, wave_size=wave_size)
        wait(lambda: "compile_prewarm_ready 1" in _wait_http(
            murl + "/metrics", None, f"{tag}: the scheduler binary"
        ).splitlines(), "the binary's prewarm", 600.0, poll_s=0.2)
        f = wl.sched.factory
        wait(lambda: len(f.node_store) == n_nodes and len(
            f.service_store) == len(services),
             "the scheduler's caches to hold the cluster")
        _log(f"     {tag}: {elapsed()} proxy, dns, monitoring and logging "
             f"up, the binary warm")

        # ---- the backends behind hostnames ------------------------------
        client.services().create(api.Service(
            metadata=api.ObjectMeta(name="hostnames", namespace="default"),
            spec=api.ServiceSpec(port=80, container_port=0,
                                 selector={"app": "hostnames"})))
        wait(lambda: len(_listening_ports(proxy_pid)) == len(services) + 1,
             "the proxy's port of hostnames")
        (proxy_port,) = _listening_ports(proxy_pid) - before
        ep_poll = _EndpointsPoll(url, "hostnames")
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        port_of = dict(zip(rc_names, ports))
        t_first = time.perf_counter()
        _parallel(4, rc_names, lambda r: client.replication_controllers()
                  .create(_backend_rc(r, port_of[r])))

        def backend_pods() -> dict:
            """rc -> its live pod."""
            out = {}
            for n in pods_w.alive():
                lab = pods_w.labels[n]
                if lab.get("app") == "hostnames":
                    out[lab["rc"]] = n
            return out

        def settled() -> bool:
            pods = backend_pods()
            want = {(n, "127.0.0.1", port_of[r]) for r, n in pods.items()}
            return (len(pods) == backends
                    and all(n in pods_w.running for n in pods.values())
                    and ep_poll.now == want)

        def answering() -> bool:
            """Each backend answers its name on its own port."""
            import socket
            for r, p in port_of.items():
                try:
                    with socket.create_connection(("127.0.0.1", p),
                                                  timeout=2) as s:
                        s.sendall(b"who")
                        if s.recv(64).decode() != r:
                            return False
                except OSError:
                    return False
            return True

        wait(settled, f"{backends} backends Running and in the endpoints",
             progress=lambda: f"{len(backend_pods())} created, {len(
                 set(pods_w.running) & set(backend_pods().values()))} "
                              f"Running, {len(ep_poll.now)} endpoints")
        t_running = time.perf_counter()
        wait(answering, "every backend to answer on its port", 60.0)
        first_pods = backend_pods()
        per_node = {n: len(pods_w.on([n]) & set(first_pods.values()))
                    for n in serving}
        if sum(per_node.values()) != backends:
            raise AssertionError(f"{tag}: backends on {per_node}, not all "
                                 f"on the serving nodes")
        _log(f"     {tag}: {elapsed()} {backends} backends Running on "
             f"{per_node}, the endpoints name each "
             f"({t_running - t_first:.3f} s after the first RC)")

        # ---- the steady soak, the churn, the settled soak ----------------
        steady = _Soak(proxy_port, soak_s, clients).run().join()
        _log(f"     {tag}: {elapsed()} steady soak: {steady}")
        if steady["errors"] or steady["names"] != backends:
            raise AssertionError(f"{tag}: the steady soak had "
                                 f"{steady['errors']} errors "
                                 f"{steady['reasons']} and reached "
                                 f"{steady['names']} of {backends} backends")
        rng = random.Random(18)
        victims = rng.sample(rc_names, rounds * per_round)
        deleted: dict = {}
        soak = _Soak(proxy_port, rounds * period_s, clients).run()
        t_churn = time.perf_counter()
        for k in range(rounds):
            while time.perf_counter() < t_churn + k * period_s:
                time.sleep(0.01)
            pods = backend_pods()
            for r in victims[k * per_round:(k + 1) * per_round]:
                deleted[r] = (pods[r], time.perf_counter())
                client.pods().delete(pods[r])
        churn_rec = soak.join()
        wait(settled, "the replacements Running and in the endpoints",
             progress=lambda: f"{len(ep_poll.now)} endpoints")
        t_settled = time.perf_counter()
        wait(answering, "every backend to answer on its port again", 60.0)
        pods = backend_pods()
        to_replacement = sorted(ep_poll.first[pods[r]] - t_del
                                for r, (_n, t_del) in deleted.items())
        _log(f"     {tag}: {elapsed()} churn: {len(deleted)} deleted, "
             f"{churn_rec['errors']} errors in the window, endpoints name "
             f"each replacement {to_replacement[0]:.3f}-"
             f"{to_replacement[-1]:.3f} s after its delete")
        settled_rec = _Soak(proxy_port, soak_s, clients).run().join()
        _log(f"     {tag}: {elapsed()} settled soak: {settled_rec}")
        if settled_rec["errors"] or settled_rec["names"] != backends:
            raise AssertionError(f"{tag}: the settled soak had "
                                 f"{settled_rec['errors']} errors "
                                 f"{settled_rec['reasons']} and reached "
                                 f"{settled_rec['names']} of {backends} "
                                 f"backends")
        launches = commit_solver.solve_commit.launches
        plain_calls = commit_solver.solve_commit_reference.calls
        svcs = f.service_store.list()
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items

        # ---- logging: every live backend's start line --------------------
        t0 = time.perf_counter()
        live = backend_pods()
        want_lines = {n: f"hostnames backend {r} serving on {port_of[r]}"
                      for r, n in live.items()}
        lurl = (f"http://127.0.0.1:{log_port}/logs?q=hostnames+backend"
                f"&limit=100000")

        def logged() -> bool:
            code, body = _http_get(lurl)
            have = {(e["pod"], e["line"]) for e in json.loads(body)[
                "entries"]} if code == 200 else set()
            return set(want_lines.items()) <= have
        wait(logged, "the logging process to return every start line", 20.0,
             poll_s=0.2)
        logging_s = time.perf_counter() - t0
        agg = LogAggregator(client, fetch=http_kubelet_log_fetcher(kl_port),
                            period_s=3600.0)
        try:
            agg.node_store.replace(client.nodes().list().items)
            agg.pod_store.replace(client.pods("").list().items)
            t0 = time.perf_counter()
            lines = agg.collect_once()
            collect_s = time.perf_counter() - t0
        finally:
            agg._httpd.server_close()

        # ---- monitoring ---------------------------------------------------
        def scraped() -> bool:
            code, body = _http_get(f"http://127.0.0.1:{mon_port}/metrics")
            return code == 200 and (
                _metric_value(body, "cluster_nodes", -1.0) == n_nodes
                and _metric_value(body, "cluster_nodes_scraped", -1.0)
                == kubelets)
        wait(scraped, "the monitoring process to scrape the kubelets", 60.0,
             poll_s=0.5)
        model = json.loads(_http_get(
            f"http://127.0.0.1:{mon_port}/api/v1/model")[1])
        up = sorted(n for n, e in model["nodes"].items() if e["up"])
        if up != serving or len(model["nodes"]) != n_nodes:
            raise AssertionError(f"{tag}: the monitoring model has "
                                 f"{len(model['nodes'])} nodes, up {up}")

        # ---- dns ---------------------------------------------------------
        daddr = ("127.0.0.1", dns_port)
        portal = {s.metadata.name: s.spec.portal_ip
                  for s in client.services().list().items}
        if len(portal) != len(services) + 1:
            raise AssertionError(f"{tag}: {len(portal)} services")
        lat: list = []
        for k in range(10):
            for svc, ip in sorted(portal.items()):
                rcode, got_ip, dt = _dns_query(
                    daddr, f"{svc}.default.cluster.local", txid=k)
                lat.append(dt)
                if rcode != 0 or got_ip != ip:
                    raise AssertionError(f"{tag}: {svc} resolved to "
                                         f"{rcode} {got_ip}, not {ip}")
        if _dns_query(daddr, "ghost.default.cluster.local")[0] != 3:
            raise AssertionError(f"{tag}: an unknown name is not NXDOMAIN")
        gone_svc = services[-1].metadata.name
        client.services().delete(gone_svc)
        t0 = time.perf_counter()
        while _dns_query(daddr, f"{gone_svc}.default.cluster.local")[0] != 3:
            if time.perf_counter() - t0 > 5.0:
                raise AssertionError(f"{tag}: {gone_svc} still resolves 5 s "
                                     f"after its delete")
            time.sleep(0.05)
        nx_s = time.perf_counter() - t0
        lat.sort()
        _log(f"     {tag}: {elapsed()} dns, logging and monitoring checked")
    except BaseException:
        _abort_children(procs.values(), "phase18a")
        raise
    finally:
        if ep_poll is not None:
            ep_poll.stop()
        for w in watches:
            w.stop()
        stop.set()
        if thread is not None:
            thread.join(timeout=60)
        for p in procs.values():
            _stop_process(p)
        killed = _kill_runtime_procs(work)
        left = _runtime_procs_after(work, 10.0)
        shutil.rmtree(work, ignore_errors=True)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the binary returned "
                             f"{result.get('rc')}")
    running = [k for k, p in procs.items() if p.poll() is None]
    if running or left:
        raise AssertionError(f"{tag}: left running: {running}, "
                             f"{len(left)} runtime processes")

    # ---- the checks, after the run -----------------------------------------
    t_check = time.perf_counter()
    gone = {n for n, _t in deleted.values()}
    web = {n for n, lab in pods_w.labels.items()
           if lab.get("app") == "hostnames"}
    by_name = {p.metadata.name: p for p in final}
    lost = [n for n in web if n not in by_name and n not in gone]
    if lost or len(web) != backends + len(gone):
        raise AssertionError(f"{tag}: {len(web)} backend pods seen for "
                             f"{backends} RCs and {len(gone)} deletes, "
                             f"lost {lost[:3]}")
    off = [n for n in web if n not in gone and by_name[n].spec.host
           not in serving]
    if off or pods_w.failed:
        raise AssertionError(f"{tag}: pods off the serving nodes {off[:3]}, "
                             f"Failed {pods_w.failed}")
    _check_placements(final, final_nodes, tag)
    rows = [r for r in wl.rows if r["order"]]
    wide = [len(r["nodes"]) for r in rows if len(r["nodes"]) != n_nodes]
    if wide:
        raise AssertionError(f"{tag}: waves over {wide} nodes, not "
                             f"{n_nodes}")
    checks = _check_waves(rows, final, web, svcs, dev, tag, count_launches,
                          launches, plain_calls, gone=gone)
    restarts = sum(cs.restart_count for p in final
                   if p.metadata.name in web
                   for cs in p.status.container_statuses)
    out = {
        "nodes": n_nodes, "kubelets": kubelets, "backends": backends,
        "kubelet_port": kl_port, "registered_s": registered_s,
        "prewarm_s": wl.sched.prewarm_s, "per_node": per_node,
        "running_s": t_running - t_first,
        "steady": steady, "churn": dict(
            churn_rec, deleted=len(deleted), rounds=rounds,
            per_round=per_round, period_s=period_s,
            to_replacement_s={
                "median": statistics.median(to_replacement),
                "max": to_replacement[-1], "min": to_replacement[0]},
            settled_after_s=t_settled - t_churn),
        "settled": settled_rec, "restarts": restarts,
        "dns": {"queries": len(lat), "p50_s": lat[len(lat) // 2],
                "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                "deleted_nxdomain_s": nx_s},
        "logging": {"all_start_lines_s": logging_s,
                    "collect_pass_s": collect_s, "collect_pass_lines": lines,
                    "nodes": n_nodes},
        "monitoring": {"nodes": len(model["nodes"]), "up": up},
        "kubectl_runs": len(kubectl_s), "killed_at_end": killed,
        "waves": _wave_rows(rows, t_first), "launches": launches,
        "plain_calls": plain_calls, **checks,
        "checks_s": time.perf_counter() - t_check,
        "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"], out["svcs"] = rows, svcs
    return out


def _children(pid: int) -> set:
    """Every live descendant of process ``pid`` (/proc's parent links)."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                rest = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if rest[0] != "Z":
            parent[int(d)] = int(rest[1])
    out, frontier = set(), {pid}
    while frontier:
        frontier = {c for c, p in parent.items() if p in frontier} - out
        out |= frontier
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has an NVIDIA device file open."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


# the fixed ports of kubernetes_tpu_torch/deploy/inventory-up.sh (as of
# cluster/inventory-up.sh:81 and :87-91): each kubelet's, the dns addon's
# (UDP), the monitoring and the logging addons'
_SCRIPT_PORTS = ((10250, "tcp", "kubelet"), (10053, "udp", "dns"),
                 (10251, "tcp", "monitoring"), (10252, "tcp", "logging"))


def _deploy_script_phase(dev, instances=("127.0.1.11", "127.0.1.12"),
                         deadline_s: float = 180.0) -> dict:
    """Phase 18 (b): ``kubernetes_tpu_torch/deploy/inventory-up.sh``
    itself, with bash, on a free apiserver port (and the one above it,
    its kube-store's) and an inventory of one instance at each of
    ``instances``. First the script's fixed ports must be free (the
    kubelets' 10250 on each instance's address, 10053/udp, 10251, 10252
    on 127.0.0.1), else the phase fails naming the port. The script runs
    with ``python`` on its PATH naming this interpreter and ``TMPDIR``
    this phase's directory, under which its kubelets keep their roots.
    Gates: /healthz healthy; both nodes registered with their addresses;
    a pod created by a kubectl process binds through the script's
    ``tpu-batch`` scheduler process, which then holds the card (its
    solve is a kernel launch: on ``cuda``, its default), and reaches
    Running; the dns (an answer), monitoring and logging ports answer;
    the pod deleted by kubectl stops; SIGTERM to the script then leaves
    no process of the script's and none under its runtime roots."""
    import shutil
    import signal
    import subprocess
    import tempfile

    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport

    tag = "phase 18 (b)"
    t_phase = time.perf_counter()
    for port, kind, what in _SCRIPT_PORTS:
        for addr in (instances if what == "kubelet" else ("127.0.0.1",)):
            if not _port_free(addr, port, kind):
                raise AssertionError(f"{tag}: the script's {what} port "
                                     f"{addr}:{port}/{kind} is taken")
    port = next(p for p in reversed(_below_ephemeral()[:-1])
                if _port_free("127.0.0.1", p)
                and _port_free("127.0.0.1", p + 1))
    url = f"http://127.0.0.1:{port}"
    work = os.path.realpath(tempfile.mkdtemp(prefix="phase18b-"))
    names = [f"inst-{k}" for k in range(len(instances))]
    roots = [os.path.join(work, f"ktpu-{n}") for n in names]
    inventory = os.path.join(work, "inventory.json")
    with open(inventory, "w") as fh:
        json.dump({"zone": {"failure_domain": "z0", "region": "local"},
                   "instances": [{"name": n, "addresses": [a], "cpu": "8",
                                  "memory": "16Gi"}
                                 for n, a in zip(names, instances)]}, fh)
    # ``python`` on the script's PATH is this interpreter (a wrapper, not
    # a link: a virtual environment is found next to the path it is run
    # by)
    bindir = os.path.join(work, "bin")
    os.makedirs(bindir)
    with open(os.path.join(bindir, "python"), "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = dict(os.environ, TMPDIR=work,
               PATH=bindir + os.pathsep + os.environ.get("PATH", ""))
    script = os.path.join(_ROOT, "kubernetes_tpu_torch", "deploy",
                          "inventory-up.sh")
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    log_path = os.path.join(_ROOT, "chiprun_out", "phase18b_script.log")
    kubectl_s: list = []
    proc = None
    rec: dict = {"apiserver_port": port}
    try:
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(["bash", script, inventory, str(port)],
                                    cwd=work, env=env, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        t0 = time.perf_counter()

        def wait(cond, what, timeout_s=deadline_s):
            deadline = time.monotonic() + timeout_s
            while not cond():
                if proc.poll() is not None:
                    raise AssertionError(f"{tag}: the script exited "
                                         f"{proc.returncode} waiting for "
                                         f"{what} (chiprun_out/"
                                         f"phase18b_script.log)")
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag}: {what} not within "
                                         f"{timeout_s:.0f} s (chiprun_out/"
                                         f"phase18b_script.log)")
                time.sleep(0.1)

        def healthy() -> bool:
            try:
                code, body = _http_get(url + "/healthz", timeout=2.0)
            except OSError:
                return False
            return code == 200 and json.loads(body).get("healthy") is True
        wait(healthy, "a healthy /healthz")
        rec["healthy_s"] = time.perf_counter() - t0
        client = Client(HTTPTransport(url))

        def registered() -> bool:
            got = {n.metadata.name: [a.address for a in n.status.addresses]
                   for n in client.nodes().list().items}
            return got == {n: [a] for n, a in zip(names, instances)}
        wait(registered, "both nodes registered with their addresses")
        rec["registered_s"] = time.perf_counter() - t0
        kubectl = _kubectl_for(url, work, tag, kubectl_s)
        pod_file = os.path.join(work, "pod.json")
        with open(pod_file, "w") as fh:
            json.dump({"kind": "Pod", "apiVersion": "v1",
                       "metadata": {"name": "hello", "namespace": "default"},
                       "spec": {"containers": [{
                           "name": "hello", "image": "busybox",
                           "command": ["sleep", "3600"],
                           "resources": {"limits": {
                               "cpu": "100m", "memory": "64Mi"}}}]}}, fh)
        t1 = time.perf_counter()
        kubectl("create", "-f", pod_file)

        def pod() -> api.Pod:
            return client.pods().get("hello")
        wait(lambda: pod().spec.host in names, "the pod's bind")
        rec["bind_s"] = time.perf_counter() - t1
        rec["host"] = pod().spec.host
        sched = [p for p in _children(proc.pid) if
                 "kubernetes_tpu_torch.cmd.scheduler" in _cmdline(p)]
        holds = [p for p in sched if _holds_card(p)]
        if len(sched) != 1 or (_device_type(dev) == "cuda" and not holds):
            raise AssertionError(f"{tag}: scheduler processes {sched}, "
                                 f"holding the card {holds}")
        rec["scheduler_holds_card"] = bool(holds)
        wait(lambda: pod().status.phase == api.PodRunning,
             "the pod Running")
        rec["running_s"] = time.perf_counter() - t1
        rcode, _ip, dns_s = _dns_query(("127.0.0.1", 10053),
                                       "kubernetes.default.cluster.local")
        answers = {"dns_rcode": rcode, "dns_s": dns_s}
        for what, p, path in (("monitoring", 10251, "/metrics"),
                              ("logging", 10252, "/healthz")):
            code, _b = _http_get(f"http://127.0.0.1:{p}{path}")
            if code != 200:
                raise AssertionError(f"{tag}: the {what} port answered "
                                     f"{code}")
            answers[what] = code
        rec["addons"] = answers
        kubectl("delete", "pods", "hello")
        wait(lambda: not any(_runtime_procs(r) for r in roots
                             if os.path.isdir(r)),
             "the deleted pod's processes to stop", 60.0)
        kids = _children(proc.pid)
        rec["script_processes"] = len(kids)
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rec["script_rc"] = proc.wait(timeout=60)
        deadline = time.monotonic() + 30.0
        while any(os.path.exists(f"/proc/{k}") and _cmdline(k)
                  for k in kids) and time.monotonic() < deadline:
            time.sleep(0.1)
        rec["teardown_s"] = time.perf_counter() - t2
        left = [k for k in kids if os.path.exists(f"/proc/{k}")
                and _cmdline(k)]
        under = {p for r in roots for p in _runtime_procs(r)}
        if left or under:
            raise AssertionError(f"{tag}: after SIGTERM, left "
                                 f"{[_cmdline(k)[:80] for k in left]}, "
                                 f"{len(under)} under the runtime roots")
    finally:
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
        for r in roots:
            if os.path.isdir(r):
                _kill_runtime_procs(r)
        shutil.rmtree(work, ignore_errors=True)
    rec.update(kubectl_runs=len(kubectl_s),
               phase_s=time.perf_counter() - t_phase)
    return rec


def _log_service(a: dict, b: dict) -> None:
    s, c, z = a["steady"], a["churn"], a["settled"]
    _log(f"[18] (a) the service path: {a['nodes']} inventory nodes "
         f"registered in {a['registered_s']:.3f} s, {a['kubelets']} "
         f"kubelets, {a['backends']} backends Running on {a['per_node']} "
         f"{a['running_s']:.3f} s after the first RC")
    _log(f"     steady soak through kube-proxy: {s['requests']} requests, "
         f"{s['requests_per_s']:.1f} /s, p50 {s['p50_s'] * 1e3:.3f} ms, p99 "
         f"{s['p99_s'] * 1e3:.3f} ms, {s['errors']} errors, {s['names']} "
         f"backends reached")
    _log(f"     churn: {c['deleted']} pods deleted ({c['per_round']} every "
         f"{c['period_s']} s), {c['errors']} errors of {c['requests']} "
         f"requests in the window {c['reasons'][:2]}; endpoints name the "
         f"replacement {c['to_replacement_s']['median']:.3f} s after the "
         f"delete (median, max {c['to_replacement_s']['max']:.3f}); "
         f"{a['restarts']} container restarts")
    _log(f"     settled soak: {z['requests']} requests, "
         f"{z['requests_per_s']:.1f} /s, p50 {z['p50_s'] * 1e3:.3f} ms, p99 "
         f"{z['p99_s'] * 1e3:.3f} ms, {z['errors']} errors, {z['names']} "
         f"backends reached")
    d, lg = a["dns"], a["logging"]
    _log(f"     dns: {d['queries']} queries p50 {d['p50_s'] * 1e3:.3f} ms "
         f"p99 {d['p99_s'] * 1e3:.3f} ms, a deleted service NXDOMAIN after "
         f"{d['deleted_nxdomain_s']:.3f} s; logging: every start line in "
         f"{lg['all_start_lines_s']:.3f} s, one collect pass at "
         f"{lg['nodes']} nodes {lg['collect_pass_s']:.3f} s; monitoring: "
         f"{a['monitoring']['nodes']} nodes, up {a['monitoring']['up']}")
    _log(f"     {len(a['waves'])} waves over {a['nodes']} nodes, "
         f"{a['launches']} commit_solve launches, {a['plain_calls']} "
         f"plain-version calls; every wave == the plain version (max abs "
         f"err {a['max_abs_err']}) and == solve(encode_snapshot); "
         f"{a['killed_at_end']} runtime processes killed at the end; "
         f"phase {a['phase_s']:.1f} s")
    _log(f"     (b) deploy/inventory-up.sh: healthy at "
         f"{b['healthy_s']:.3f} s, 2 nodes registered at "
         f"{b['registered_s']:.3f} s; a kubectl pod bound to {b['host']} "
         f"in {b['bind_s']:.3f} s through the script's tpu-batch scheduler "
         f"(holds the card: {b['scheduler_holds_card']}), Running at "
         f"{b['running_s']:.3f} s; addons {b['addons']}; SIGTERM (rc "
         f"{b['script_rc']}) stopped its {b['script_processes']} processes "
         f"in {b['teardown_s']:.3f} s; phase {b['phase_s']:.1f} s")

# ---- phase 19: the e2e suite driver and the stress harness ---------------

def _logged_batch_schedulers(wl):
    """For the rest of a ``with`` block, every ``BatchScheduler`` that
    starts its loop is recorded by ``wl`` (a ``_WaveLog``) first: the
    scheduler the port's cluster builds inside ``Cluster.start``."""
    import contextlib

    from kubernetes_tpu_torch.scheduler import tpu_batch

    @contextlib.contextmanager
    def scope():
        cls = tpu_batch.BatchScheduler
        run = cls.run

        def run_logged(sched):
            wl(sched)
            return run(sched)
        cls.run = run_logged
        try:
            yield
        finally:
            cls.run = run
    return scope()


def _join_loop(wl, tag: str) -> None:
    """Wait for the recorded scheduler's wave loop to end (the cluster's
    stop only asks it to), so that no wave runs past the counts."""
    sched = wl.sched
    if sched is None:
        raise AssertionError(f"{tag}: the cluster ran no BatchScheduler")
    if not sched.stop(timeout=60):
        raise AssertionError(f"{tag}: the wave loop did not stop")


def _e2e_phase(dev, count_launches: bool = True,
               keep_rows: bool = False) -> dict:
    """Phase 19 (a): an operator's e2e run against a port cluster that
    solves on ``dev``. The port's all-in-one cluster
    (``cmd.standalone.standalone_server`` with ``--nodes 3 --algorithm
    tpu-batch --device``) runs in a thread of this process, and the port's
    e2e driver (``tools/e2e.main`` with ``--master``) runs its nine suites
    at it over HTTP, kubectl as processes. Fails unless every suite
    passes, the cluster stops cleanly, each wave of its scheduler
    launched commit_solve once and the plain version never ran
    (``count_launches``), and each wave equals the plain version and
    ``solve(encode_snapshot(...))`` of the encoder's state with the
    wave's own services. -> each suite's seconds and the wave checks
    (with ``keep_rows``, the waves' ``_WaveLog`` rows too)."""
    import threading

    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.http import HTTPTransport
    from kubernetes_tpu_torch.cmd import standalone
    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.tools import e2e

    tag = "phase 19 (a)"
    t_phase = time.perf_counter()
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    wl = _WaveLog(keep_state=True)
    ready, stop = threading.Event(), threading.Event()
    result: dict = {}
    argv = ["--address", "127.0.0.1", "--port", str(port), "--nodes", "3",
            "--algorithm", "tpu-batch", "--device", _device_type(dev)]
    thread = threading.Thread(
        target=lambda: result.update(rc=standalone.standalone_server(
            argv, ready, stop)), daemon=True, name="phase19-standalone")
    timings: dict = {}
    try:
        with _logged_batch_schedulers(wl):
            thread.start()
            while not ready.wait(0.2):
                if not thread.is_alive():
                    raise AssertionError(f"{tag}: the standalone cluster "
                                         f"exited with {result.get('rc')}")
        _wait_http(url + "/healthz", None, f"{tag}: the standalone cluster")
        up_s = time.perf_counter() - t_phase
        commit_solver.solve_commit.launches = 0
        commit_solver.solve_commit_reference.calls = 0
        t0 = time.perf_counter()
        rc = e2e.main(["--master", url], timings)
        e2e_s = time.perf_counter() - t0
        client = Client(HTTPTransport(url))
        final = client.pods("").list().items
        final_nodes = client.nodes().list().items
    finally:
        stop.set()
        thread.join(timeout=60)
    _join_loop(wl, tag)
    launches = commit_solver.solve_commit.launches
    plain_calls = commit_solver.solve_commit_reference.calls
    if rc != 0 or sorted(timings) != sorted(n for n, _f in e2e.SUITES):
        raise AssertionError(f"{tag}: the e2e driver returned {rc}; suites "
                             f"passed: {sorted(timings)}")
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"{tag}: the standalone cluster returned "
                             f"{result.get('rc')}")

    # ---- the checks, after the run -------------------------------------
    rows = [r for r in wl.rows if r["order"]]
    if not rows:
        raise AssertionError(f"{tag}: no wave placed a pod")
    names = {p.metadata.name for p in final}
    gone = {n for r in rows for n, _h in r["acked"]} - names
    _check_placements(final, final_nodes, tag)
    checks = _check_waves(rows, final, names, None, dev, tag,
                          count_launches, launches, plain_calls, gone=gone)
    out = {"suites_s": timings, "e2e_s": e2e_s, "up_s": up_s,
           "waves": _wave_rows(rows, t0), "launches": launches,
           "plain_calls": plain_calls,
           "pods_placed": sum(len(r["acked"]) for r in rows), **checks,
           "phase_s": time.perf_counter() - t_phase}
    if keep_rows:
        out["rows"] = rows
    return out


def _stress_phase(dev, seconds: float = 15.0, writers: int = 4,
                  count_launches: bool = True) -> dict:
    """Phase 19 (b): the port's stress harness (``tools/stress.run``)
    with the tpu-batch scheduler solving on ``dev``: ``seconds`` of
    ``writers`` writers, the node flapper, the watch-fault injector and
    two readers at a 10 us switch interval. Fails unless the run is CLEAN
    (every survivor bound, a final write accepted, no escaped loop
    exception, no unexpected thread error), the switch interval is back
    where it was, every wave launched commit_solve once, at least one did,
    and the plain version never ran (``count_launches``), and every
    wave's decisions equal the plain version's on the CPU."""
    import io

    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.tools import stress

    tag = "phase 19 (b)"
    t_phase = time.perf_counter()
    wl = _WaveLog()
    out = io.StringIO()
    interval = sys.getswitchinterval()
    commit_solver.solve_commit.launches = 0
    commit_solver.solve_commit_reference.calls = 0
    with _logged_batch_schedulers(wl):
        res = stress.run(seconds=seconds, writers=writers, batch=True,
                         device=_device_type(dev), out=out)
    _join_loop(wl, tag)
    launches = commit_solver.solve_commit.launches
    plain_calls = commit_solver.solve_commit_reference.calls
    run_s = time.perf_counter() - t_phase
    if not res["clean"]:
        raise AssertionError(f"{tag}: the stress run is not CLEAN:\n"
                             f"{out.getvalue()}")
    if res["switch_interval"] != interval \
            or sys.getswitchinterval() != interval:
        raise AssertionError(f"{tag}: the switch interval is "
                             f"{sys.getswitchinterval()}, was {interval}")
    rows = [r for r in wl.rows if r["order"]]
    if count_launches and (launches < 1 or plain_calls
                           or launches != len(rows)
                           or any(r["launches"] != 1 for r in rows)):
        raise AssertionError(f"{tag}: {launches} launches over "
                             f"{len(rows)} waves, {plain_calls} plain calls")
    max_abs_err, plain_check_s = _hold_against_plain(rows, tag)
    return {"seconds": seconds, "writers": writers,
            "verdict": out.getvalue().strip().splitlines()[-1],
            "churned": res["churned"], "survivors": res["survivors"],
            "running": res["running"], "switch_interval": interval,
            "restored": res["switch_interval"], "waves": len(rows),
            "pods_placed": sum(len(r["acked"]) for r in rows),
            "launches": launches, "plain_calls": plain_calls,
            "max_abs_err": max_abs_err, "plain_check_s": plain_check_s,
            "run_s": run_s, "phase_s": time.perf_counter() - t_phase}


def _log_conformance(a: dict, b: dict) -> None:
    suites = ", ".join(f"{n} {t:.3f} s" for n, t in a["suites_s"].items())
    _log(f"[19] (a) the port's e2e driver at the port's standalone "
         f"(3 nodes, tpu-batch on the card, up in {a['up_s']:.3f} s): all "
         f"{len(a['suites_s'])} suites passed in {a['e2e_s']:.3f} s "
         f"({suites})")
    _log(f"     {len(a['waves'])} waves placed {a['pods_placed']} pods, "
         f"{a['launches']} commit_solve launches, {a['plain_calls']} "
         f"plain-version calls; every wave == the plain version (max abs "
         f"err {a['max_abs_err']}) and == solve(encode_snapshot) of the "
         f"encoder's state; phase {a['phase_s']:.1f} s")
    _log(f"     (b) the stress harness, tpu-batch on the card, "
         f"{b['seconds']:.0f} s x {b['writers']} writers: {b['verdict']}; "
         f"{b['survivors']} survivors ({b['running']} Running at the "
         f"verdict), {b['waves']} waves placed {b['pods_placed']} pods, "
         f"{b['launches']} launches, {b['plain_calls']} plain calls, every "
         f"wave == the plain version (max abs err {b['max_abs_err']}); "
         f"switch interval restored to {b['restored']} s; phase "
         f"{b['phase_s']:.1f} s")


# ---- phase 20: the large-cluster domain on the card ------------------------

def _spread_samples(ks=range(15, 24), n_random: int = 1 << 20,
                    seed: int = 2020, chunk: int = 1 << 21):
    """(total, count) int64 numpy pairs beyond the narrow domain, in
    chunks of at most ``chunk``: for each total 2^k - 1, 2^k and 2^k + 1
    (k in ``ks``; 15..23 reach every power of two below 2^24), every count
    0..total; then ``n_random`` seeded pairs, the total uniform in [2^15,
    2^24), the count uniform in [0, total]."""
    import numpy as np

    for k in ks:
        for total in ((1 << k) - 1, 1 << k, (1 << k) + 1):
            for lo in range(0, total + 1, chunk):
                count = np.arange(lo, min(lo + chunk, total + 1),
                                  dtype=np.int64)
                yield np.full_like(count, total), count
    rng = np.random.default_rng(seed)
    for lo in range(0, n_random, chunk):
        n = min(chunk, n_random - lo)
        total = rng.integers(1 << 15, 1 << 24, size=n, dtype=np.int64)
        count = np.minimum((rng.random(n) * (total + 1)).astype(np.int64),
                           total)
        yield total, count


def _f32_spread(total, count):
    """The spread score's float32 expression in numpy (IEEE, as the
    kernel's device function computes it): int(10 * (f32(total - count) /
    f32(total))), 10 at total 0."""
    import numpy as np

    with np.errstate(invalid="ignore", divide="ignore"):
        q = np.float32(total - count) / np.float32(total)
        return np.where(total == 0, 10,
                        (np.float32(10) * q).astype(np.int32))


def _spread_beyond(dev, ks=range(15, 24), n_random: int = 1 << 20) -> dict:
    """Phase 20 (c): the kernel's spread device function (``spread_eval``)
    against the plain version (``ops/kernels.spread_score``, exact int64)
    over ``_spread_samples``. The device function runs only on a card; on
    the CPU the float32 expression it computes (``_f32_spread``) stands
    in."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.ops import commit_solver
    from kubernetes_tpu_torch.ops.kernels import spread_score

    t0 = time.perf_counter()
    pairs = bad = 0
    for total, count in _spread_samples(ks, n_random):
        t = torch.from_numpy(total).to(dev)
        c = torch.from_numpy(count).to(dev)
        want = spread_score(t, c)
        if _device_type(dev) == "cuda":
            got = commit_solver.spread_eval(t.to(torch.int32).contiguous(),
                                            c.to(torch.int32).contiguous())
        else:
            got = torch.from_numpy(_f32_spread(total, count))
        bad += int((got != want).sum())
        pairs += total.size
    if bad:
        raise AssertionError(f"phase 20 (c): {bad} of {pairs} spread pairs "
                             f"beyond 2^15 disagree with the plain version")
    return {"pairs": pairs, "mismatches": 0, "ks": [min(ks), max(ks)],
            "random_pairs": n_random, "seconds": time.perf_counter() - t0}


# (family, seed, nodes, pods, keywords) of phase 20 (d): waves past the
# narrow instances on one axis or more (64, 1,024 groups; 33,000 nodes;
# peer totals past 2^15), through every branch the large instances hold:
# zones, anchors (in dynamic shared memory), gangs, the label planes,
# preemption, int64 planes; both state layouts
_LARGE_CASES = [
    ("ext", 700, 40, 120, dict(n_services=64, anti=2, aff=2, prefs=True,
                               presence=True)),
    ("ext", 701, 40, 150, dict(n_services=64, gangs=True, aff=1, anti=1)),
    ("ext", 702, 60, 1_000, dict(n_services=2_000, aff=1, gangs=True)),
    ("pre", 703, 33_000, 40, dict(n_bands=3, n_services=40, gangs=True,
                                  anti=1, aff=1)),
    ("ext", 704, 50, 80, dict(peers=33_000, anti=1, aff=1)),
    ("ext", 705, 2_000, 60, dict(peers=33_000, gangs=True, prefs=True)),
    ("pre", 706, 40, 60, dict(n_bands=5, n_services=48, gangs=True,
                              anti=1)),
    ("pre", 707, 30, 60, dict(n_bands=4, n_services=40, wide=True,
                              aff=1)),
    ("pre", 709, 40, 60, dict(n_bands=32, peers=33_000, wide=True)),
]


def _second_cluster(instance: str) -> int:
    """The cluster size phase 20 (d) also runs a wave at: 2 blocks where
    the wrapper's instance (``commit_solver.instance_of``) took more, else
    4."""
    return 2 if int(re.search(r",c(\d+)>$", instance).group(1)) > 2 else 4


def _large_fuzz(dev, cases=None) -> dict:
    """Phase 20 (d): seeded waves of ``_LARGE_CASES``, each in the
    kernel's domain and past the one-block instances, kernel == plain
    version bit for bit, at the wrapper's cluster size and at
    ``_second_cluster``'s. ``cases`` defaults to ``_LARGE_CASES`` (a CPU
    run passes smaller ones)."""
    import torch

    from kubernetes_tpu_torch.models.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import commit_solver

    t0 = time.perf_counter()
    seen = {"instances": {}, "pods": 0, "rolled_back_runs": 0,
            "preempting": 0, "waves": []}
    for family, seed, n_nodes, n_pods, kw in cases or _LARGE_CASES:
        kw = dict(kw)
        if family == "ext":
            wave, policy = _ext_wave(random.Random(seed), n_nodes, n_pods,
                                     **kw)
        else:
            wave, policy = _pre_wave(random.Random(seed), n_nodes, n_pods,
                                     kw.pop("n_bands"), **kw)
        snap = encode_snapshot(*wave, policy=policy)
        ci = _inputs(snap, dev)
        N, G = ci.cap.shape[1], ci.counts0.shape[0]
        if not commit_solver.is_large(N, G, ci.count_bytes):
            raise AssertionError(f"phase 20 (d) seed {seed}: not a large "
                                 f"wave (N={N} G={G} "
                                 f"{8 * ci.count_bytes}-bit counts)")
        name = commit_solver.instance_of(ci)
        second = _second_cluster(name)
        want = commit_solver.solve_commit_reference(ci)
        for cluster in (None, second):
            got = commit_solver.solve_commit(ci, _cluster=cluster)
            took = commit_solver.instance_of(ci, cluster=cluster)
            seen["instances"][took] = seen["instances"].get(took, 0) + 1
            for g, w, what in zip(got, want, ("chosen", "win")):
                if not torch.equal(g, w):
                    i = int((g != w).nonzero()[0])
                    raise AssertionError(
                        f"phase 20 (d) seed {seed} {family} {kw} on "
                        f"{took}: {what} differs at pod {i}: kernel "
                        f"{int(g[i])} vs plain {int(w[i])}")
        chosen = want[0].cpu().numpy()
        if snap.has_gangs:
            seen["rolled_back_runs"] += _rolled_back_runs(snap.pod_rid,
                                                          chosen)
        seen["preempting"] += int((want[1] <= -2).sum())
        seen["pods"] += len(snap.pod_names)
        seen["waves"].append({"seed": seed, "nodes": N, "groups": G,
                              "count_bytes": ci.count_bytes,
                              "bands": ci.band.shape[0],
                              "instance": name, "second_cluster": second,
                              "placed": int((chosen >= 0).sum())})
    seen["seconds"] = time.perf_counter() - t0
    return seen


def _large_phase(dev, shapes=("planet", "services64"), kernel_runs=3,
                 sizes=None, loop_nodes=40_000, loop_waves=3,
                 wave_size=1_024, spread_ks=range(15, 24),
                 spread_random=1 << 20, large_cases=None,
                 count_launches=True) -> dict:
    """Phase 20: the kernel's cluster instances on the main paths. (a)
    each of ``shapes`` (models/fixtures: ``planet``, 40,000 nodes and
    40,000 peers a service; ``services64``, 64 service groups) through
    ``solve``, one launch of a cluster instance, bit-identical to the
    plain version on the card, with its kernel time, cluster size, layout
    and bound; (b) the
    scheduler's loop (phase 7's driver) on the planet cluster, waves of
    ``wave_size``, each launching commit_solve once and held as phase 7
    holds its waves, the plain version never run; (c) the spread device
    function beyond 2^15 (``_spread_beyond``); (d) seeded large waves
    through every branch at two cluster sizes (``_large_fuzz``).
    ``sizes`` maps a shape to (nodes, pods) for a CPU run."""
    from kubernetes_tpu_torch.ops import commit_solver

    tag = "phase 20"
    t_phase = time.perf_counter()
    out: dict = {"waves": {}}
    for name in shapes:
        w = _wave_phase(name, dev, kernel_runs, size=(sizes or {}).get(name),
                        count_launches=count_launches)
        if count_launches and not w["instance"].startswith(
                "commit_solve_large<"):
            raise AssertionError(f"{tag} (a) {name}: took {w['instance']}, "
                                 f"not a large instance")
        out["waves"][name] = w
    t0 = time.perf_counter()
    # the instances the loop's waves launch, apart from (a)'s
    launched = commit_solver.solve_commit.instances
    before = set(launched)
    launched.clear()
    try:
        sc = _scheduler_phase(dev, n_nodes=loop_nodes,
                              n_pending=loop_waves * wave_size, n_churn=0,
                              n_deleted=0, n_last=0, wave_size=wave_size,
                              plain_wave=1, count_launches=count_launches,
                              n_services=2, churn=False, plain_device=dev)
        sc["instances"] = sorted(launched)
    finally:
        launched.update(before)
    if len(sc["waves"]) != loop_waves:
        raise AssertionError(f"{tag} (b): {len(sc['waves'])} waves, want "
                             f"{loop_waves}")
    # the driver raised unless every wave's bindings were equal
    sc["max_abs_err"] = 0
    sc["seconds"] = time.perf_counter() - t0
    out["loop"] = sc
    out["spread"] = _spread_beyond(dev, spread_ks, spread_random)
    out["seeded"] = sd = _large_fuzz(dev, large_cases)
    for layout in ("shared", "global"):
        if count_launches and not any(f",{layout}," in k
                                      for k in sd["instances"]):
            raise AssertionError(f"{tag} (d): no seeded wave kept its "
                                 f"slices in {layout} memory "
                                 f"({sorted(sd['instances'])})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _log_large(lg: dict, ptxas: dict) -> None:
    for tag, (name, w) in zip(("20 (a)", "      "), lg["waves"].items()):
        _log(f"[{tag}] {name} {w['nodes']}x{w['pods']}: {w['groups']} "
             f"groups, peer bound {w['peer_bound']}, "
             f"{8 * w['count_bytes']}-bit counts, {w['instance']}: a "
             f"cluster of {w['instance'].rsplit(',c', 1)[-1][:-1]} blocks, "
             f"slices in {w['layout']} memory ({w['dyn_shared_bytes']} B "
             f"dynamic shared a block), launches {w['launches']}, bound "
             f"{w['bound_pods']}, "
             f"encode {w['encode_s']:.3f}s, wave {w['wave_s']:.3f}s "
             f"({w['pods_per_s']:.1f} pods/s), kernel "
             f"{w['kernel_ms']:.3f} ms (runs "
             f"{[round(t, 3) for t in w['kernel_ms_runs']]}), plain "
             f"{w['plain_ms']:.1f} ms (max abs err {w['max_abs_err']}), "
             f"bound {w['bound_ms']:.4f} ms ({w['bound_by']})")
        _log(f"       ptxas: {_ptxas_of(ptxas, w['instance'])}")
    sc = lg["loop"]
    _log(f"[20 (b)] the loop on the planet cluster: {sc['nodes']} nodes, "
         f"{sc['existing']} existing, {sc['pending']} pending in waves of "
         f"{sc['wave_size']}: {len(sc['waves'])} waves, {sc['launches']} "
         f"commit_solve launches ({', '.join(sc['instances'])}), 0 plain "
         f"calls; loop {sc['loop_pods_per_s']:.1f} pods/s "
         f"({sc['loop_s']:.3f} s); encode paths "
         f"{[w['path'] for w in sc['waves']]}, each wave == "
         f"solve(encode_snapshot(...)) on the card, wave "
         f"{sc['plain_wave']} == the plain version on "
         f"{sc['plain_device']} ({sc['plain_s']:.1f} s); "
         f"{sc['seconds']:.1f} s")
    sp = lg["spread"]
    _log(f"[20 (c)] spread device function == plain version on "
         f"{sp['pairs']} pairs beyond 2^15 (every count of totals 2^k-1, "
         f"2^k, 2^k+1 for k = {sp['ks'][0]}..{sp['ks'][1]}, and "
         f"{sp['random_pairs']} seeded pairs below 2^24; "
         f"{sp['seconds']:.2f}s)")
    sd = lg["seeded"]
    _log(f"[20 (d)] {len(sd['waves'])} seeded large waves ({sd['pods']} "
         f"pods; {sd['rolled_back_runs']} gang runs rolled back, "
         f"{sd['preempting']} pods placed by preemption; each at the "
         f"wrapper's cluster size and at a second (2 blocks, else 4); "
         f"instances {sd['instances']}): kernel == plain version "
         f"({sd['seconds']:.2f}s); phase {lg['phase_s']:.1f} s")


def _freeze_heap() -> None:
    """Collect what the phases before left, then move every survivor to
    the collector's permanent generation: a full collection in a later
    phase walks only what that phase made. (Phases 15 and 16 paused
    8-9 s each in full collections of the whole heap, every thread of
    this process stopped, the in-process scheduler's among them.)"""
    import gc

    gc.collect()
    gc.freeze()


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
    record["ptxas_reference"] = _ptxas_against_reference(record["ptxas"])
    _log(f"    ptxas: {record['ptxas_reference']}")
    _static_smem_within_reserve(record["ptxas"])

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

    # 4d. the batched launch: sixteen waves of six families, one call
    record["batched"] = bt = _batch_phase(dev)
    _log(f"[4d] {len(bt['waves'])} seeded waves in {bt['groups']} padded "
         f"groups, one solve_commit_batch: {bt['launches']} launches for "
         f"{bt['launch_keys']} launch keys; every wave == plain version == "
         f"its own unpadded launch (max abs err {bt['max_abs_err']}, "
         f"{bt['seconds']:.2f}s)")
    for name, g in bt["taken"].items():
        _log(f"     group {name}: {g['waves']} waves, {g['instance']}, "
             f"state in {g['layout']} memory, {g['state_bytes']} B a wave")
    for w in bt["waves"]:
        _log(f"     {w['family']} ({w['group']}): {w['nodes']}x{w['pods']} "
             f"padded to {w['padded_nodes']}x{w['padded_pods']}, "
             f"{w['padded_groups']} groups, {w['resource_type']}, "
             f"{w['bands']} bands, {w['placed']} placed")

    # 5. north_star, the main path
    ns = _wave_phase("north_star", dev, kernel_runs=7, reencode=True)
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

    _freeze_heap()
    # 7. the scheduler's wave loop at north_star width
    sc = _scheduler_phase(dev)
    record["scheduler"] = sc
    _log_scheduler(sc)

    _freeze_heap()
    # 7p. the pipelined loop against the causal loop at north_star width
    record["pipeline"] = pp = _pipeline_phase(dev)
    _log_pipeline(pp)

    _freeze_heap()
    # 7e. the unschedulability diagnosis on the card against the CPU
    record["explain"] = _explain_phase(dev)
    _log_explain(record["explain"])

    _freeze_heap()
    # 8. the loop on the priority cluster: preemption with evict+bind
    record["priority_loop"] = pl = _preempt_loop_phase(dev)
    _log_preempt_loop(pl)

    # Phases 9, 9c, 10b, 11, 12, 14 (a), 15, 16, 18 (a) and 19 (b) run
    # below their functions' default depths (pending pods; phase 11's
    # compared pods; phase 15's replicas; phase 16's legacy pods, RC and
    # cordons; phase 18 (a)'s backends, soaks and churn rounds; phase 19
    # (b)'s seconds), so that phases 15-20 fit in the script's time limit
    # with room for a slower host.

    _freeze_heap()
    # 9. the scheduler binary against an apiserver process, over HTTP
    record["binary"] = bp = _binary_phase(dev, n_pending=1_000)
    _log_binary(bp)

    _freeze_heap()
    # 9b. the binary's fallback to the serial scheduler
    record["fallback"] = _fallback_phase(dev)
    _log_fallback(record["fallback"])

    _freeze_heap()
    # 9c. the binary with the pipelined loop, tracing and the recorder
    record["pipeline_binary"] = _pipeline_binary_phase(dev, n_pending=1_000)
    _log_pipeline_binary(record["pipeline_binary"])

    _freeze_heap()
    # 10. the solver daemon: four clients coalescing at north_star width
    record["daemon"] = dm = _daemon_phase(dev)
    _log_daemon(dm)

    _freeze_heap()
    # 10b. the scheduler binary through a solver daemon process
    record["daemon_binary"] = _daemon_binary_phase(dev, n_pending=1_000)
    _log_daemon_binary(record["daemon_binary"])

    _freeze_heap()
    # 11. the serial oracle against the kernel's decisions
    record["oracle"] = _oracle_phase(dev, ns_pods=64, n_extra=64)
    _log_oracle(record["oracle"])

    _freeze_heap()
    # 12. the binaries under KTPU_RACE=1 and KTPU_DEBUG=1
    record["race"] = _race_binary_phase(dev, n_pending=500, n_deleted=50,
                                        n_added=100)
    _log_race_binary(record["race"])

    _freeze_heap()
    # 13. the device mesh: four node shards on this card
    record["mesh"] = ms = _mesh_phase(dev)
    _log_mesh(ms)

    _freeze_heap()
    # 14. the fleet: a kube-store and two apiserver workers killed under
    # the binary's load; then a durable apiserver alone, killed
    fl, du = _fleet_phase(dev, n_pending=1_000), _durable_phase(dev)
    record["fleet"] = {"store_and_workers": fl, "durable_apiserver": du}
    _log_fleet(fl, du)

    _freeze_heap()
    # 15. the controller manager and the inventory cloud feeding the card
    record["controllers"] = cm = _controller_phase(
        dev, apps=4, replicas=50, scale=(("rc-0-1", 30), ("rc-1-1", 150)))
    _log_controller(cm)

    _freeze_heap()
    # 16. an operator's kubectl session, in the legacy wire, feeding it
    record["kubectl"] = kc = _kubectl_phase(dev, n_legacy=300,
                                            web=(100, 200), n_cordon=25)
    _log_kubectl(kc)

    _freeze_heap()
    # 17. kubectl drain through the descheduler at the fragment storm's
    # width; kubelets running the pods the card placed, and a drain
    da, kb = _descheduler_phase(dev), _kubelet_phase(dev)
    record["descheduler"] = {"drain": da, "kubelets": kb}
    _log_descheduler(da, kb)

    _freeze_heap()
    # 18. the service path through kube-proxy to backends the card placed,
    # with the dns, logging and monitoring addons; the deploy script
    sa, sb = (_service_phase(dev, backends=60, churn=(2, 12, 5.0),
                             soak_s=5.0),
              _deploy_script_phase(dev))
    record["service"] = {"path": sa, "deploy_script": sb}
    _log_service(sa, sb)

    _freeze_heap()
    # 19. the conformance tools: the e2e suites against a port cluster
    # solving on the card; the stress harness with the card's scheduler
    ea, eb = _e2e_phase(dev), _stress_phase(dev, seconds=8.0)
    record["conformance"] = {"e2e": ea, "stress": eb}
    _log_conformance(ea, eb)

    _freeze_heap()
    # 20. the large-cluster domain: planet and services64 through solve,
    # the loop at planet width, the spread function past 2^15, and seeded
    # large waves through every branch
    record["large"] = lg = _large_phase(dev)
    _log_large(lg, record["ptxas"])
    record["total_s"] = time.perf_counter() - t_start

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)

    # one entry per instance family the main paths run: the int32 default
    # branch (times from north_star's wave; launches over the scheduler
    # binary's load window, whose waves are held against the plain version
    # too, so max_abs_err covers both), the int64 instances (north_star_dec) and the preemption
    # branch (priority, launches over the priority loop); no PyTorch call
    # computes the sequential commit, so library_ms is null
    # The batched launch (one block per coalesced wave) times k = 4 of
    # phase 10's first-round waves against their plain versions, with the
    # launches of several waves over the daemon's run; its bound is the 4
    # waves' bounds.
    batched = {"kernel_ms": dm["batch_ms"][dm["batch_k"]],
               "plain_ms": dm["batch_plain_ms"],
               "bound_ms": dm["batch_bound_ms"],
               "bound_by": dm["batch_bound_by"],
               "max_abs_err": max(dm["max_abs_err"], bt["max_abs_err"])}
    # The default entry's launches include phase 13 (b)'s (the mesh
    # crossover's one launch through solve(snap, mesh=)), phase 14's (one
    # a wave of the binary against the fleet and the durable apiserver),
    # phase 15's (one a wave of the RCs' pods), phase 16's (one a wave
    # of the kubectl session's pods), phase 17's (one a wave of the
    # pods held pending for the descheduler, and of the kubelets' RC) and
    # phase 18 (a)'s (one a wave of the hostnames backends and their
    # replacements) and phase 19's (one a wave of the e2e suites' pods,
    # and of the stress harness's), each wave held against the plain
    # version too.
    entries = (("commit_solve", dict(ns, max_abs_err=max(
                    ns["max_abs_err"], bp["max_abs_err"], fl["max_abs_err"],
                    du["max_abs_err"], cm["max_abs_err"],
                    kc["max_abs_err"], da["max_abs_err"],
                    kb["max_abs_err"], sa["max_abs_err"],
                    ea["max_abs_err"], eb["max_abs_err"])),
                bp["launches"] + ms["launches"] + fl["launches"]
                + du["launches"] + cm["launches"] + kc["launches"]
                + da["launches"] + kb["launches"] + sa["launches"]
                + ea["launches"] + eb["launches"]),
               ("commit_solve[int64 planes]", record["north_star_dec"],
                record["north_star_dec"]["launches"]),
               ("commit_solve[preemption]", record["priority"],
                sum(w["launches"] for w in pl["waves"])),
               ("commit_solve[batched]", batched, dm["batched_launches"]),
               # the cluster instances (phase 20): planet's with int32
               # counts over 40,000 nodes (its wave in (a) and the loop's
               # waves in (b), each held against the plain version too),
               # services64's with 64 groups
               ("commit_solve[large: planet]",
                dict(lg["waves"]["planet"], max_abs_err=max(
                    lg["waves"]["planet"]["max_abs_err"],
                    lg["loop"]["max_abs_err"])),
                lg["waves"]["planet"]["launches"] + lg["loop"]["launches"]),
               ("commit_solve[large: services64]", lg["waves"]["services64"],
                lg["waves"]["services64"]["launches"]))
    kernels = {"kernels": [{
        "name": name, "route": "cuda",
        "source": ("kubernetes_tpu_torch/ops/csrc/commit_solve_cluster.cuh"
                   if name.startswith("commit_solve[large")
                   else "kubernetes_tpu_torch/ops/csrc/commit_solve.cuh"),
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
