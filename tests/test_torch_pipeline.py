"""The port's pipelined (speculative double-buffered) wave loop against its
causal loop and against the JAX package's pipelined loop, on the CPU.

The five cases of tests/test_pipeline.py: a pre-created backlog (12
nodes, 384 pods, or 24 gangs of 4) drains through the port's
``BatchScheduler(pipeline=True)`` on the JAX package's apiserver
(``Master``, reached through the test-only transport of
tests/test_torch_tpu_batch.py that converts objects between the two
packages). Divergence is injected identically in every run through the
loop's own seams: the binder for a CAS-lost bind, the solve for a
mid-solve foreign bind. The final pod -> node maps must be equal, pod for
pod, to the port's causal loop under the same injection and to the JAX
package's pipelined loop (tests/test_pipeline.run_stack) on the same
backlog (tolerance 0: placements are names), and the
``scheduler_pipeline_*`` counters show which path each run took.
"""

import time

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from kubernetes_tpu.apiserver.master import Master
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.scheduler.driver import PodBackoff as RefPodBackoff
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.client.client import Client as PortClient
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler.tpu_batch import (BatchScheduler,
                                                      _pipeline_metrics)
from test_pipeline import (N_NODES, N_PODS, WAVE, _FailOnceBinder,
                           _InjectingSolver, mk_node, mk_pod, run_stack)
from test_torch_policy import to_port
from test_torch_tpu_batch import _BridgeTransport

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def _pipe_counts():
    pm = _pipeline_metrics()
    return {"hits": pm.hits.value(), "inval": pm.invalidations.by_label(),
            "overlap": pm.overlap.value(), "waves": pm.waves.value()}


def _pipe_delta(before):
    now = _pipe_counts()
    inval = {}
    for k, v in now["inval"].items():
        d = v - before["inval"].get(k, 0.0)
        if d:
            inval[k[0] if k else ""] = d
    return {"hits": now["hits"] - before["hits"], "inval": inval,
            "overlap": now["overlap"] - before["overlap"],
            "waves": now["waves"] - before["waves"]}


class _InjectOnce:
    """The port's twin of test_pipeline._InjectingSolver: the FIRST
    wave's solve lands a foreign assigned pod (another scheduler's bind,
    as the reflector would deliver it) in the scheduled store before the
    solve runs. The wave's snapshot is already encoded, so its decisions
    predate the delta in both loops; the next wave must account for it."""

    def __init__(self, sched, factory):
        self.inner, self.factory = sched._solve_snap, factory
        self.injected = 0
        sched._solve_snap = self

    def __call__(self, snap, n_pending, tctx=None):
        if self.injected == 0:
            self.injected += 1
            foreign = to_port(mk_pod(0, prefix="foreign-"))
            foreign.spec.containers[0].resources.limits["cpu"] = \
                PortQuantity("32")
            foreign.spec.host = foreign.status.host = "n000"
            self.factory.scheduled_pods.add(foreign)
        return self.inner(snap, n_pending, tctx)


def port_stack(pipeline, pods=None, wave=WAVE, binder_wrap=None,
               inject=False, backoff=None, timeout=60.0):
    """The port's loop over a fresh Master holding N_NODES nodes and the
    backlog ``pods`` (JAX-package objects; N_PODS plain pods by default),
    fully synced before the first drain so wave k is exactly the k-th
    slice of the backlog. -> the final {pod name: host} map."""
    pods = pods if pods is not None else [mk_pod(i) for i in range(N_PODS)]
    client = PortClient(_BridgeTransport(Master()))
    for i in range(N_NODES):
        client.nodes().create(to_port(mk_node(i)))
    for p in pods:
        client.pods().create(to_port(p))
    factory = port_driver.ConfigFactory(client, node_poll_period=1.0)
    if backoff is not None:
        factory.backoff = backoff
    config = factory.create(pipeline=pipeline)
    if binder_wrap is not None:
        config.binder = binder_wrap(config.binder)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if len(factory.pod_queue.list()) >= len(pods) and \
                len(factory.node_store.list()) >= N_NODES:
            break
        time.sleep(0.02)
    else:
        pytest.fail("reflectors never synced the backlog")
    sched = BatchScheduler(config, factory, client, wave_size=wave,
                           wave_linger_s=0.02, device="cpu")
    assert sched.pipeline is pipeline
    if inject:
        _InjectOnce(sched, factory)
    sched.run()
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(p.spec.host for p in client.pods().list().items):
                break
            time.sleep(0.05)
        placements = {p.metadata.name: p.spec.host
                      for p in client.pods().list().items}
        assert all(placements.values()), \
            f"{sum(1 for h in placements.values() if not h)} pods never bound"
        assert sched.fault is None
        return placements
    finally:
        assert sched.stop(timeout=10.0)
        assert factory.stop(join=True)


def test_speculation_hit_fast_path_bit_identical():
    """Clean backlog: every speculation verifies (hits, no
    invalidations), and the placements equal the port's causal loop's and
    the JAX package's pipelined loop's."""
    causal = port_stack(pipeline=False)
    before = _pipe_counts()
    piped = port_stack(pipeline=True)
    d = _pipe_delta(before)
    assert piped == causal == run_stack(pipeline=True)
    assert d["hits"] >= 1, d
    assert not d["inval"], d
    assert d["overlap"] > 0.0, d
    assert d["waves"] == N_PODS // WAVE, d


def test_cas_lost_bind_invalidates_and_requeues_bit_identical():
    """A CAS-lost bind in wave 1 while wave 2's speculation is in flight:
    the speculation invalidates (bind_failed), wave 2 re-encodes, and the
    whole run — the loser's requeue placement included — equals the
    causal loop and the JAX package's pipelined loop under the same
    injection."""
    victim = "p00005"
    causal = port_stack(
        pipeline=False,
        backoff=port_driver.PodBackoff(initial=2.0, max_duration=4.0),
        binder_wrap=lambda b: _FailOnceBinder(b, victim))
    before = _pipe_counts()
    piped = port_stack(
        pipeline=True,
        backoff=port_driver.PodBackoff(initial=2.0, max_duration=4.0),
        binder_wrap=lambda b: _FailOnceBinder(b, victim))
    d = _pipe_delta(before)
    ref = run_stack(pipeline=True,
                    backoff=RefPodBackoff(initial=2.0, max_duration=4.0),
                    binder_wrap=lambda b: _FailOnceBinder(b, victim))
    assert piped == causal == ref
    assert piped[victim]
    assert d["inval"].get("bind_failed", 0) >= 1, d


def test_mid_solve_store_delta_invalidates_bit_identical():
    causal = port_stack(pipeline=False, inject=True)
    before = _pipe_counts()
    piped = port_stack(pipeline=True, inject=True)
    d = _pipe_delta(before)
    assert piped == causal == run_stack(pipeline=True,
                                        solver_wrap=_InjectingSolver)
    assert d["inval"].get("store_delta", 0) >= 1, d


def test_gang_waves_skip_speculation_but_schedule_bit_identical():
    """Waves carrying gang members never speculate; the pipelined loop
    encodes them causally and places every group all or nothing, as the
    causal loop does."""
    def gang_pods():
        pods = []
        for g in range(24):
            for m in range(4):
                p = mk_pod(g * 4 + m, prefix="g")
                p.metadata.annotations = {
                    ref_gang.GANG_NAME_ANNOTATION: f"group-{g:03d}",
                    ref_gang.GANG_MIN_MEMBERS_ANNOTATION: "4"}
                pods.append(p)
        return pods

    causal = port_stack(pipeline=False, pods=gang_pods(), wave=32)
    before = _pipe_counts()
    piped = port_stack(pipeline=True, pods=gang_pods(), wave=32)
    d = _pipe_delta(before)
    assert all(causal.values()) and piped == causal
    assert d["hits"] == 0 and not d["inval"], d


def test_full_encoder_policy_falls_back_to_the_causal_loop(caplog):
    """A CheckServiceAffinity policy forces the full encoder, which cannot
    speculate: ``pipeline=True`` logs the fall-back and runs the causal
    loop, as the reference's ``_loop`` does, and the backlog binds."""
    import json
    import logging

    from kubernetes_tpu_torch.scheduler.plugins import load_policy
    from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster

    policy = load_policy(json.dumps({
        "predicates": [{"name": "PodFitsResources"},
                       {"name": "region", "argument": {
                           "serviceAffinity": {"labels": ["region"]}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}))
    nodes = [to_port(mk_node(i)) for i in range(4)]
    for i, n in enumerate(nodes):
        n.metadata.labels = {"region": f"r{i % 2}"}
    cluster = FakeCluster(nodes, [], [to_port(mk_pod(i)) for i in range(8)],
                          [])
    factory = port_driver.ConfigFactory(cluster.client, node_poll_period=3600)
    cluster.attach(factory)
    sched = BatchScheduler(factory.create(policy=policy, pipeline=True),
                           factory, cluster.client, wave_size=4,
                           wave_linger_s=0.01, device="cpu")
    before = _pipe_counts()
    try:
        assert sched.pipeline and sched._encoder is None
        cluster.wait_synced()
        with caplog.at_level(logging.WARNING):
            sched.run()
            deadline = time.monotonic() + 15
            while len(cluster.bind_log) < 8:
                assert time.monotonic() < deadline, len(cluster.bind_log)
                time.sleep(0.01)
    finally:
        assert sched.stop(timeout=5.0)
        assert factory.stop(join=True)
    assert "falling back to the causal wave loop" in caplog.text
    assert _pipe_delta(before)["waves"] == 0


def test_encoder_speculation_helpers_roundtrip():
    """forget_pods is the exact inverse of a speculative upsert, has_pod
    says what is resident, and is_noop_upsert classifies re-deliveries."""
    nodes = [to_port(mk_node(i)) for i in range(4)]
    pods = [to_port(mk_pod(i)) for i in range(8)]
    enc = IncrementalEncoder()
    enc.encode(nodes, [], pods[:4])
    used0 = enc._score_used.copy()

    assumed = []
    for j, host in ((0, "n000"), (1, "n002")):
        cl = to_port(mk_pod(100 + j))
        cl.spec.host = cl.status.host = host
        assumed.append(cl)
    assert not enc.has_pod(assumed[0].metadata.uid)
    assert enc.encode_delta(nodes, assumed, [], pods[4:8]) is not None
    assert enc.has_pod(assumed[0].metadata.uid)
    assert enc.is_noop_upsert(assumed[0])         # re-delivery: benign
    moved = to_port(mk_pod(100))
    moved.spec.host = moved.status.host = "n001"
    assert not enc.is_noop_upsert(moved)          # host changed: real delta

    enc.forget_pods([p.metadata.uid for p in assumed])
    assert not enc.has_pod(assumed[0].metadata.uid)
    assert np.array_equal(enc._score_used, used0)


def test_chip_smoke_pipeline_phases_run_on_the_cpu_at_a_small_size():
    """chip_smoke's phases 7p, 7e and 9c at 40 nodes on the plain version
    (launches are not counted: no kernel runs here): the loops' pairs
    place alike, the clean pipelined run hits and the injected one
    invalidates on store_delta, the diagnosis is equal on both devices,
    and the pipelined binary binds, events the breakdown, traces and
    samples."""
    import chip_smoke

    pp = chip_smoke._pipeline_phase("cpu", n_nodes=40, n_pending=300,
                                    wave_size=32, count_launches=False)
    runs = pp["runs"]
    assert runs["pipelined"]["hits"] >= 1
    assert runs["pipelined_injected"]["invalidations"]["store_delta"] >= 1
    assert runs["pipelined_injected"]["discarded"] >= 1
    assert all(r["bound"] == 300 for r in runs.values())
    ex = chip_smoke._explain_phase("cpu", n_nodes=40, n_pending=300)
    assert ex["diagnosed"] >= 256
    b = chip_smoke._pipeline_binary_phase("cpu", n_nodes=40, n_pending=300,
                                          seeders=4, creators=2,
                                          count_launches=False)
    assert b["waves"] >= 1 and b["stages"]["speculative_encodes"] >= 1
    assert set(b["events"]) == {"big", "nosel"}


def test_loop_time_tool_alternates_both_loops_on_the_cpu(tmp_path,
                                                         monkeypatch, capsys):
    """tools/loop_time.py at 40 nodes: one pair, each loop once, every run
    placing every pod alike; its record names both loops' pods/s."""
    import json

    from kubernetes_tpu_torch.tools import loop_time

    monkeypatch.chdir(tmp_path)
    assert loop_time.main(["--pairs", "1", "--nodes", "40", "--pending",
                           "300", "--wave-size", "32", "--device",
                           "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pairs"] == 1 and out["device"] == "cpu"
    assert len(out["loops"]["causal"]["runs"]) == 1
    assert len(out["loops"]["pipelined"]["runs"]) == 1
    rec = json.loads((tmp_path / "chiprun_out" / "loop_time.json")
                     .read_text())
    assert [r["pipeline"] for r in rec["runs"]] == [False, True]
    assert rec["runs"][1]["hits"] >= 1
