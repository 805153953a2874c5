"""The port's kube-explain (kubernetes_tpu_torch/models/explain.py) against
the JAX package's, on the CPU.

Every fixture of tests/test_explain.py, built once through the JAX
package's API types and converted field for field to the port's: the
port's ``explain_wave`` (torch ops on the CPU) must be count-identical to
the reference's ``explain_wave`` and to the serial twin
``oracle.explain_serial``, over the full and the incremental encoders,
and its FailedScheduling lines equal string for string (tolerance 0:
counts are integers). Then the message goldens, the Explainer's
off-hot-path guard and metric sums, and both of the port's wave loops
(causal and pipelined) writing the breakdown line into the event.
"""

import random
import threading
import time

import jax

jax.config.update("jax_enable_x64", True)

import pytest
import torch

from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.quantity import Quantity
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models import explain as ref_explain
from kubernetes_tpu.models.incremental import \
    IncrementalEncoder as RefIncrementalEncoder
from kubernetes_tpu.models.oracle import explain_serial
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import explain
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from kubernetes_tpu_torch.util import metrics
from test_torch_policy import to_port

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def mknode(i, cpu="1", mem="8Gi", labels=None):
    return ref_api.Node(
        metadata=ref_api.ObjectMeta(name=f"n{i:03d}", labels=labels or {}),
        spec=ref_api.NodeSpec(capacity={"cpu": Quantity(cpu),
                                        "memory": Quantity(mem)}))


def mkpod(name, mcpu=500, host="", prio=0, can=True, port=0, ns="default",
          sel=None, pin="", pd=""):
    api = ref_api
    ports = [api.ContainerPort(container_port=80, host_port=port)] \
        if port else []
    vols = [api.Volume(name="v", source=api.VolumeSource(
        gce_persistent_disk=api.GCEPersistentDiskVolumeSource(
            pd_name=pd)))] if pd else []
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace=ns, uid=f"uid-{name}"),
        spec=api.PodSpec(
            containers=[api.Container(
                name="c", image="i", ports=ports,
                resources=api.ResourceRequirements(limits={
                    "cpu": Quantity(f"{mcpu}m"),
                    "memory": Quantity("64Mi")}))],
            priority=prio, node_selector=sel or {}, host=pin, volumes=vols,
            preemption_policy=("" if can else api.PreemptNever)),
        status=api.PodStatus(host=host))


def check_identity(nodes, existing, pending, incremental=False):
    """Solve + explain the wave three ways (the port on the CPU, the JAX
    package, the serial twin); decisions, per-reason counts, preempt
    states and messages must match. Returns the port's diagnoses."""
    p_nodes, p_existing, p_pending = (to_port(x) for x in
                                      (nodes, existing, pending))
    if incremental:
        snap = IncrementalEncoder().encode(p_nodes, p_existing, p_pending)
        rsnap = RefIncrementalEncoder().encode(nodes, existing, pending)
    else:
        snap = encode_snapshot(p_nodes, p_existing, p_pending)
        rsnap = ref_encode(nodes, existing, pending)
    chosen, scores = bs.solve(snap, device="cpu")
    diags = explain.explain_wave(snap, chosen, scores, device="cpu")
    rchosen, rscores = ref_bs.solve(rsnap)
    rdiags = ref_explain.explain_wave(rsnap, rchosen, rscores)
    dec, sdiags = explain_serial(nodes, existing, pending)
    assert bs.decisions_to_names(snap, chosen) == dec
    for j in range(len(pending)):
        d, r, s = diags.get(j), rdiags.get(j), sdiags[j]
        assert (d is None) == (r is None) == (s is None), (j, d, r, s)
        if d is not None:
            assert d.counts == r.counts == s.counts, (j, d, r, s)
            assert d.preempt == r.preempt == s.preempt, (j, d, r, s)
            assert d.n_nodes == r.n_nodes == s.n_nodes
            assert sum(d.counts.values()) == d.n_nodes
            assert explain.format_message(d) == ref_explain.format_message(
                ref_explain.PodDiagnosis(*r))
            assert explain.dominant_reason(d) == \
                ref_explain.dominant_reason(r)
    return diags


class TestOracleCountIdentity:
    def test_full_cluster_insufficient(self):
        nodes = [mknode(i) for i in range(4)]
        existing = [mkpod(f"e-{i}-{j}", host=f"n{i:03d}")
                    for i in range(4) for j in range(2)]
        diags = check_identity(nodes, existing, [mkpod("p1"), mkpod("p2")])
        assert diags[0].counts == {"Insufficient cpu": 4}
        assert diags[1].counts == {"Insufficient cpu": 4}

    def test_tied_filters_attribute_serial_short_circuit_order(self):
        nodes = [mknode(0)]
        existing = [mkpod("e", host="n000", mcpu=800, port=80)]
        diags = check_identity(nodes, existing,
                               [mkpod("p", mcpu=500, port=80)])
        assert diags[0].counts == {"Port conflict": 1}

    def test_selector_host_and_pd_reasons(self):
        nodes = [mknode(i, labels={"zone": "a" if i < 2 else "b"})
                 for i in range(4)]
        existing = [mkpod("e", host="n000", pd="disk-1", mcpu=100)]
        diags = check_identity(nodes, existing, [
            mkpod("sel", sel={"zone": "c"}, mcpu=100),
            mkpod("pin", pin="ghost", mcpu=100),
            mkpod("pd", pd="disk-1", mcpu=100, sel={"zone": "a"}),
        ])
        assert diags[0].counts == {"Node selector mismatch": 4}
        assert diags[1].counts == {"Host mismatch": 4}
        assert 2 not in diags

    def test_overcommitted_node(self):
        nodes = [mknode(0, cpu="1")]
        existing = [mkpod("big-e", host="n000", mcpu=1500)]
        diags = check_identity(nodes, existing, [mkpod("tiny", mcpu=100)])
        assert diags[0].counts == {"Node overcommitted": 1}

    def test_preemption_ineligible_reasons(self):
        nodes = [mknode(i) for i in range(3)]
        existing = [mkpod(f"low-{i}-{j}", host=f"n{i:03d}", prio=10)
                    for i in range(3) for j in range(2)]
        diags = check_identity(nodes, existing, [
            mkpod("never", prio=100, can=False),
            mkpod("big", mcpu=2000, prio=100),
        ])
        assert diags[0].preempt == "Never"
        assert diags[1].preempt == "no_prefix"

    def test_post_eviction_carry(self):
        nodes = [mknode(i) for i in range(2)]
        existing = [mkpod(f"low-{i}-{j}", host=f"n{i:03d}", prio=10)
                    for i in range(2) for j in range(2)]
        diags = check_identity(nodes, existing, [
            mkpod("hi", mcpu=900, prio=100),
            mkpod("p2", mcpu=900, prio=10),
        ])
        assert 0 not in diags
        assert diags[1].counts == {"Insufficient cpu": 2}

    def test_legacy_wave_has_no_preempt_state(self):
        nodes = [mknode(0)]
        existing = [mkpod("e", host="n000", prio=0)]
        diags = check_identity(nodes, existing, [mkpod("p", mcpu=800)])
        assert diags[0].preempt == ""

    def test_empty_cluster_no_nodes(self):
        snap = encode_snapshot([], [], [to_port(mkpod("p"))])
        diags = explain.explain_wave(snap, [-1], [-1], device="cpu")
        rdiags = ref_explain.explain_wave(ref_encode([], [], [mkpod("p")]),
                                          [-1], [-1])
        dec, sdiags = explain_serial([], [], [mkpod("p")])
        assert dec == [None]
        assert diags[0].counts == rdiags[0].counts == sdiags[0].counts == {}
        assert diags[0].n_nodes == 0

    @pytest.mark.parametrize("incremental", [False, True],
                             ids=["full", "incremental"])
    def test_fuzz_identity_full_and_incremental(self, incremental):
        rng = random.Random(11)
        for trial in range(12):
            N = rng.randint(1, 6)
            nodes = [mknode(i, cpu=rng.choice(["1", "2"]),
                            labels={"zone": rng.choice(["a", "b"])})
                     for i in range(N)]
            existing = [
                mkpod(f"e-{trial}-{i}-{j}", host=f"n{i:03d}",
                      mcpu=rng.choice([200, 500, 800]),
                      prio=rng.choice([0, 10, 50]),
                      port=rng.choice([0, 0, 80]),
                      pd=rng.choice(["", "", f"pd-{i}"]))
                for i in range(N) for j in range(rng.randint(0, 3))]
            pending = [
                mkpod(f"p-{trial}-{k}",
                      mcpu=rng.choice([100, 600, 1200, 2500]),
                      prio=rng.choice([0, 20, 100]),
                      can=rng.random() > 0.3,
                      port=rng.choice([0, 0, 80]),
                      sel=rng.choice([None, None, {"zone": "a"},
                                      {"zone": "z"}]),
                      pd=rng.choice(["", "", f"pd-{rng.randrange(N)}"]),
                      pin=rng.choice(["", "", f"n{rng.randrange(N):03d}",
                                      "ghost"]))
                for k in range(rng.randint(1, 6))]
            check_identity(nodes, existing, pending, incremental=incremental)

    def test_batches_past_the_row_cap_match(self):
        """More unschedulable pods in one run than one diagnosis batch
        holds (the 32-row cap), interleaved with placed pods that move the
        carry: counts still identical."""
        nodes = [mknode(i, cpu="2", labels={"zone": "a"}) for i in range(3)]
        existing = [mkpod(f"e{i}", host=f"n{i:03d}", mcpu=900, port=80)
                    for i in range(3)]
        pending = [mkpod(f"big{k}", mcpu=1500 + 10 * k) for k in range(40)]
        pending += [mkpod("fit", mcpu=600)]
        pending += [mkpod(f"sel{k}", sel={"zone": "b"}, port=80 * (k % 2))
                    for k in range(35)]
        diags = check_identity(nodes, existing, pending)
        assert len(diags) == 75


class TestMessageGoldens:
    @pytest.mark.parametrize("diag, top_k, want", [
        (explain.PodDiagnosis(10000, {"Insufficient cpu": 9988,
                                      "Port conflict": 12}), 4,
         "0/10000 nodes available: 9988 Insufficient cpu, 12 Port conflict"),
        (explain.PodDiagnosis(15, {"Port conflict": 5, "PD conflict": 5,
                                   "Host mismatch": 2,
                                   "Insufficient cpu": 2,
                                   "Node selector mismatch": 1}), 2,
         "0/15 nodes available: 5 PD conflict, 5 Port conflict, 5 other"),
        (explain.PodDiagnosis(3, {"Insufficient cpu": 3}, "Never"), 4,
         "0/3 nodes available: 3 Insufficient cpu; preemption not "
         "attempted (preemptionPolicy: Never)"),
        (explain.PodDiagnosis(3, {"Insufficient cpu": 3}, "no_prefix"), 4,
         "0/3 nodes available: 3 Insufficient cpu; preemption would not "
         "help (no lower-priority victim set frees enough)"),
        (explain.PodDiagnosis(0, {}), 4, "0/0 nodes available"),
    ], ids=["topk", "ties-and-other", "never", "no-prefix", "no-nodes"])
    def test_lines_equal_the_reference(self, diag, top_k, want):
        assert explain.format_message(diag, top_k=top_k) == want
        assert ref_explain.format_message(
            ref_explain.PodDiagnosis(*diag), top_k=top_k) == want

    def test_dominant_reason(self):
        d = explain.PodDiagnosis(10, {"Port conflict": 4,
                                      "Insufficient cpu": 6})
        assert explain.dominant_reason(d) == "Insufficient cpu"
        assert explain.dominant_reason(explain.PodDiagnosis(0, {})) == \
            explain.REASON_UNEXPLAINED == ref_explain.REASON_UNEXPLAINED

    def test_canonical_rank_equals_the_reference(self):
        names = ["cpu", "memory", "zz", "ephemeral-storage", "gpu"]
        assert explain.canonical_rank(names).tolist() == \
            ref_explain.canonical_rank(names).tolist() == [0, 1, 4, 2, 3]


def _solved_wave(n_nodes=2):
    """A tiny solved wave with one unschedulable pod."""
    nodes = [mknode(i) for i in range(n_nodes)]
    existing = [mkpod(f"e{i}", host=f"n{i:03d}", mcpu=900)
                for i in range(n_nodes)]
    snap = encode_snapshot(to_port(nodes), to_port(existing),
                           [to_port(mkpod("p", mcpu=500))])
    chosen, scores = bs.solve(snap, device="cpu")
    assert int(chosen[0]) < 0
    return snap, chosen, scores


class TestOffHotPathGuard:
    def test_rate_limit_declines_and_counts_unexplained(self):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(qps=0.0001, burst=1, device="cpu")
        snap, chosen, scores = _solved_wave()
        pods0 = mx.pods.value()
        unexp0 = mx.reasons.value(explain.REASON_UNEXPLAINED)
        skip0 = mx.skipped.value("rate_limited")
        inv0 = mx.invocations.value()
        assert ex.diagnose_wave(snap, chosen, scores) == {
            0: "0/2 nodes available: 2 Insufficient cpu"}
        assert ex.diagnose_wave(snap, chosen, scores) == {}  # declined
        assert mx.pods.value() - pods0 == 2
        assert mx.skipped.value("rate_limited") - skip0 == 1
        assert mx.reasons.value(explain.REASON_UNEXPLAINED) - unexp0 == 1
        assert mx.invocations.value() - inv0 == 1

    def test_refused_on_solve_and_commit_threads(self):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(device="cpu")
        snap, chosen, scores = _solved_wave()
        skip0 = mx.skipped.value("hot_path")
        out = {}

        def run():
            out["msgs"] = ex.diagnose_wave(snap, chosen, scores)

        for name in ("tpu-batch-solve_0", "tpu-batch-commit_0"):
            t = threading.Thread(target=run, name=name)
            t.start()
            t.join()
            assert out.pop("msgs") == {}
        assert mx.skipped.value("hot_path") - skip0 == 2

    def test_schedulable_wave_is_free(self):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(qps=0.0001, burst=0, device="cpu")
        snap = encode_snapshot([to_port(mknode(0, cpu="8"))], [],
                               [to_port(mkpod("p"))])
        chosen, scores = bs.solve(snap, device="cpu")
        inv0, pods0 = mx.invocations.value(), mx.pods.value()
        assert ex.diagnose_wave(snap, chosen, scores) == {}
        assert mx.invocations.value() == inv0
        assert mx.pods.value() == pods0

    def test_internal_error_keeps_reason_sums(self, monkeypatch):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(device="cpu")
        snap, chosen, scores = _solved_wave()
        monkeypatch.setattr(explain, "explain_wave",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                RuntimeError("boom")))
        pods0 = mx.pods.value()
        unexp0 = mx.reasons.value(explain.REASON_UNEXPLAINED)
        err0 = mx.skipped.value("error")
        assert ex.diagnose_wave(snap, chosen, scores) == {}
        assert mx.pods.value() - pods0 == 1
        assert mx.skipped.value("error") - err0 == 1
        assert mx.reasons.value(explain.REASON_UNEXPLAINED) - unexp0 == 1

    def test_forced_requeue_rows_counted_unexplained(self):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(device="cpu")
        snap, chosen, scores = _solved_wave()
        pods0 = mx.pods.value()
        unexp0 = mx.reasons.value(explain.REASON_UNEXPLAINED)
        msgs = ex.diagnose_wave(snap, chosen, scores, n_unsched=3)
        assert len(msgs) == 1
        assert mx.pods.value() - pods0 == 3
        assert mx.reasons.value(explain.REASON_UNEXPLAINED) - unexp0 == 2

    def test_unsupported_wave_skipped(self):
        mx = metrics.explain_metrics()
        ex = explain.Explainer(device="cpu")
        snap, chosen, scores = _solved_wave()
        snap.pod_rid[0] = 3          # fake a gang member: has_gangs True
        skip0 = mx.skipped.value("unsupported")
        assert ex.diagnose_wave(snap, chosen, scores) == {}
        assert mx.skipped.value("unsupported") - skip0 == 1

    def test_default_device_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            explain.Explainer()
        snap, chosen, scores = _solved_wave()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            explain.explain_wave(snap, chosen, scores)


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["causal", "pipelined"])
def test_loop_event_carries_the_breakdown(pipeline):
    """A pod that fits nowhere: both of the port's loops write the
    breakdown line into its FailedScheduling event, the diagnosis runs on
    the loop thread only, and the unschedulable families move together."""
    nodes = [mknode(0, cpu="1")]
    resident = [mkpod("resident", host="n000", pin="n000", mcpu=900)]
    pending = [mkpod("wont-fit", mcpu=500), mkpod("fits", mcpu=50)]
    cluster = FakeCluster(to_port(nodes), to_port(resident),
                          to_port(pending), [])
    factory = port_driver.ConfigFactory(cluster.client, node_poll_period=3600)
    factory.backoff = port_driver.PodBackoff(initial=0.05, max_duration=0.2)
    cluster.attach(factory)
    recorder = EventRecorder(cluster.client,
                             port_api.EventSource(component="scheduler"))
    sched = BatchScheduler(factory.create(recorder=recorder), factory,
                           cluster.client, wave_size=8, wave_linger_s=0.02,
                           pipeline=pipeline, device="cpu")
    threads = []
    orig = sched._explainer.diagnose_wave

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return orig(*a, **kw)

    sched._explainer.diagnose_wave = spy
    mx = metrics.explain_metrics()
    pods0, cpu0 = mx.pods.value(), mx.reasons.value("Insufficient cpu")

    def messages():
        return [a.kw["body"].message
                for a in cluster.client.actions_of("create", "events")
                if a.kw["body"].involved_object.name == "wont-fit"
                and a.kw["body"].reason == "FailedScheduling"]

    try:
        cluster.wait_synced()
        sched.run()
        assert _wait(lambda: any("nodes available" in m
                                 for m in messages())), messages()
    finally:
        assert sched.stop(timeout=5.0)
        assert factory.stop(join=True)
    assert "0/1 nodes available: 1 Insufficient cpu" in messages()
    assert {p.metadata.name for p in cluster.bind_log} == {"fits"}
    assert threads and all(
        not t.startswith(("tpu-batch-solve", "tpu-batch-commit"))
        for t in threads), threads
    assert mx.reasons.value("Insufficient cpu") - cpu0 >= 1
    assert mx.pods.value() - pods0 >= 1
    assert sched.fault is None
