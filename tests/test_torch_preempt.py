"""The port's preemption and int64 waves, on the CPU, against the JAX
package.

Every wave is built once through the JAX package's API types (the
fixtures of tests/test_preempt.py) and carried into the port's field for
field (``to_port``). The port's decisions and scores must equal the JAX
``batch_solver.solve`` exactly, and its victim sets — replayed by
``preempt.assign_victims`` from the full encoder's resident list or the
incremental encoder's registry — the serial oracle ``preempt_serial``'s
(tolerance 0: decisions, scores and victims are integers and names).
int64 waves are held against the JAX ``solve`` and ``solve_serial``, one
wave at a time and through ``BatchScheduler``; the two packages' loops
are held against each other on a preemption storm; chip_smoke's phases 4c
and 8 run here at a small size on the plain version.
"""

import dataclasses
import random

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import errors as ref_errors
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.client.client import FakeClient as RefFakeClient
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models import preempt as ref_preempt
from kubernetes_tpu.models.incremental import \
    IncrementalEncoder as RefEncoder
from kubernetes_tpu.models.oracle import preempt_serial, solve_serial
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.runtime.clone import deep_clone as ref_clone
from kubernetes_tpu.scheduler import driver as ref_driver
from kubernetes_tpu.scheduler import tpu_batch as ref_tpu_batch
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import fixtures, preempt
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.scheduler import driver as port_driver
from kubernetes_tpu_torch.scheduler.tpu_batch import BatchScheduler
from kubernetes_tpu_torch.tools.fake_cluster import FakeCluster
from kubernetes_tpu_torch.util import metrics as port_metrics
from test_preempt import mknode, mkpod
from test_torch_batch_solver import REF
from test_torch_policy import policy_json, to_port

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def norm(victims):
    return [sorted(v.uid for v in (x or [])) or None for x in victims]


def port_decide(nodes, existing, pending, services=(), policy=None,
                encoder=None):
    """The port's wave: encode (full or incremental), solve on the CPU,
    replay the victims -> (names, victims, snapshot, chosen, scores)."""
    nodes, existing, pending, services = (
        to_port(list(x)) for x in (nodes, existing, pending, services))
    if encoder is not None:
        snap = encoder.encode(nodes, existing, pending, services)
        lookup = dict(node_pods=encoder.resident_on)
    else:
        snap = encode_snapshot(nodes, existing, pending, services,
                               policy=policy)
        index = {n.metadata.name: i for i, n in enumerate(nodes)}
        lookup = dict(resident=preempt.resident_from_pods(existing, index))
    chosen, scores = bs.solve(snap, device="cpu")
    victims = preempt.assign_victims(chosen, scores, snap.band_prio,
                                     n_pods=len(pending), **lookup)
    return bs.decisions_to_names(snap, chosen), victims, snap, chosen, scores


def check_wave(nodes, existing, pending, services=(), ref_policy=None,
               oracle=True, encoder=None):
    """Port == JAX solve (chosen, scores) and == preempt_serial (names,
    victim sets); returns the port's (names, victims, snapshot)."""
    policy = (BatchPolicy(**dataclasses.asdict(ref_policy))
              if ref_policy is not None else None)
    names, victims, snap, chosen, scores = port_decide(
        nodes, existing, pending, services, policy, encoder)
    jsnap = ref_encode(nodes, existing, pending, services, policy=ref_policy)
    jc, js = ref_bs.solve(jsnap)
    assert np.array_equal(chosen, np.asarray(jc))
    if encoder is None:
        # an incremental encoder numbers its band slots in arrival order,
        # so its preemption scores name other slots than the full one's
        assert np.array_equal(scores, np.asarray(js))
    if oracle:
        serial_policy = (ref_load_policy(policy_json(ref_policy))
                         if ref_policy is not None else None)
        s_names, s_victims = preempt_serial(nodes, existing, pending,
                                            services, policy=serial_policy)
        assert names == s_names
        assert norm(victims) == norm(s_victims)
    prio_of = {f"uid-{p.metadata.name}": ref_api.pod_priority(p)
               for p in existing}
    for p, v in zip(pending, victims):
        if v:
            # never an equal-or-higher victim, never a Never preemptor
            assert all(prio_of[x.uid] < ref_api.pod_priority(p) for x in v)
            assert ref_api.pod_can_preempt(p)
    return names, victims, snap


# ---- the fixtures of tests/test_preempt.py ---------------------------------

def w_full_cluster():
    nodes = [mknode(i) for i in range(4)]
    existing = [mkpod(f"low-{i}-{j}", host=f"n{i:03d}", prio=10)
                for i in range(4) for j in range(2)]
    return nodes, existing, [mkpod("high", prio=1000)]


def w_empty_cluster():
    return ([mknode(i) for i in range(3)], [],
            [mkpod("high", prio=1000), mkpod("low", prio=0)])


def w_tied_clusters():
    nodes = [mknode(i) for i in range(8)]
    existing = [mkpod(f"e-{i}", mcpu=1000, host=f"n{i:03d}", prio=7)
                for i in range(8)]
    return nodes, existing, [mkpod(f"h-{k}", mcpu=1000, prio=99)
                             for k in range(5)]


def w_lowest_sufficient_band():
    return ([mknode(0, cpu="1")],
            [mkpod("b100", mcpu=500, host="n000", prio=100),
             mkpod("b200", mcpu=500, host="n000", prio=200)],
            [mkpod("high", mcpu=500, prio=1000)])


def w_min_victim_cost():
    return ([mknode(0, cpu="1"), mknode(1, cpu="1")],
            [mkpod("a1", mcpu=500, host="n000", prio=5),
             mkpod("a2", mcpu=500, host="n000", prio=5),
             mkpod("b1", mcpu=1000, host="n001", prio=5)],
            [mkpod("high", mcpu=1000, prio=50)])


def w_never_policy():
    return ([mknode(0)],
            [mkpod(f"low-{j}", host="n000", prio=1) for j in range(2)],
            [mkpod("never", prio=1000, can=False)])


def w_equal_priority():
    return ([mknode(0)],
            [mkpod(f"peer-{j}", host="n000", prio=100) for j in range(2)],
            [mkpod("equal", prio=100), mkpod("below", prio=50)])


def w_within_wave():
    return ([mknode(0, cpu="1")],
            [mkpod("old", mcpu=500, host="n000", prio=10)],
            [mkpod("a", mcpu=500, prio=500), mkpod("b", mcpu=1000,
                                                   prio=1000)])


def w_legacy():
    nodes = [mknode(i, cpu="4") for i in range(3)]
    existing = [mkpod(f"e-{i}", host=f"n{i:03d}") for i in range(3)]
    return nodes, existing, [mkpod(f"p-{k}", mcpu=300) for k in range(4)]


FIXTURES = {f.__name__[2:]: f for f in (
    w_full_cluster, w_empty_cluster, w_tied_clusters,
    w_lowest_sufficient_band, w_min_victim_cost, w_never_policy,
    w_equal_priority, w_within_wave, w_legacy)}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_matches_solve_and_preempt_serial(name):
    nodes, existing, pending = FIXTURES[name]()
    names, victims, snap = check_wave(nodes, existing, pending)
    if name == "full_cluster":
        assert names[0] is not None and victims[0]
        assert all(v.priority == 10 for v in victims[0])
    elif name == "empty_cluster":
        assert snap.band_prio.shape[0] == 0
        assert all(v is None for v in victims)
    elif name == "tied_clusters":
        assert all(n is not None for n in names)
    elif name == "lowest_sufficient_band":
        assert names == ["n000"] and norm(victims) == [["uid-b100"]]
    elif name == "min_victim_cost":
        assert names == ["n001"] and norm(victims) == [["uid-b1"]]
    elif name == "never_policy":
        assert names == [None] and victims == [None]
    elif name == "equal_priority":
        assert names == [None, None]
    elif name == "within_wave":
        assert all(x.uid != "uid-a" for v in victims if v for x in v)
    elif name == "legacy":
        # no priority diversity: no bands, the pre-preemption instance
        assert snap.band_prio.shape[0] == 0
        assert names == solve_serial(nodes, existing, pending)


def fuzz_wave(seed):
    """tests/test_preempt.py's fuzz trial, one per seed."""
    rng = random.Random(seed)
    N = rng.randint(2, 6)
    nodes = [mknode(i, cpu=rng.choice(["1", "2"])) for i in range(N)]
    existing = [
        mkpod(f"e-{i}-{j}", rng.choice([200, 300, 500]), host=f"n{i:03d}",
              prio=rng.choice([0, 5, 10, 50]),
              port=rng.choice([0, 0, 0, 7070]))
        for i in range(N) for j in range(rng.randint(0, 4))]
    pending = [
        mkpod(f"p-{k}", rng.choice([300, 500, 800, 1500]),
              prio=rng.choice([0, 10, 100, 1000]),
              can=rng.random() > 0.2, port=rng.choice([0, 0, 7070]))
        for k in range(rng.randint(1, 6))]
    return nodes, existing, pending


@pytest.mark.parametrize("seed", range(1234, 1246))
def test_fuzz_decisions_and_victims(seed):
    check_wave(*fuzz_wave(seed))


def test_fuzz_seeds_preempt():
    # the fuzz seeds above do exercise the branch
    placed = 0
    for seed in range(1234, 1246):
        _names, victims, *_ = port_decide(*fuzz_wave(seed))
        placed += sum(1 for v in victims if v)
    assert placed >= 3


# ---- encoders and band order -----------------------------------------------

def test_incremental_encoder_matches_full_encoder():
    nodes, existing, pending = w_full_cluster()
    pending = pending + [mkpod("h2", prio=1000)]
    enc = IncrementalEncoder()
    n_i, v_i, _ = check_wave(nodes, existing, pending, encoder=enc)
    n_f, v_f, _ = check_wave(nodes, existing, pending)
    assert n_i == n_f and norm(v_i) == norm(v_f)


def _arrival_order_wave():
    """Residents whose priorities arrive high first, so the incremental
    encoder's band slots are out of value order; three bands per node,
    so the lowest sufficient prefix is a real choice."""
    nodes = [mknode(i, cpu="2") for i in range(5)]
    existing = []
    for prio in (300, 100, 200):
        for i in range(5):
            existing.append(mkpod(f"e{prio}-{i}", mcpu=600 if i % 2 else 500,
                                  host=f"n{i:03d}", prio=prio))
    pending = [mkpod(f"h{k}", mcpu=[400, 900, 1200, 300][k % 4],
                     prio=[250, 1000, 150, 1000][k % 4]) for k in range(8)]
    return nodes, existing, pending


def test_arrival_order_bands_match():
    nodes, existing, pending = _arrival_order_wave()
    enc = IncrementalEncoder()
    names, victims, snap = check_wave(nodes, existing, pending, encoder=enc)
    band = snap.band_prio[snap.band_prio != preempt.BAND_EMPTY]
    assert list(band) == [300, 100, 200]          # slots in arrival order
    assert sum(1 for v in victims if v) >= 2
    # the same wave on the JAX incremental encoder: the same slots and the
    # same preemption scores
    ref = RefEncoder()
    rsnap = ref.encode(nodes, existing, pending)
    assert np.array_equal(rsnap.band_prio, snap.band_prio)
    jc, js = ref_bs.solve(rsnap)
    pc, ps = bs.solve(snap, device="cpu")
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))


def test_kernel_band_order_is_sorted_and_stable():
    # the prolog hands the kernel the slots in ascending band value
    nodes, existing, pending = _arrival_order_wave()
    snap = IncrementalEncoder().encode(*to_port([nodes, existing, pending]))
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    ci = commit_solver.prepare(inp, snap.policy)
    order = ci.bord.tolist()
    vals = ci.band[ci.bord.long()].tolist()
    assert vals == sorted(vals) and order[:3] == [1, 2, 0]


def test_gang_preemption_matches_reference():
    from kubernetes_tpu.models import gang as ref_gang

    nodes, existing, pending = _arrival_order_wave()
    ann = {ref_gang.GANG_NAME_ANNOTATION: "grp"}
    pending = pending[:2] + [
        mkpod(f"g{m}", mcpu=1500, prio=1000) for m in range(3)] + \
        pending[2:]
    for p in pending[2:5]:
        p.metadata.annotations = dict(ann)
    names, _victims, snap = check_wave(nodes, existing, pending,
                                       oracle=False)
    assert snap.has_gangs


def test_anti_affinity_preemption_matches_oracle():
    nodes, existing, pending = _arrival_order_wave()
    for i, n in enumerate(nodes):
        n.metadata.labels = {"zone": f"z{i % 2}"}
    for p in existing + pending:
        p.metadata.labels = {"app": "web"}
    services = [REF.svc("web", {"app": "web"})]
    check_wave(nodes, existing, pending, services,
               ref_policy=RefPolicy(anti_affinity=(("zone", 2),)))


def test_bands_above_the_cap_take_the_scan():
    # 40 distinct resident priorities pad to 64 band slots: past the
    # kernel's cap, the wave runs solve_scan, with the same decisions
    nodes = [mknode(i, cpu="4") for i in range(10)]
    existing = [mkpod(f"e{k}", mcpu=900, host=f"n{k % 10:03d}", prio=k)
                for k in range(40)]
    pending = [mkpod(f"h{k}", mcpu=1500, prio=100) for k in range(6)]
    _names, _victims, snap = check_wave(nodes, existing, pending)
    assert snap.band_prio.shape[0] == 64
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    assert not commit_solver.eligible(inp, snap.policy, bs.peer_bound_of(snap))
    assert commit_solver.eligible(
        inp._replace(band_prio=inp.band_prio[:commit_solver.MAX_B]),
        snap.policy, bs.peer_bound_of(snap))


# ---- int64 resource planes -------------------------------------------------

def _int64_waves():
    yield "tebibyte_plus_3", (
        [REF.node("big", mem=(1 << 40) + 3), REF.node("n1", mem=8 << 30)],
        [REF.pod("e0", cpu_m=500, mem=1 << 30, host="big")],
        [REF.pod(f"p{i}", cpu_m=300 * (1 + i % 3), mem=(1 + i) << 28)
         for i in range(8)])
    # decimal-unit requests on binary 64Gi+ nodes: the column gcd drops to
    # 2^8 and 64Gi / 2^8 = 2^28 passes the int32 headroom
    yield "decimal_memory", (
        [REF.node(f"n{i}", cpu_m=16000, mem=(64 + 64 * (i % 2)) << 30)
         for i in range(4)],
        [REF.pod(f"e{i}", cpu_m=1000, mem=2 << 30, host=f"n{i % 4}")
         for i in range(4)],
        [REF.pod(f"p{i}", cpu_m=500, mem=(100 + 200 * (i % 6)) * 10**6)
         for i in range(12)])


INT64 = dict(_int64_waves())


@pytest.mark.parametrize("name", list(INT64))
def test_int64_wave_matches_solve_and_oracle(name):
    nodes, existing, pending = INT64[name]
    psnap = encode_snapshot(*to_port([nodes, existing, pending]))
    host = bs.snapshot_to_host_inputs(psnap)
    assert host.cap.dtype == np.int64
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(ref_encode(nodes, existing, pending))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    assert bs.decisions_to_names(psnap, pc) == \
        solve_serial(nodes, existing, pending)
    # the kernel's domain takes it
    inp = bs.ship_inputs(host, "cpu")
    assert commit_solver.eligible(inp, psnap.policy, bs.peer_bound_of(psnap))


def test_int64_preemption_wave_matches():
    nodes, existing, pending = INT64["decimal_memory"]
    existing = [dataclasses.replace(p, spec=dataclasses.replace(
        p.spec, priority=10 * (i % 2))) for i, p in enumerate(existing)]
    existing += [REF.pod(f"f{i}", cpu_m=14000, mem=10**9, host=f"n{i}",
                         priority=5) for i in range(4)]
    pending = [dataclasses.replace(p, spec=dataclasses.replace(
        p.spec, priority=100)) for p in pending]
    psnap = encode_snapshot(*to_port([nodes, existing, pending]))
    assert bs.snapshot_to_host_inputs(psnap).cap.dtype == np.int64
    pc, ps = bs.solve(psnap, device="cpu")
    jc, js = ref_bs.solve(ref_encode(nodes, existing, pending))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    assert (ps <= preempt.PREEMPT_SCORE_BASE).any()


def test_int64_wave_through_the_scheduler():
    nodes, existing, pending = INT64["decimal_memory"]
    cluster = FakeCluster(*to_port([nodes, existing, pending]), [])
    factory = port_driver.ConfigFactory(cluster.client, node_poll_period=3600)
    cluster.attach(factory)
    sched = BatchScheduler(factory.create(), factory, cluster.client,
                           wave_size=64, wave_linger_s=0.01, device="cpu")
    try:
        cluster.wait_synced()
        assert sched.schedule_wave(timeout=1.0) == len(pending)
        got = {p.metadata.name: p.spec.host for p in cluster.bind_log}
        want = dict(zip((p.metadata.name for p in pending),
                        solve_serial(nodes, existing, pending)))
        assert got == want
    finally:
        assert factory.stop(join=True)


# ---- the two packages' loops on one preemption storm -----------------------

def _loop(name, world):
    """One package's BatchScheduler over its FakeCluster; drains every
    wave -> (bindings by pod, victims by pod)."""
    nodes, existing, pending = world
    if name == "ref":
        cluster = FakeCluster(nodes, existing, pending, [], api=ref_api,
                              client_cls=RefFakeClient, errors=ref_errors,
                              clone=ref_clone)
        factory = ref_driver.ConfigFactory(cluster.client,
                                           node_poll_period=3600)
        sched_cls, kw = ref_tpu_batch.BatchScheduler, {}
    else:
        cluster = FakeCluster(*to_port([nodes, existing, pending]), [])
        factory = port_driver.ConfigFactory(cluster.client,
                                            node_poll_period=3600)
        sched_cls, kw = BatchScheduler, {"device": "cpu"}
    factory.backoff.initial = 3600.0
    cluster.attach(factory)
    sched = sched_cls(factory.create(), factory, cluster.client,
                      wave_size=16, wave_linger_s=0.01, **kw)
    try:
        cluster.wait_synced()
        while True:
            try:
                sched.schedule_wave(timeout=0)
            except TimeoutError:
                break
        return ({p.metadata.name: p.spec.host for p in cluster.bind_log},
                {k: sorted(v.metadata.name for v in vs)
                 for k, vs in cluster.victims_of.items()})
    finally:
        factory.stop(join=True)


def test_both_loops_preempt_alike():
    from bench import build_priority_cluster
    world = build_priority_cluster(12, 40)
    ref_binds, ref_victims = _loop("ref", world)
    port_binds, port_victims = _loop("port", world)
    assert port_binds == ref_binds
    assert port_victims == ref_victims
    assert port_victims


def _plain(obj):
    """An API object tree with every Quantity replaced by its value."""
    if hasattr(obj, "value") and type(obj).__name__ == "Quantity":
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def test_priority_fixture_is_the_bench_cluster():
    from bench import build_priority_cluster
    ref = build_priority_cluster(6, 20)
    port = fixtures.build_priority_cluster(6, 20)
    assert port[3] == []
    for a, b in zip(port[:3], ref):
        assert _plain(a) == _plain(to_port(list(b)))


# ---- the preempt module, the layouts, the counters -------------------------

def test_score_channel_round_trips():
    for slot in range(commit_solver.MAX_B):
        score = preempt.preempt_score(slot)
        assert preempt.is_preempt_score(score)
        assert preempt.ceiling_slot(score) == slot
        assert score == ref_preempt.preempt_score(slot)
    assert not preempt.is_preempt_score(-1)
    assert not preempt.is_preempt_score(0)


def test_band_values_and_emit_gate_match_reference():
    nodes, existing, pending = _arrival_order_wave()
    index = {n.metadata.name: i for i, n in enumerate(nodes)}
    pn, pe, pp = to_port([nodes, existing, pending])
    assert preempt.band_values_of(pe, index) == \
        ref_preempt.band_values_of(existing, index) == [100, 200, 300]
    for pend in (pending, pending[:1], [mkpod("low", prio=50)], []):
        assert preempt.preemption_possible([100, 200], to_port(pend)) == \
            ref_preempt.preemption_possible([100, 200], pend)


@pytest.mark.parametrize("shape, on_chip, res_bytes, bands", [
    ("north_star_dec", True, 8, 0),
    ("priority", True, 4, 2),
])
def test_new_full_shapes_layout(shape, on_chip, res_bytes, bands):
    # north_star_dec's int64 fit planes still fit the block's shared
    # memory (210,016 B); the priority wave's two bands too
    n_nodes, n_pods, kw, _ = fixtures.FULL_SHAPES[shape]
    if shape == "priority":
        cluster = fixtures.build_priority_cluster(64, 40, **kw)
    else:
        cluster = fixtures.build_cluster(64, 200, **kw)
    snap = encode_snapshot(*cluster)
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    ci = commit_solver.prepare(inp, snap.policy)
    assert ci.cap.element_size() == res_bytes
    assert ci.band.shape[0] == bands
    R, Wp, Wd, G = (ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0],
                    ci.counts0.shape[0])
    got, nbytes = commit_solver.shared_layout(n_nodes, R, Wp, Wd, G, bands,
                                              res_bytes)
    assert got == on_chip
    assert nbytes == 2 * commit_solver.mask_pitch(n_nodes) + \
        commit_solver.state_bytes(n_nodes, R, Wp, Wd, G, bands, res_bytes)


def test_many_bands_take_the_global_layout():
    # chip_smoke's 1,500-node wave at the 32-band cap
    on_chip, nbytes = commit_solver.shared_layout(1500, 2, 1, 1, 2, 32, 4)
    assert not on_chip and nbytes == 2 * commit_solver.mask_pitch(1500)


def test_plain_version_counts_its_calls():
    nodes, existing, pending = w_full_cluster()
    before = commit_solver.solve_commit_reference.calls
    launches = commit_solver.solve_commit.launches
    bs.solve(encode_snapshot(*to_port([nodes, existing, pending])),
             device="cpu")
    assert commit_solver.solve_commit_reference.calls == before + 1
    assert commit_solver.solve_commit.launches == launches


def test_preemption_metrics_family():
    pmx = port_metrics.preemption_metrics()
    assert pmx is port_metrics.preemption_metrics()
    names = {"scheduler_preemption_attempts_total",
             "scheduler_preemption_victims_total",
             "scheduler_preemption_conflicts_total",
             "scheduler_preemption_higher_evictions_total",
             "scheduler_preemption_bind_seconds"}
    assert {m.name for m in (pmx.attempts, pmx.victims, pmx.conflicts,
                             pmx.higher_evictions, pmx.bind_seconds)} == names


def test_fake_cluster_evict_bind_is_atomic():
    """FakeCluster's evict+bind: victims deleted and the pod bound in one
    step; a victim whose uid changed fails the item with 409 and nothing
    applies; an absent victim counts as evicted."""
    nodes = [REF.node("n0")]
    existing = [REF.pod("v1", cpu_m=100, host="n0"),
                REF.pod("v2", cpu_m=100, host="n0")]
    pending = [REF.pod("a"), REF.pod("b")]
    cluster = FakeCluster(*to_port([nodes, existing, pending]), [])

    def ref(name, uid=None):
        return port_api.ObjectReference(kind="Pod", namespace="default",
                                        name=name,
                                        uid=uid or f"uid-default-{name}")

    def binding(pod, victims):
        return port_api.Binding(
            metadata=port_api.ObjectMeta(name=pod, namespace="default"),
            pod_name=pod, host="n0", victims=victims)

    res = cluster.client.pods().bind_many(port_api.BindingList(items=[
        binding("a", [ref("v1", uid="other")]),
        binding("b", [ref("v2"), ref("gone")])]))
    assert [r.code for r in res.items] == [409, 0]
    assert "default/v1" in cluster.pods and "default/v2" not in cluster.pods
    assert not cluster.pods["default/a"].spec.host
    assert cluster.pods["default/b"].spec.host == "n0"
    assert [p.metadata.name for p in cluster.evict_log] == ["v2"]
    assert [p.metadata.name for p in cluster.victims_of["default/b"]] == \
        ["v2"]


# ---- chip_smoke's new phases, on the plain version -------------------------

def test_chip_smoke_preemption_phases_run_on_the_cpu(monkeypatch):
    """Phases 4c and 8 at a small size: kernel == plain trivially here,
    but the waves, the invariants and the loop's replay checks run."""
    import time

    import chip_smoke
    from kubernetes_tpu_torch.tools import kernel_time

    def host_ms(fn, runs):
        t0 = time.perf_counter()
        out = [fn() for _ in range(runs)][-1]
        ms = (time.perf_counter() - t0) * 1e3 / runs
        return ms, [ms], out

    monkeypatch.setattr(kernel_time, "event_ms", host_ms)
    monkeypatch.setattr(chip_smoke, "_PRE_CASES", chip_smoke._PRE_CASES[:5]
                        + chip_smoke._PRE_CASES[-2:])
    monkeypatch.setattr(chip_smoke, "_PRE_WIDE",
                        [(600, 1100, 30, 32, dict(anti=1))])
    pr = chip_smoke._pre_fuzz(torch.device("cpu"))
    assert pr["preempting"] and pr["int64"] and pr["bands_at_cap"]
    assert set(pr["layouts"]) == {"shared", "global"}
    pl = chip_smoke._preempt_loop_phase("cpu", n_nodes=40, n_pending=60,
                                        wave_size=32, count_launches=False)
    assert len(pl["waves"]) == 2 and pl["preempted_pods"] and pl["victims"]
