"""The port's IncrementalEncoder against the JAX package's, on the CPU.

Every wave is built once through the JAX package's API types and carried
into the port's field for field (``to_port``); the two packages'
IncrementalEncoders are driven in lockstep — the same full encodes, the
same deltas — and every field of their ClusterSnapshots must be equal
(dtype, shape and values; tolerance 0). Each wave's decisions must also
equal the JAX ``batch_solver.solve`` and, by name, the serial oracle
``oracle.solve_serial``. The scenarios mirror tests/test_incremental.py:
one wave, inert padding, binds and deletes, a node change, label and zone
policies, fuzzed churn and fuzzed deltas, the overflow and node-change
bail-outs of ``encode_delta``, the CheckServiceAffinity refusal,
checkpoint/restore and the evictable planes against their from-scratch
derivation and the preemption they drive.
"""

import dataclasses
import random

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models import gang as ref_gang
from kubernetes_tpu.models.incremental import \
    IncrementalEncoder as RefEncoder
from kubernetes_tpu.models.oracle import preempt_serial, solve_serial
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import preempt
from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
from kubernetes_tpu_torch.models.policy import BatchPolicy
from test_torch_batch_solver import REF
from test_torch_policy import policy_json, to_port

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)

mk_node = REF.node


def mk_pod(name, group=None, **kw):
    ann = {ref_gang.GANG_NAME_ANNOTATION: group} if group else None
    return REF.pod(name, annotations=ann, **kw)


def mk_svc(name, selector):
    return REF.svc(name, selector)


def assert_snap_equal(ref, port):
    """Every field of the port's ClusterSnapshot equals the JAX one."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "policy":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            b = np.asarray(b)
            assert a.dtype == b.dtype, f"{f.name}: {a.dtype} vs {b.dtype}"
            assert a.shape == b.shape, f"{f.name}: {a.shape} vs {b.shape}"
            assert np.array_equal(a, b), f"{f.name} differs"
        else:
            assert a == b, f"{f.name}: {a!r} vs {b!r}"


class Pair:
    """The two packages' encoders, driven in lockstep on one world of
    JAX-package objects (the port's side gets ``to_port`` copies)."""

    def __init__(self, **policy):
        self.ref = RefEncoder(RefPolicy(**policy) if policy else None)
        self.port = IncrementalEncoder(BatchPolicy(**policy)
                                       if policy else None)
        self.policy_text = policy_json(self.ref.policy) if policy else None

    def encode(self, nodes, existing, pending, services=()):
        r = self.ref.encode(nodes, existing, pending, services)
        p = self.port.encode(*(to_port(list(x)) for x in
                               (nodes, existing, pending, services)))
        assert_snap_equal(r, p)
        return r, p

    def encode_delta(self, nodes, upserted, removed, pending, services=()):
        r = self.ref.encode_delta(nodes, upserted, removed, pending,
                                  services)
        p = self.port.encode_delta(*(to_port(list(x)) for x in
                                     (nodes, upserted, removed, pending,
                                      services)))
        assert (r is None) == (p is None)
        if r is not None:
            assert_snap_equal(r, p)
        return r, p

    def decide(self, snaps, nodes, existing, pending, services=(),
               oracle=True):
        """Port solve == JAX solve (chosen and scores) == serial oracle
        (names); returns the names."""
        r, p = snaps
        jc, js = ref_bs.solve(r)
        pc, ps = bs.solve(p, device="cpu")
        assert np.array_equal(np.asarray(jc), pc)
        assert np.array_equal(np.asarray(js), ps)
        names = bs.decisions_to_names(p, pc)
        assert len(names) == len(pending)
        if oracle:
            policy = (ref_load_policy(self.policy_text)
                      if self.policy_text else None)
            assert names == solve_serial(nodes, existing, pending, services,
                                         policy=policy, gangs=True)
        return names

    def wave(self, nodes, existing, pending, services=()):
        snaps = self.encode(nodes, existing, pending, services)
        return self.decide(snaps, nodes, existing, pending, services)


def bind(pending, names, existing):
    placed = []
    for p, h in zip(pending, names):
        if h:
            p.status.host = h
            existing.append(p)
            placed.append(p)
    return placed


def test_single_wave_matches():
    enc = Pair()
    nodes = [mk_node(f"n{i}") for i in range(4)]
    pending = [mk_pod(f"p{i}", cpu_m=100, mem=64 << 20) for i in range(6)]
    enc.wave(nodes, [], pending)


def test_pod_axis_padding_is_inert():
    """Wave sizes 1..9 share pow-2 buckets; the padding rows are pinned to
    host -2 with zero requests and never place."""
    enc = Pair()
    nodes = [mk_node(f"n{i}") for i in range(3)]
    existing = []
    for wave in (1, 2, 3, 5, 9):
        pending = [mk_pod(f"w{wave}p{i}", cpu_m=50) for i in range(wave)]
        r, p = enc.encode(nodes, existing, pending)
        P = len(p.pod_host_idx)
        assert P == max(1, 1 << (wave - 1).bit_length())
        assert (p.pod_host_idx[wave:] == -2).all()
        assert not p.req[wave:].any()
        pc, _ = bs.solve(p, device="cpu")
        assert (pc[wave:] == -1).all()
        names = enc.decide((r, p), nodes, existing, pending)
        bind(pending, names, existing)


def test_tracks_binds_and_deletes():
    enc = Pair()
    nodes = [mk_node("a", cpu_m=1000, mem=1 << 30),
             mk_node("b", cpu_m=1000, mem=1 << 30)]
    existing = []
    p1 = [mk_pod(f"p{i}", cpu_m=400, mem=128 << 20) for i in range(4)]
    bind(p1, enc.wave(nodes, existing, p1), existing)
    p2 = [mk_pod(f"q{i}", cpu_m=400, mem=128 << 20) for i in range(2)]
    assert enc.wave(nodes, existing, p2) == [None, None]
    del existing[0:2]
    p3 = [mk_pod(f"r{i}", cpu_m=400, mem=128 << 20) for i in range(2)]
    assert None not in enc.wave(nodes, existing, p3)


def test_node_change_triggers_consistent_rebuild():
    enc = Pair()
    nodes = [mk_node("a"), mk_node("b")]
    enc.wave(nodes, [], [mk_pod("p0", cpu_m=100)])
    nodes = nodes + [mk_node("c", labels={"zone": "z2"})]
    got = enc.wave(nodes, [], [mk_pod("p1", cpu_m=100,
                                      node_selector={"zone": "z2"})])
    assert got == ["c"]
    assert enc.port.op_counts["node_rebuilds"] == 2


def test_label_policy_planes():
    enc = Pair(label_presence=((("blessed",), True),),
               label_prefs=(("fast", True, 2),),
               anti_affinity=(("zone", 1),))
    nodes = [mk_node("a", labels={"blessed": "1", "zone": "z1"}),
             mk_node("b", labels={"blessed": "1", "fast": "1", "zone": "z2"}),
             mk_node("c", labels={"zone": "z1"})]
    pending = [mk_pod(f"p{i}", labels={"app": "x"}) for i in range(4)]
    got = enc.wave(nodes, [], pending, [mk_svc("s", {"app": "x"})])
    assert "c" not in got


def test_existing_pod_counts_in_every_matching_group():
    enc = Pair()
    nodes = [mk_node("n0", cpu_m=4000, mem=8 << 30),
             mk_node("n1", cpu_m=4000, mem=8 << 30)]
    services = [mk_svc("s0", {"a": "1"}), mk_svc("s1", {"b": "2"})]
    existing = [mk_pod("both", labels={"a": "1", "b": "2"}, host="n0"),
                mk_pod("load", cpu_m=2000, mem=2 << 30, host="n1")]
    enc.wave(nodes, existing, [mk_pod("warm")], services)
    enc.wave(nodes, existing, [mk_pod("p", labels={"b": "2"})], services)


def test_affinity_policy_rejected():
    with pytest.raises(ValueError, match="CheckServiceAffinity"):
        IncrementalEncoder(BatchPolicy(affinity_labels=("rack",)))
    with pytest.raises(ValueError):
        RefEncoder(RefPolicy(affinity_labels=("rack",)))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_churn(seed):
    rng = random.Random(3000 + seed)
    zones = ["z1", "z2"]
    nodes = [mk_node(f"n{i}", cpu_m=rng.choice([1000, 2000]),
                     mem=rng.choice([2 << 30, 4 << 30]),
                     labels={"zone": rng.choice(zones)}
                     if rng.random() < 0.6 else {},
                     extra={"nvidia.com/gpu": 2} if rng.random() < 0.3
                     else None)
             for i in range(rng.randint(3, 10))]
    sels = [{"app": "a0"}, {"app": "a1"}, {"tier": "web"},
            {"app": "a0", "tier": "web"}]
    services = [mk_svc(f"svc{k}", sels[k])
                for k in range(rng.randint(0, 4))]
    enc = Pair()
    existing = []
    for wave in range(rng.randint(2, 5)):
        pending = []
        for i in range(rng.randint(1, 12)):
            kw = dict(cpu_m=rng.choice([0, 100, 400]),
                      mem=rng.choice([0, 64 << 20, 256 << 20]))
            if rng.random() < 0.4:
                kw["labels"] = {"app": f"a{rng.randint(0, 2)}"}
                if rng.random() < 0.5:
                    kw["labels"]["tier"] = "web"
            if rng.random() < 0.25:
                kw["host_ports"] = (rng.choice([8080, 9090, 7070]),)
            if rng.random() < 0.2:
                kw["node_selector"] = {"zone": rng.choice(zones)}
            if rng.random() < 0.15:
                kw["pds"] = (rng.choice(["pd1", "pd2"]),)
            if rng.random() < 0.2:
                kw["extra"] = {"nvidia.com/gpu": 1}
            if rng.random() < 0.25:
                kw["group"] = f"g{wave}x{rng.randint(0, 1)}"
            pending.append(mk_pod(f"w{wave}p{i}", **kw))
        pending = ref_gang.order_wave(pending)
        bind(pending, enc.wave(nodes, existing, pending, services), existing)
        for _ in range(rng.randint(0, 4)):
            if existing:
                existing.pop(rng.randrange(len(existing)))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_delta(seed):
    """encode_delta fed from churn deltas: both packages' snapshots equal
    field for field, and the decisions equal a fresh full encode's, the
    JAX solve's and the oracle's, wave after wave."""
    rng = random.Random(7000 + seed)
    nodes = [mk_node(f"n{i}", cpu_m=rng.choice([1000, 2000]),
                     labels={"zone": rng.choice(["z1", "z2"])})
             for i in range(rng.randint(3, 8))]
    services = [mk_svc("web", {"app": "web"})]
    enc = Pair()
    existing = []
    enc.encode(nodes, existing, [], services)
    for wave in range(4):
        pending = [mk_pod(f"w{wave}p{i}", cpu_m=rng.choice([0, 100, 400]),
                          labels={"app": "web"} if rng.random() < 0.5
                          else {})
                   for i in range(rng.randint(1, 10))]
        removed = []
        for p in list(existing):
            if rng.random() < 0.15:
                existing.remove(p)
                removed.append(p)
        snaps = enc.encode_delta(nodes, [], removed, pending, services)
        assert snaps[1] is not None
        names = enc.decide(snaps, nodes, existing, pending, services)
        fresh = IncrementalEncoder().encode(
            *(to_port(list(x)) for x in (nodes, existing, pending,
                                         services)))
        fc, _ = bs.solve(fresh, device="cpu")
        assert bs.decisions_to_names(fresh, fc) == names
        ups = bind(pending, names, existing)
        assert enc.encode_delta(nodes, ups, [], [], services)[1] is not None


def test_delta_bails_to_full_on_overflow_and_node_change():
    enc = Pair()
    nodes = [mk_node("n1", cpu_m=500)]
    enc.encode(nodes, [], [])
    over = [mk_pod(f"e{i}", cpu_m=400, host="n1") for i in range(2)]
    # capacity overflow: two 400m pods on a 500m node
    assert enc.encode_delta(nodes, over, [], [])[1] is None
    # the full path encodes it (order-exact greedy walk)
    snaps = enc.encode(nodes, over, [mk_pod("x", cpu_m=50)])
    assert snaps[1].fit_exceeded.tolist() == [True]
    enc.decide(snaps, nodes, over, [mk_pod("x", cpu_m=50)])
    # node-set change: delta refuses
    enc2 = Pair()
    enc2.encode(nodes, [], [])
    assert enc2.encode_delta([mk_node("n2")], [], [], [])[1] is None


def _zone_fixture(n_nodes=16, n_existing=32):
    nodes = [mk_node(f"n{i}", labels={"zone": f"z{i % 4}"} if i % 5 else {})
             for i in range(n_nodes)]
    existing = [mk_pod(f"e{i}", labels={"app": "x"} if i % 2 else {},
                       host=f"n{i % n_nodes}") for i in range(n_existing)]
    return nodes, [mk_svc("s", {"app": "x"})], existing


def test_zone_planes_stay_exact_under_delta_churn():
    """The resident [A, G, V] zone-count planes equal the from-scratch
    derivation and the JAX encoder's after every delta, and the
    decisions equal the full encoder's and the oracle's."""
    enc = Pair(anti_affinity=(("zone", 2),))
    nodes, services, existing = _zone_fixture()
    enc.encode(nodes, existing, [mk_pod("warm", labels={"app": "x"})],
               services)
    zw0 = enc.port.op_counts["zone_writes"]
    rng = random.Random(11)
    for wave in range(3):
        pending = [mk_pod(f"w{wave}p{j}",
                          labels={"app": "x"} if rng.random() < 0.7 else {})
                   for j in range(rng.randint(2, 6))]
        removed = []
        for p in list(existing):
            if rng.random() < 0.1:
                existing.remove(p)
                removed.append(p)
        snaps = enc.encode_delta(nodes, [], removed, pending, services)
        p = snaps[1]
        want = bs.derive_zone_counts(p.node_zone, p.group_counts,
                                     p.zone_counts0.shape[2])
        assert np.array_equal(p.zone_counts0, want)
        names = enc.decide(snaps, nodes, existing, pending, services)
        full = ref_encode(nodes, existing, pending, services,
                          policy=enc.ref.policy)
        jc, _ = ref_bs.solve(full)
        assert ref_bs.decisions_to_names(full, np.asarray(jc)) == names
        for q in bind(pending, names, existing):
            enc.encode_delta(nodes, [q], [], [], services)
    # O(changed): a few single-element writes per changed pod, never a
    # rebuild from the existing list
    assert enc.port.op_counts["node_rebuilds"] == 1
    assert enc.port.op_counts["zone_writes"] - zw0 < 4 * len(existing)


def test_checkpoint_restore_round_trip():
    """restore(checkpoint()) brings back the exact resident state — the
    same fingerprint, the same next wave — after later mutations, and
    stays restorable twice."""
    enc = Pair()
    nodes, services, existing = _zone_fixture(8, 12)
    with pytest.raises(ValueError):
        enc.port.checkpoint()
    enc.encode(nodes, existing, [], services)
    ckpt, fp = enc.port.checkpoint(), enc.port.resident_fingerprint()
    later = [mk_pod("late", cpu_m=300, labels={"app": "x"}, host="n1",
                    host_ports=(8080,))]
    enc.port.encode_delta(*(to_port(x) for x in (nodes, later, [], [],
                                                 services)))
    assert enc.port.resident_fingerprint() != fp
    assert "uid-default-late" in enc.port._pods
    for _ in range(2):
        enc.port.restore(ckpt)
        assert enc.port.resident_fingerprint() == fp
        assert "uid-default-late" not in enc.port._pods
    # the restored encoder and the JAX one (never mutated) stay in step
    pending = [mk_pod(f"q{i}", cpu_m=100, labels={"app": "x"})
               for i in range(3)]
    snaps = enc.encode_delta(nodes, [], [], pending, services)
    enc.decide(snaps, nodes, existing, pending, services)
    # is_noop_upsert: same uid at the same host row; forget_pods rolls an
    # upsert back exactly
    port_e = to_port(existing[0])
    assert enc.port.is_noop_upsert(port_e)
    port_e.status.host = "n7"
    assert not enc.port.is_noop_upsert(port_e)
    def accounted(e):
        # the count planes and the pod registry; vocabularies are sticky
        keep = ("_score_used", "_grp_cnt", "_evict_cnt", "_pods")
        return [x for x in e.resident_fingerprint() if x[0] in keep]

    before = accounted(enc.port)
    enc.port.encode_delta(*(to_port(x) for x in (nodes, later, [], [],
                                                 services)))
    assert accounted(enc.port) != before
    enc.port.forget_pods(["uid-default-late", "uid-absent"])
    assert accounted(enc.port) == before
    # the sticky port vocabulary kept 8080 (one word); the JAX encoder
    # never saw it
    assert enc.port.fill_dims() == dict(enc.ref.fill_dims(), Wp=1)


def _evict_from_scratch(enc, band_prio):
    """The evictable planes re-derived from the encoder's cached pod
    records by derive_evict_planes, the twin the O(bands) maintenance
    must equal."""
    recs = list(enc._pods.values())
    e_req = np.zeros((len(recs), len(enc._resource_names)), np.int64)
    for k, rec in enumerate(recs):
        for r, amt in rec.req:
            e_req[k, r] += amt
    return preempt.derive_evict_planes(
        np.array([rec.host_idx for rec in recs], np.int64),
        np.array([rec.prio for rec in recs], np.int32), e_req, band_prio,
        enc._N)


def test_evict_planes_equal_their_from_scratch_derivation():
    """Once a pending pod sits above the lowest resident priority the
    encoder emits band planes; the O(bands) maintained planes equal
    derive_evict_planes over the cached pods, and the JAX encoder's,
    through binds and deletes — and the port solves each wave as the JAX
    package does, naming the serial preemption oracle's victims from its
    registry."""
    enc = Pair()
    nodes = [mk_node(f"n{i}") for i in range(4)]
    existing = [mk_pod(f"e{i}", cpu_m=200 * (1 + i % 3), host=f"n{i % 4}",
                       priority=[0, 10, 50][i % 3]) for i in range(10)]
    for wave in range(3):
        pending = [mk_pod(f"w{wave}p{i}", cpu_m=100, priority=100)
                   for i in range(2)]
        r, p = enc.encode(nodes, existing, pending)
        assert p.band_prio.size
        cap, cnt = _evict_from_scratch(enc.port, p.band_prio)
        assert np.array_equal(cap, p.evict_cap)
        assert np.array_equal(cnt, p.evict_cnt)
        assert enc.port.resident_on(0) and all(
            isinstance(x, preempt.ResidentPod) for x in
            enc.port.resident_on(0))
        pc, ps = bs.solve(p, device="cpu")
        jc, js = ref_bs.solve(r)
        assert np.array_equal(pc, np.asarray(jc))
        assert np.array_equal(ps, np.asarray(js))
        victims = preempt.assign_victims(pc, ps, p.band_prio,
                                         n_pods=len(pending),
                                         node_pods=enc.port.resident_on)
        names, s_victims = preempt_serial(nodes, existing, pending)
        assert bs.decisions_to_names(p, pc) == names
        assert [sorted(v.uid for v in x or ()) for x in victims] == \
            [sorted(v.uid for v in x or ()) for x in s_victims]
        existing.pop(0)
        existing.append(mk_pod(f"b{wave}", cpu_m=100, host="n2",
                               priority=5 * wave))
