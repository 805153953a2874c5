"""The port's policy extensions and gang waves, on the CPU, against the JAX
package and the serial oracle.

Every extension fixture of test_pallas_solver.py (zone anti-affinity,
service affinity anchors, label preferences, gangs and their rollback,
their combinations and the kitchen sink) is encoded by the JAX package and
carried into the port (``inputs_from_reference``); the port's plain
version must give chosen nodes and winning scores equal exactly
(tolerance 0: decisions are integers) to ``solve_jit`` and to
``solve_pallas(interpret=True)``. The same fixture, converted to the
port's API objects, goes end to end through the port's
``encode_snapshot`` -> ``solve(device="cpu")`` -> ``decisions_to_names``
and must name the hosts ``oracle.solve_serial(policy=..., gangs=True)``
names, the Policy given to both as one JSON file.
"""

import dataclasses
import json
import random

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

import bench
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.api.quantity import Quantity as RefQuantity
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.oracle import solve_serial
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.policy import UnsupportedPolicy as RefUnsupported
from kubernetes_tpu.models.policy import batch_policy_from as ref_policy_from
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.ops import pallas_solver
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu_torch.api import types as port_api
from kubernetes_tpu_torch.api.quantity import Quantity as PortQuantity
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import fixtures, gang
from kubernetes_tpu_torch.models.carry import inputs_from_reference
from kubernetes_tpu_torch.models.policy import (BatchPolicy,
                                                UnsupportedPolicy,
                                                batch_policy_from)
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.scheduler.plugins import load_policy
from test_pallas_solver import aff_wave, fuzz_wave, mk_gang_pod, mk_node, \
    mk_pod

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)


def to_port(obj):
    """A JAX-package API object (tree) -> the port's, field for field."""
    if isinstance(obj, RefQuantity):
        return PortQuantity(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(port_api, type(obj).__name__)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.name in names})
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    return obj


def policy_json(pol: RefPolicy) -> str:
    """The JSON Policy file whose batch form is ``pol``."""
    preds = [{"name": name} for name, on in (
        ("PodFitsPorts", pol.use_ports),
        ("PodFitsResources", pol.use_resources),
        ("NoDiskConflict", pol.use_disk),
        ("MatchNodeSelector", pol.use_selector),
        ("HostName", pol.use_host)) if on]
    for i, (labels, presence) in enumerate(pol.label_presence):
        preds.append({"name": f"presence{i}", "argument": {"labelsPresence": {
            "labels": list(labels), "presence": presence}}})
    if pol.affinity_labels:
        preds.append({"name": "affinity", "argument": {"serviceAffinity": {
            "labels": list(pol.affinity_labels)}}})
    prios = [{"name": name, "weight": w} for name, w in (
        ("LeastRequestedPriority", pol.w_lr),
        ("ServiceSpreadingPriority", pol.w_spread),
        ("EqualPriority", pol.w_equal)) if w]
    for i, (label, w) in enumerate(pol.anti_affinity):
        prios.append({"name": f"anti{i}", "weight": w, "argument": {
            "serviceAntiAffinity": {"label": label}}})
    for i, (label, presence, w) in enumerate(pol.label_prefs):
        prios.append({"name": f"pref{i}", "weight": w, "argument": {
            "labelPreference": {"label": label, "presence": presence}}})
    return json.dumps({"predicates": preds, "priorities": prios})


# -- the extension fixtures of test_pallas_solver.py (each -> wave, policy,
# gangs) -------------------------------------------------------------------

def _svc(name, app):
    return ref_api.Service(
        metadata=ref_api.ObjectMeta(name=name, namespace="default"),
        spec=ref_api.ServiceSpec(port=80, selector={"app": app}))


def f_anti_affinity(seed):
    return (fuzz_wave(500 + seed),
            RefPolicy(w_lr=1, w_spread=0, anti_affinity=(("zone", 2),)),
            False)


def f_anti_affinity_unlabeled():
    nodes = [mk_node(f"n-{i}", labels={"zone": f"z{i % 2}"} if i < 4 else {})
             for i in range(8)]
    existing = [mk_pod("old-0", cpu_m=100, host="n-0", labels={"app": "a0"})]
    pending = [mk_pod(f"new-{i}", cpu_m=100, labels={"app": "a0"})
               for i in range(6)]
    return ((nodes, existing, pending, [_svc("s0", "a0")]),
            RefPolicy(w_lr=1, anti_affinity=(("zone", 2),)), False)


def _gang_wave(rng, n_nodes, n_groups, sizes, labels, solo_always,
               solo_cpu_hi=2000):
    nodes = [mk_node(f"n-{i:03d}", cpu_m=rng.choice([2000, 4000]),
                     labels=labels(i)) for i in range(n_nodes)]
    pending = []
    for g in range(n_groups):
        size = rng.choice(sizes)
        # some groups oversubscribe on purpose so rollback paths fire
        cpu = rng.choice([700, 1500, 3800])
        for m in range(size):
            pending.append(mk_gang_pod(f"g{g}-m{m}", f"grp-{g}", size,
                                       cpu_m=cpu))
        if solo_always or rng.random() < 0.5:
            pending.append(mk_pod(f"solo-{g}",
                                  cpu_m=rng.randrange(0, solo_cpu_hi, 100),
                                  labels={"app": "g"}))
    return nodes, [], pending, [_svc("sg", "g")]


def f_gang(seed):
    rng = random.Random(1000 + seed)
    return (_gang_wave(rng, 9, 5, [2, 3, 4], lambda i: {}, False),
            RefPolicy(), True)


def f_gang_rollback():
    nodes = [mk_node("n-0", cpu_m=2000)]
    pending = [mk_gang_pod(f"g-m{m}", "grp", 3, cpu_m=900)
               for m in range(3)] + [mk_pod("solo", cpu_m=1800)]
    return (nodes, [], pending, []), RefPolicy(), True


def f_gang_anti_affinity(seed):
    rng = random.Random(2000 + seed)
    return (_gang_wave(rng, 9, 5, [2, 3], lambda i: {"zone": f"z{i % 3}"},
                       True, 1500),
            RefPolicy(w_lr=1, anti_affinity=(("zone", 2),)), True)


def f_label_prefs(seed):
    rng = random.Random(3000 + seed)
    nodes = [mk_node(f"n-{i:03d}", cpu_m=rng.choice([2000, 4000]),
                     labels=({"disk": "ssd"} if i % 3 == 0 else {}))
             for i in range(9)]
    _, existing, pending, services = fuzz_wave(3000 + seed, n_nodes=9)
    return ((nodes, existing, pending, services),
            RefPolicy(w_lr=1, label_prefs=(("disk", True, 2),
                                           ("gpu", False, 1))), False)


def f_service_affinity(seed):
    return (aff_wave(4000 + seed, with_existing=seed % 2 == 0),
            RefPolicy(w_lr=1, affinity_labels=("region",)), False)


def f_service_affinity_two_labels():
    return (aff_wave(4100),
            RefPolicy(w_lr=1, affinity_labels=("region", "rack")), False)


def f_service_affinity_anchor():
    nodes = [mk_node("n-0", cpu_m=8000, labels={"region": "r0"}),
             mk_node("n-1", cpu_m=2000, labels={"region": "r1"})]
    pending = [mk_pod("p-0", cpu_m=500, labels={"app": "a"},
                      selector={"region": "r0"}),
               mk_pod("p-1", cpu_m=500, labels={"app": "a"})]
    return ((nodes, [], pending, [_svc("s0", "a")]),
            RefPolicy(w_lr=1, affinity_labels=("region",)), False)


def f_service_affinity_unknown_anchor():
    # a peer on a host that is not a node poisons only the pods that
    # consult that anchor (the -100 marker)
    nodes = [mk_node("a1", labels={"zone": "za"}),
             mk_node("b1", labels={"zone": "zb"})]
    existing = [mk_pod("ghost", labels={"app": "web"}, host="gone")]
    pending = [mk_pod("w0", labels={"app": "web"}),
               mk_pod("w1", labels={"app": "web"}, selector={"zone": "zb"}),
               mk_pod("other", labels={"app": "x"})]
    return ((nodes, existing, pending, [_svc("web", "web")]),
            RefPolicy(w_lr=1, affinity_labels=("zone",)), False)


def f_label_presence():
    nodes = [mk_node(f"n{i}", labels={"ssd": "true"} if i % 2 else {})
             for i in range(5)]
    pending = [mk_pod(f"p{i}", cpu_m=300) for i in range(6)]
    return ((nodes, [], pending, []),
            RefPolicy(w_lr=1, label_presence=((("ssd",), True),)), False)


def f_gang_affinity(seed):
    rng = random.Random(5000 + seed)
    return (_gang_wave(rng, 7, 4, [2, 3], lambda i: {"region": f"r{i % 2}"},
                       True, 1500),
            RefPolicy(w_lr=1, affinity_labels=("region",)), True)


def f_gang_affinity_prefs():
    rng = random.Random(7000)
    return (_gang_wave(rng, 7, 4, [2, 3], lambda i: {"region": f"r{i % 2}"},
                       True, 1500),
            RefPolicy(w_lr=1, affinity_labels=("region",),
                      label_prefs=(("region", True, 1),)), True)


def f_kitchen_sink(seed):
    nodes, existing, pending, services = aff_wave(6000 + seed, n_nodes=11)
    for i, n in enumerate(nodes):
        n.metadata.labels["zone"] = f"z{i % 3}"
        if i % 4 == 0:
            n.metadata.labels["disk"] = "ssd"
    return ((nodes, existing, pending, services),
            RefPolicy(w_lr=1, w_spread=1, affinity_labels=("region",),
                      anti_affinity=(("zone", 2),),
                      label_prefs=(("disk", True, 1),)), False)


FIXTURES = {}
for _s in range(4):
    FIXTURES[f"anti_affinity_{_s}"] = lambda s=_s: f_anti_affinity(s)
    FIXTURES[f"gang_{_s}"] = lambda s=_s: f_gang(s)
    FIXTURES[f"label_prefs_{_s}"] = lambda s=_s: f_label_prefs(s)
for _s in range(6):
    FIXTURES[f"service_affinity_{_s}"] = lambda s=_s: f_service_affinity(s)
for _s in range(3):
    FIXTURES[f"gang_anti_affinity_{_s}"] = \
        lambda s=_s: f_gang_anti_affinity(s)
    FIXTURES[f"gang_affinity_{_s}"] = lambda s=_s: f_gang_affinity(s)
    FIXTURES[f"kitchen_sink_{_s}"] = lambda s=_s: f_kitchen_sink(s)
FIXTURES.update({f.__name__[2:]: f for f in (
    f_anti_affinity_unlabeled, f_gang_rollback, f_service_affinity_two_labels,
    f_service_affinity_anchor, f_service_affinity_unknown_anchor,
    f_label_presence, f_gang_affinity_prefs)})


def _port_policy(pol: RefPolicy) -> BatchPolicy:
    return BatchPolicy(**dataclasses.asdict(pol))


def _solve_three(wave, pol, gangs):
    """-> (port plain, solve_jit, solve_pallas interpret) decisions."""
    snap = ref_encode(*wave, policy=pol)
    assert snap.has_gangs == gangs
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    ppol = _port_policy(pol)
    peers = ref_bs.peer_bound_of(snap)
    # every fixture is inside both kernels' domain
    assert commit_solver.eligible(inp, ppol, peers)
    rinp = ref_bs.snapshot_to_inputs(snap)
    assert pallas_solver.eligible(rinp, pol, gangs, peers)
    port = tuple(t.numpy() for t in commit_solver.solve_commit_reference(
        commit_solver.prepare(inp, ppol, gangs)))
    jit = tuple(np.asarray(t) for t in ref_bs.solve_jit(
        rinp, pol=pol, gangs=gangs))
    pallas = tuple(np.asarray(t) for t in pallas_solver.solve_pallas(
        rinp, pol=pol, interpret=True, gangs=gangs))
    return port, jit, pallas


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_matches_solve_jit_and_pallas(name):
    wave, pol, gangs = FIXTURES[name]()
    port, jit, pallas = _solve_three(wave, pol, gangs)
    for what, ref in (("solve_jit", jit), ("solve_pallas", pallas)):
        assert np.array_equal(port[0], ref[0]), \
            f"chosen vs {what}: {port[0]} vs {ref[0]}"
        assert np.array_equal(port[1], ref[1]), \
            f"scores vs {what}: {port[1]} vs {ref[1]}"


def _end_to_end(wave, pol, gangs, oracle=True):
    """The port's whole path (JSON Policy -> batch_policy_from ->
    encode_snapshot -> solve -> names) against the oracle and the JAX
    package's solve."""
    text = policy_json(pol)
    ppol = batch_policy_from(policy=load_policy(text))
    assert ppol == _port_policy(pol)
    psnap = encode_snapshot(*to_port(wave), policy=ppol)
    pc, ps = bs.solve(psnap, device="cpu")
    names = bs.decisions_to_names(psnap, pc)
    if oracle:
        assert names == solve_serial(*wave, policy=ref_load_policy(text),
                                     gangs=gangs)
    jc, js = ref_bs.solve(ref_encode(*wave, policy=pol))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    return pc, names


# the serial scheduler raises a node lookup error on a pod that consults an
# anchor on an unknown host (the scheduler requeues it); the oracle cannot run
# that wave, so it is held against the JAX package's solve alone
NO_ORACLE = {"service_affinity_unknown_anchor"}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_end_to_end_matches_oracle(name):
    _end_to_end(*FIXTURES[name](), oracle=name not in NO_ORACLE)


def test_gang_rollback_frees_the_node_for_the_singleton():
    wave, pol, gangs = f_gang_rollback()
    port, _, _ = _solve_three(wave, pol, gangs)
    # members 0 and 1 chose n-0 tentatively, member 2 found nothing, and
    # the singleton got the whole node back
    assert port[0].tolist() == [0, 0, -1, 0]
    pc, names = _end_to_end(wave, pol, gangs)
    assert names == [None, None, None, "n-0"]
    assert pc.tolist() == [-1, -1, -1, 0]


def test_unknown_anchor_fails_only_the_consulting_pod():
    wave, pol, gangs = f_service_affinity_unknown_anchor()
    _, names = _end_to_end(wave, pol, gangs, oracle=False)
    # w0 consults the off-list anchor; w1 pins zone by selector and so
    # consults nothing; "other" has another service
    assert names[0] is None
    assert names[1] == "b1" and names[2] is not None


def test_anchor_pulls_later_peer():
    wave, pol, gangs = f_service_affinity_anchor()
    port, _, _ = _solve_three(wave, pol, gangs)
    assert port[0].tolist() == [0, 0]


# -- the JSON Policy ----------------------------------------------------------

def _random_policy_json(rng: random.Random) -> str:
    """test_policy_solver._random_policy's generator, as JSON."""
    preds = []
    for name in ("PodFitsPorts", "PodFitsResources", "NoDiskConflict",
                 "MatchNodeSelector", "HostName"):
        if rng.random() < 0.7:
            preds.append({"name": name})
    if rng.random() < 0.4:
        preds.append({"name": "label_req", "argument": {"labelsPresence": {
            "labels": ["ssd"], "presence": rng.random() < 0.5}}})
    if rng.random() < 0.5:
        labels = rng.choice([["zone"], ["zone", "rack"]])
        preds.append({"name": "aff",
                      "argument": {"serviceAffinity": {"labels": labels}}})
    prios = []
    for name in ("LeastRequestedPriority", "ServiceSpreadingPriority",
                 "EqualPriority"):
        if rng.random() < 0.7:
            prios.append({"name": name, "weight": rng.randint(0, 3)})
    if rng.random() < 0.5:
        prios.append({"name": "zone_anti", "weight": rng.randint(0, 3),
                      "argument": {"serviceAntiAffinity": {"label": "zone"}}})
    if rng.random() < 0.4:
        prios.append({"name": "pref", "weight": rng.randint(0, 2),
                      "argument": {"labelPreference": {
                          "label": "ssd", "presence": rng.random() < 0.5}}})
    return json.dumps({"predicates": preds, "priorities": prios})


@pytest.mark.parametrize("seed", range(12))
def test_load_policy_round_trip_matches_reference(seed):
    text = _random_policy_json(random.Random(1000 + seed))
    port = load_policy(text)
    ref = ref_load_policy(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(batch_policy_from(policy=port)) == \
        dataclasses.asdict(ref_policy_from(policy=ref))


def test_affinity_policy_json_matches_bench_policy():
    port = load_policy(fixtures.AFFINITY_POLICY_JSON)
    assert dataclasses.asdict(port) == dataclasses.asdict(
        fixtures.affinity_policy())
    assert dataclasses.asdict(port) == dataclasses.asdict(
        bench.affinity_policy())
    bp = batch_policy_from(policy=port)
    assert bp.anti_affinity == (("zone", 2),) and bp.w_lr == 1
    assert (bp.w_spread, bp.w_equal) == (0, 0)


def _bp(text):
    return batch_policy_from(policy=load_policy(text))


def test_policy_predicates_keyed_by_name_later_entry_wins():
    bp = _bp('{"predicates": [{"name": "p", "argument": {"serviceAffinity":'
             ' {"labels": ["zone"]}}}, {"name": "p", "argument": '
             '{"labelsPresence": {"labels": ["ssd"], "presence": false}}}],'
             ' "priorities": []}')
    assert bp.affinity_labels == ()
    assert bp.label_presence == ((("ssd",), False),)
    assert not (bp.use_ports or bp.use_resources or bp.use_disk
                or bp.use_selector or bp.use_host)


def test_policy_priority_weights_sum():
    bp = _bp('{"predicates": [], "priorities": ['
             '{"name": "LeastRequestedPriority", "weight": 2},'
             '{"name": "LeastRequestedPriority", "weight": 3},'
             '{"name": "EqualPriority", "weight": 1}]}')
    assert (bp.w_lr, bp.w_spread, bp.w_equal) == (5, 0, 1)
    assert not bp.all_infeasible


def test_policy_empty_priorities_mean_equal_priority():
    bp = _bp('{"predicates": [{"name": "PodFitsResources"}],'
             ' "priorities": []}')
    assert (bp.w_lr, bp.w_spread, bp.w_equal) == (0, 0, 1)
    assert bp.use_resources and not bp.all_infeasible


def test_policy_all_zero_weights_is_all_infeasible():
    bp = _bp('{"predicates": [], "priorities": [{"name": "zone", "weight": 0,'
             ' "argument": {"serviceAntiAffinity": {"label": "zone"}}}]}')
    assert bp.all_infeasible and bp.anti_affinity == ()


@pytest.mark.parametrize("text", [
    '{"predicates": [], "priorities": [{"name": "LeastRequestedPriority",'
    ' "weight": -1}]}',
    '{"predicates": [{"name": "SomebodysCustomPredicate"}], "priorities": []}',
    '{"predicates": [], "priorities": [{"name": "Mystery", "weight": 2}]}'])
def test_policy_unsupported_raises_like_reference(text):
    with pytest.raises(UnsupportedPolicy):
        _bp(text)
    with pytest.raises(RefUnsupported):
        ref_policy_from(policy=ref_load_policy(text))


# -- random policies x random clusters, end to end ---------------------------

def _random_cluster(rng: random.Random, n_nodes=14, n_existing=20,
                    n_pending=24, n_services=5):
    """test_policy_solver._random_cluster's generator."""
    zones, racks = ["z0", "z1", "z2"], ["r0", "r1"]
    nodes = []
    for i in range(n_nodes):
        labels = {}
        if rng.random() < 0.8:
            labels["zone"] = rng.choice(zones)
        if rng.random() < 0.6:
            labels["rack"] = rng.choice(racks)
        if rng.random() < 0.4:
            labels["ssd"] = "true"
        nodes.append(mk_node(f"n{i:02d}", cpu_m=rng.choice([2000, 4000]),
                             mem=rng.choice([4 << 30, 8 << 30]),
                             labels=labels))
    services = [_svc(f"s{k}", f"a{k}") for k in range(n_services)]

    def rand_pod(name, hosted):
        labels = ({"app": f"a{rng.randrange(n_services)}"}
                  if rng.random() < 0.8 else {})
        selector = {}
        if rng.random() < 0.25:
            selector["zone"] = rng.choice(zones)
        if rng.random() < 0.1:
            selector["rack"] = rng.choice(racks)
        host = nodes[rng.randrange(n_nodes)].metadata.name if hosted else ""
        return mk_pod(name, cpu_m=rng.choice([100, 250, 500, 1000]),
                      mem=rng.choice([64, 128, 512]) << 20, labels=labels,
                      selector=selector, host=host,
                      ports=[8000 + rng.randrange(4)]
                      if not hosted and rng.random() < 0.15 else ())

    existing = [rand_pod(f"e{i:03d}", True) for i in range(n_existing)]
    pending = [rand_pod(f"p{i:03d}", False) for i in range(n_pending)]
    return nodes, existing, pending, services


@pytest.mark.parametrize("seed", range(12))
def test_random_policy_end_to_end_matches_oracle(seed):
    rng = random.Random(1000 + seed)
    wave = _random_cluster(rng)
    text = _random_policy_json(rng)
    try:
        ppol = batch_policy_from(policy=load_policy(text))
    except UnsupportedPolicy:
        pytest.fail("the generator only emits modeled plugins")
    psnap = encode_snapshot(*to_port(wave), policy=ppol)
    pc, ps = bs.solve(psnap, device="cpu")
    assert bs.decisions_to_names(psnap, pc) == solve_serial(
        *wave, policy=ref_load_policy(text))
    jc, js = ref_bs.solve(ref_encode(
        *wave, policy=ref_policy_from(policy=ref_load_policy(text))))
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))


# -- the affinity and gang shapes at reduced depth ----------------------------

def test_affinity_shape_reduced_matches_solve_jit_and_oracle():
    # bench.py's `affinity` shape (5,000 x 5,000) cut to 60 x 100
    text = fixtures.FULL_SHAPES["affinity"][3]
    ppol = batch_policy_from(policy=load_policy(text))
    psnap = encode_snapshot(*fixtures.build_cluster(60, 100), policy=ppol)
    pc, ps = bs.solve(psnap, device="cpu")
    ref_wave = bench.build_cluster(60, 100)
    rpol = ref_policy_from(policy=ref_load_policy(text))
    jsnap = ref_encode(*ref_wave, policy=rpol)
    jc, js = ref_bs.solve_jit(ref_bs.snapshot_to_inputs(jsnap), pol=rpol)
    assert np.array_equal(pc, np.asarray(jc))
    assert np.array_equal(ps, np.asarray(js))
    names = bs.decisions_to_names(psnap, pc)
    assert None not in names
    assert names == solve_serial(*ref_wave, policy=ref_load_policy(text))


def test_gang_shape_reduced_matches_solve_jit_and_oracle():
    # bench.py's `gang` shape (1,000 groups x 8 on 2,000 nodes) cut to 10
    # groups x 8 on 40 nodes
    kw = {"gang_groups": 10, "gang_size": 8}
    psnap = encode_snapshot(*fixtures.build_cluster(40, 0, **kw))
    assert psnap.has_gangs
    pc, ps = bs.solve(psnap, device="cpu")
    ref_wave = bench.build_cluster(40, 0, **kw)
    jsnap = ref_encode(*ref_wave)
    jc, js = ref_bs.solve_jit(ref_bs.snapshot_to_inputs(jsnap),
                              pol=jsnap.policy, gangs=True)
    jc = gang.apply_all_or_nothing(jsnap.pod_rid, np.asarray(jc))
    assert np.array_equal(pc, jc)
    assert np.array_equal(ps[pc >= 0], np.asarray(js)[jc >= 0])
    names = bs.decisions_to_names(psnap, pc)
    assert None not in names
    assert names == solve_serial(*ref_wave, gangs=True)


def test_gang_helpers_match_reference():
    from kubernetes_tpu.models import gang as ref_gang
    pods = [mk_gang_pod("a0", "A", 2), mk_pod("s"), mk_gang_pod("b0", "B", 3),
            mk_gang_pod("a1", "A", 2), mk_gang_pod("b1", "B", "x")]
    port_pods = to_port(pods)
    assert [p.metadata.name for p in gang.order_wave(port_pods)] == \
        [p.metadata.name for p in ref_gang.order_wave(pods)]
    assert [gang.gang_min_members(p) for p in port_pods] == \
        [ref_gang.gang_min_members(p) for p in pods]
    rid = np.array([0, 0, -1, 1, 1, 1], np.int32)
    chosen = np.array([3, 4, -1, 2, -1, 5], np.int32)
    assert np.array_equal(gang.apply_all_or_nothing(rid, chosen),
                          ref_gang.apply_all_or_nothing(rid, chosen))
