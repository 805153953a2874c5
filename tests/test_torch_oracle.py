"""The port's serial oracle (``kubernetes_tpu_torch/models/oracle.py``)
against the JAX package's, output for output.

Each fixture is built twice from one numpy seed, through each package's
own API types (``test_torch_batch_solver.Kit``), and run through both
packages' ``solve_serial``, ``preempt_serial``, ``explain_serial`` and
``defrag_serial``. The fixtures cover the default provider, a JSON Policy
with service-affinity anchors, zone anti-affinity and a label preference,
gangs (with rollback), two priority bands with preemption, unschedulable
pods, and cordoned nodes and an under-used tail for the defrag rule.
Node names, victim sets, per-reason counts, moves and scores must be
equal; the tolerance is exact.
"""

import json

import numpy as np
import pytest

from kubernetes_tpu.models import defrag as ref_defrag
from kubernetes_tpu.models import oracle as ref_oracle
from kubernetes_tpu.scheduler.plugins import load_policy as ref_load_policy
from kubernetes_tpu_torch.models import defrag
from kubernetes_tpu_torch.models import oracle
from kubernetes_tpu_torch.scheduler.plugins import load_policy
from test_torch_batch_solver import PORT, REF

SEEDS = range(4)

POLICY = json.dumps({
    "predicates": [
        {"name": "PodFitsPorts"}, {"name": "PodFitsResources"},
        {"name": "NoDiskConflict"}, {"name": "MatchNodeSelector"},
        {"name": "HostName"},
        {"name": "aff", "argument": {"serviceAffinity": {
            "labels": ["region"]}}}],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "ServiceSpreadingPriority", "weight": 1},
        {"name": "zone_anti", "weight": 2, "argument": {
            "serviceAntiAffinity": {"label": "zone"}}},
        {"name": "pref", "weight": 1, "argument": {"labelPreference": {
            "label": "disk", "presence": True}}}]})


def _nodes(k, rng, n, cordon=0.0):
    return [k.node(f"n{i:02d}", cpu_m=int(rng.choice([1000, 2000, 4000])),
                   mem=int(rng.choice([2, 4, 8])) << 30,
                   labels={"zone": f"z{i % 3}", "region": f"r{i % 2}",
                           **({"disk": "ssd"} if i % 4 == 0 else {})},
                   unschedulable=bool(rng.random() < cordon))
            for i in range(n)]


def default_wave(k, seed):
    """Default provider: resources, host ports, selectors, PDs, services,
    and pods no node can take (too big, or a selector nothing matches)."""
    rng = np.random.default_rng(seed)
    nodes = _nodes(k, rng, 9)
    apps = ["a", "b", "c"]
    existing = [k.pod(f"e{i}", cpu_m=int(rng.integers(1, 6)) * 100,
                      mem=int(rng.integers(1, 4)) << 28,
                      host=f"n{int(rng.integers(9)):02d}",
                      labels={"app": apps[i % 3]},
                      host_ports=(8080,) if i % 5 == 0 else ())
                for i in range(14)]
    pending = []
    for i in range(24):
        kind = int(rng.integers(8))
        pending.append(k.pod(
            f"p{i}", cpu_m=(9000 if kind == 0 else
                            int(rng.integers(1, 10)) * 100),
            mem=int(rng.integers(1, 4)) << 28,
            labels={"app": apps[int(rng.integers(3))]},
            node_selector=({"zone": "nowhere"} if kind == 1 else
                           {"zone": f"z{int(rng.integers(3))}"}
                           if kind == 2 else None),
            host_ports=(8080,) if kind == 3 else (),
            pds=(f"pd{int(rng.integers(2))}",) if kind == 4 else ()))
    services = [k.svc(f"s{a}", {"app": a}) for a in apps]
    return nodes, existing, pending, services


def gang_wave(k, seed):
    """Gangs of 2-4 members, some too big to place whole (rollback), and
    singletons between them."""
    from kubernetes_tpu_torch.models import gang
    rng = np.random.default_rng(100 + seed)
    nodes = _nodes(k, rng, 6)
    pending = []
    for g in range(5):
        size = int(rng.integers(2, 5))
        cpu = int(rng.choice([600, 1500, 3800]))
        ann = {gang.GANG_NAME_ANNOTATION: f"grp-{g}",
               gang.GANG_MIN_MEMBERS_ANNOTATION: str(size)}
        pending += [k.pod(f"g{g}m{m}", cpu_m=cpu, annotations=dict(ann),
                          labels={"app": "g"}) for m in range(size)]
        pending.append(k.pod(f"solo{g}", cpu_m=int(rng.integers(1, 15)) * 100,
                             labels={"app": "g"}))
    return nodes, [], pending, [k.svc("sg", {"app": "g"})]


def priority_wave(k, seed):
    """A full cluster in two priority bands (10 and 100), pending pods of
    1000, 50, 0 and a Never-preempting 1000 — some preempt, some cannot."""
    rng = np.random.default_rng(200 + seed)
    nodes = [k.node(f"n{i:02d}", cpu_m=2000) for i in range(5)]
    existing = [k.pod(f"e{i}", cpu_m=int(rng.choice([400, 600, 1000])),
                      host=f"n{i % 5:02d}",
                      priority=int(rng.choice([10, 100])))
                for i in range(12)]
    pending = [k.pod(f"p{i}", cpu_m=int(rng.choice([500, 900, 1900, 2500])),
                     priority=int(rng.choice([1000, 50, 0])))
               for i in range(10)]
    never = k.pod("never", cpu_m=1500, priority=1000)
    never.spec.preemption_policy = k.api.PreemptNever
    return nodes, existing, pending + [never], []


def defrag_cluster(k, seed):
    """An under-used tail next to well-used nodes, two cordoned nodes, and
    pods the rule must not move (kube-system, do-not-disrupt, gangs)."""
    from kubernetes_tpu_torch.models import gang
    rng = np.random.default_rng(300 + seed)
    nodes = _nodes(k, rng, 10)
    for i in (2, 7):
        nodes[i].spec.unschedulable = True
    existing = []
    for i in range(26):
        host = f"n{int(rng.integers(10)):02d}"
        ns = "kube-system" if i % 11 == 0 else "default"
        ann = {}
        if i % 7 == 0:
            ann[defrag.DO_NOT_DISRUPT_ANNOTATION] = "true"
        if i % 9 == 0:
            ann[gang.GANG_NAME_ANNOTATION] = "grp"
        existing.append(k.pod(f"e{i}", ns=ns, host=host, annotations=ann,
                              cpu_m=int(rng.integers(1, 6)) * 100,
                              mem=int(rng.integers(1, 4)) << 28,
                              priority=int(rng.choice([0, 10]))))
    return nodes, existing, [k.svc("s", {"app": "x"})]


def _plain(x):
    """Both packages' results as plain Python values."""
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.integer):
        return int(x)
    return x


def _both(wave_fn, seed):
    return wave_fn(PORT, seed), wave_fn(REF, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("wave_fn,policy", [
    (default_wave, None), (default_wave, POLICY), (gang_wave, None),
    (gang_wave, POLICY), (priority_wave, None)],
    ids=["default", "policy", "gang", "gang-policy", "priority"])
def test_solve_serial_equals_reference(wave_fn, policy, seed):
    port, ref = _both(wave_fn, seed)
    gangs = wave_fn is gang_wave
    pk = {"policy": load_policy(policy)} if policy else {}
    rk = {"policy": ref_load_policy(policy)} if policy else {}
    got = oracle.solve_serial(*port, gangs=gangs, **pk)
    assert got == ref_oracle.solve_serial(*ref, gangs=gangs, **rk)
    if wave_fn is default_wave:
        assert None in got and set(got) != {None}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("wave_fn", [priority_wave, default_wave],
                         ids=["priority", "default"])
def test_preempt_serial_equals_reference(wave_fn, seed):
    port, ref = _both(wave_fn, seed)
    got = _plain(oracle.preempt_serial(*port))
    want = _plain(ref_oracle.preempt_serial(*ref))
    assert got == want
    if wave_fn is priority_wave:
        assert any(v for v in got[1]), "no pod preempted"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("wave_fn,policy", [
    (default_wave, None), (default_wave, POLICY), (priority_wave, None)],
    ids=["default", "policy", "priority"])
def test_explain_serial_equals_reference(wave_fn, policy, seed):
    port, ref = _both(wave_fn, seed)
    pk = {"policy": load_policy(policy)} if policy else {}
    rk = {"policy": ref_load_policy(policy)} if policy else {}
    got = _plain(oracle.explain_serial(*port, **pk))
    want = _plain(ref_oracle.explain_serial(*ref, **rk))
    assert got == want
    assert any(d is not None for d in got[1]), "no pod to explain"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_moves", [0, 3, 50])
def test_defrag_serial_equals_reference(seed, max_moves):
    port, ref = _both(defrag_cluster, seed)
    got = _plain(oracle.defrag_serial(
        *port, cfg=defrag.DefragConfig(max_moves=max_moves)))
    want = _plain(ref_oracle.defrag_serial(
        *ref, cfg=ref_defrag.DefragConfig(max_moves=max_moves)))
    assert got == want
    assert any(m["mandatory"] for m in got[0]), "no cordon-drain move"


def test_deepcopy_of_port_objects_matches_reference():
    """The oracle copies API objects with ``copy.deepcopy`` (the
    preemption walk's committed state); a port object copies to an equal,
    independent tree, as a reference object does."""
    import copy
    import dataclasses
    for (nodes, existing, pending, _), k in zip(
            _both(default_wave, 0), (PORT, REF)):
        for obj in nodes + existing + pending:
            dup = copy.deepcopy(obj)
            assert dup == obj and dup is not obj
            dup.metadata.labels["copied"] = "1"
            assert "copied" not in obj.metadata.labels
            assert type(dup) is getattr(k.api, type(obj).__name__)
            assert [f.name for f in dataclasses.fields(dup)] == \
                [f.name for f in dataclasses.fields(obj)]


def test_chip_smoke_oracle_phase_runs_on_the_cpu():
    """chip_smoke.py phase 11 at a small size on the plain version: the
    four comparisons against the oracle (in two spawned workers), every
    part compared some pods."""
    import chip_smoke as cs
    o = cs._oracle_phase(
        "cpu", n_nodes=40, ns_pods=30,
        ext=cs._ORACLE_EXT[:4] + [(401, 60, 40, dict(gangs=True, anti=1,
                                                     aff=2))],
        pre=cs._ORACLE_PRE[:3], n_pending=200, n_extra=16, workers=2,
        count_launches=False)
    assert {k: p["waves"] for k, p in o["parts"].items()} == \
        {"ext": 5, "north_star": 1, "pre": 3, "explain": 1}
    assert o["parts"]["explain"]["pods"] == 16
    assert all(p["oracle_s"] > 0 for p in o["parts"].values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_moves", [3, 50])
def test_defrag_wave_equals_its_oracle_and_the_reference(seed, max_moves):
    """The dense defrag wave (``models/defrag.py``, through both of the
    port's encoders) == the port's ``defrag_serial`` == the reference's
    wave: moves, candidates and every score."""
    from kubernetes_tpu.models.incremental import IncrementalEncoder as RefEnc
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    port, ref = _both(defrag_cluster, seed)
    cfg = defrag.DefragConfig(max_moves=max_moves)
    rcfg = ref_defrag.DefragConfig(max_moves=max_moves)
    o_moves, *o_scores = oracle.defrag_serial(*port, cfg=cfg)
    for enc in (None, IncrementalEncoder()):
        plan, cand, moves = defrag.defrag_wave(*port, cfg=cfg, encoder=enc)
        assert moves == o_moves
        assert [plan.score_before, plan.score_mandatory,
                plan.score_after] == o_scores
    r_plan, r_cand, r_moves = ref_defrag.defrag_wave(*ref, cfg=rcfg,
                                                     encoder=RefEnc())
    assert _plain(moves) == _plain(r_moves)
    assert [p.metadata.uid for p in cand.pods] == \
        [p.metadata.uid for p in r_cand.pods]
    assert (plan.score_before, plan.score_mandatory, plan.score_after,
            plan.voluntary_dropped) == \
        (r_plan.score_before, r_plan.score_mandatory, r_plan.score_after,
         r_plan.voluntary_dropped)
    assert np.array_equal(plan.target, r_plan.target)
