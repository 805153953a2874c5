"""The port's encode_snapshot and host inputs against the JAX package's.

Each wave is built twice from the same seed, through each package's own
API types, and encoded by each package; every array the port's snapshot
and host inputs hold must equal the JAX one exactly (dtype, shape and
values), and so must the name lists.
"""

import dataclasses

import numpy as np
import pytest

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from test_torch_batch_solver import PORT, REF, WAVES
from test_torch_policy import FIXTURES, to_port


def _assert_same(port, ref, fields, what):
    for f in fields:
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(a, np.ndarray):
            b = np.asarray(b)
            assert a.dtype == b.dtype, f"{what}.{f}: {a.dtype} vs {b.dtype}"
            assert a.shape == b.shape, f"{what}.{f}: {a.shape} vs {b.shape}"
            assert np.array_equal(a, b), f"{what}.{f} differs"
        else:
            assert a == b, f"{what}.{f}: {a!r} vs {b!r}"


def _snapshot_fields():
    return [f.name for f in dataclasses.fields(
        encode_snapshot([], [], [])) if f.name != "policy"]


def _wave_gang(k):
    from kubernetes_tpu.models import gang
    ann = {gang.GANG_NAME_ANNOTATION: "g",
           gang.GANG_MIN_MEMBERS_ANNOTATION: "3"}
    pods = [k.pod(f"m{i}", cpu_m=300, annotations=ann) for i in range(3)]
    return [k.node("n0"), k.node("n1")], [], pods + [k.pod("solo")], []


def _wave_priority_bands(k):
    nodes = [k.node(f"n{i}", cpu_m=1000) for i in range(3)]
    existing = [k.pod(f"low{i}", cpu_m=500, host=f"n{i % 3}",
                      priority=i % 2) for i in range(5)]
    return nodes, existing, [k.pod("high", cpu_m=800, priority=50)], []


ENCODE_ONLY = {"gang": _wave_gang, "priority_bands": _wave_priority_bands}


@pytest.mark.parametrize("name", list(WAVES) + list(ENCODE_ONLY))
def test_encode_snapshot_matches_reference(name):
    build = WAVES.get(name) or ENCODE_ONLY[name]
    port = encode_snapshot(*build(PORT))
    ref = ref_encode(*build(REF))
    _assert_same(port, ref, _snapshot_fields(), "snapshot")
    assert port.has_gangs == ref.has_gangs


@pytest.mark.parametrize("name", list(WAVES))
def test_host_inputs_match_reference(name):
    port = bs.snapshot_to_host_inputs(encode_snapshot(*WAVES[name](PORT)))
    ref = ref_bs.snapshot_to_host_inputs(ref_encode(*WAVES[name](REF)))
    _assert_same(port, ref, bs.SolverInputs._fields, "host inputs")


def test_node_extra_ok_mask_is_honoured():
    mask = np.array([True, False])
    port = encode_snapshot(*WAVES["host_ports"](PORT), node_extra_ok=mask)
    ref = ref_encode(*WAVES["host_ports"](REF), node_extra_ok=mask)
    _assert_same(port, ref, ["node_extra_ok"], "snapshot")
    assert not port.node_extra_ok[1]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_extension_encode_matches_reference(name):
    # the policy planes (label presence in node_extra_ok, score_static,
    # the affinity value codes and anchors, zone codes) and the gang
    # markers, field by field, in the snapshot and in the host inputs
    wave, pol, _gangs = FIXTURES[name]()
    port = encode_snapshot(*to_port(wave),
                           policy=BatchPolicy(**dataclasses.asdict(pol)))
    ref = ref_encode(*wave, policy=pol)
    _assert_same(port, ref, _snapshot_fields(), "snapshot")
    _assert_same(bs.snapshot_to_host_inputs(port),
                 ref_bs.snapshot_to_host_inputs(ref),
                 bs.SolverInputs._fields, "host inputs")


def test_derive_zone_counts_matches_reference():
    rng = np.random.RandomState(3)
    node_zone = rng.randint(-1, 5, size=(3, 40)).astype(np.int32)
    counts = rng.randint(0, 4, size=(8, 41)).astype(np.int32)
    got = bs.derive_zone_counts(node_zone, counts, 5)
    want = ref_bs.derive_zone_counts(node_zone, counts, 5)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _seeded_wave(k, seed):
    rng = np.random.RandomState(seed)
    nodes = [k.node(f"n{i}", cpu_m=int(rng.randint(2000, 8000)),
                    extra={"gpu": "2"} if i % 3 == 0 else None)
             for i in range(6)]
    existing = [k.pod(f"e{i}", cpu_m=int(rng.randint(100, 900)),
                      mem=int(rng.randint(1, 64)) << 20, host=f"n{i % 6}",
                      host_ports=(9000 + i,) if i % 4 == 0 else ())
                for i in range(10)]
    pending = [k.pod(f"p{i}", cpu_m=int(rng.randint(100, 1500)),
                     mem=int(rng.randint(1, 256)) << 20,
                     host_ports=(9000 + i % 5,) if i % 3 == 0 else (),
                     extra={"gpu": "1"} if i % 5 == 0 else None)
               for i in range(12)]
    return nodes, existing, pending, []


def test_row_cache_encodes_equal_reference(monkeypatch):
    """The ``_ktpu_rows`` row cache: a first encode (every row derived), a
    re-encode of the same objects (every row a cache hit, recomputed and
    checked under the debug gate) and a re-encode after ``deep_clone``
    plus a change of limits and host ports on a third of the pods (the
    clones derive afresh, the rest still hit) each equal the JAX
    package's ``encode_snapshot`` of the same wave, bit for bit."""
    from kubernetes_tpu.models import snapshot as ref_snapshot
    from kubernetes_tpu.runtime.clone import deep_clone as ref_clone
    from kubernetes_tpu_torch.models import snapshot
    from kubernetes_tpu_torch.runtime.clone import deep_clone

    monkeypatch.setattr(snapshot, "_DEBUG_VERIFY_ROWS", True)
    monkeypatch.setattr(ref_snapshot, "_DEBUG_VERIFY_ROWS", True)
    port, ref = _seeded_wave(PORT, 18), _seeded_wave(REF, 18)
    assert not any("_ktpu_rows" in p.spec.__dict__
                   for p in port[1] + port[2])
    first = encode_snapshot(*port)
    _assert_same(first, ref_encode(*ref), _snapshot_fields(), "first")
    assert all("_ktpu_rows" in p.spec.__dict__ for p in port[1] + port[2])
    _assert_same(encode_snapshot(*port), ref_encode(*ref),
                 _snapshot_fields(), "cached")
    _assert_same(encode_snapshot(*port), first, _snapshot_fields(),
                 "cached against first")

    def change(wave, clone, k):
        pending = list(wave[2])
        for j in range(0, len(pending), 3):
            p = clone(pending[j])
            c = p.spec.containers[0]
            c.resources.limits["cpu"] = k.Q(f"{200 + 100 * j}m")
            c.resources.limits["gpu"] = k.Q("1")
            c.ports = [k.api.ContainerPort(container_port=80,
                                           host_port=9100 + j)]
            pending[j] = p
        return wave[0], wave[1], pending, wave[3]
    port, ref = change(port, deep_clone, PORT), change(ref, ref_clone, REF)
    assert [("_ktpu_rows" in p.spec.__dict__) for p in port[2]] == [
        j % 3 != 0 for j in range(len(port[2]))]
    changed = encode_snapshot(*port)
    _assert_same(changed, ref_encode(*ref), _snapshot_fields(), "changed")
    assert not np.array_equal(changed.req, first.req)


# -- the residents' gathering pass -------------------------------------------

def _second_container(k, pod, limits):
    pod.spec.containers.append(k.api.Container(
        name="c2", image="i", resources=k.api.ResourceRequirements(
            limits={n: k.Q(v) for n, v in limits.items()})))
    return pod


def _wave_residents(k, services="", ports=False, pds=False):
    """Residents built to reach every branch of the residents' pass: on an
    unknown and on an unset host, asking a resource no node advertises,
    listing cpu in two containers, in a namespace no pending pod has, at
    mixed priorities, two of them overcommitting n0; each carries the
    service label, a host port and a PD. The pending pods open the
    service, port and PD vocabularies only as asked, so each of the three
    sub-walks meets its vocabulary empty in one case and not in another."""
    nodes = [k.node("n0", cpu_m=1000, mem=1 << 30),
             k.node("n1", cpu_m=4000, extra={"gpu": "2"}),
             k.node("n2")]
    web = {"app": "web"}

    def resident(name, host, ns="default", port=9000, pd="disk-a", **kw):
        return k.pod(name, ns=ns, host=host, labels=web, host_ports=(port,),
                     pds=(pd,), **kw)
    existing = [
        resident("r-on", "n0", cpu_m=600, mem=64 << 20, priority=5),
        resident("r-over", "n0", cpu_m=600, priority=1),
        _second_container(k, resident("r-dup", "n1", cpu_m=300),
                          {"cpu": "250m", "gpu": "1"}),
        resident("r-req-only", "n1", cpu_m=100, extra={"fpga": "2"}),
        # off the list: their port and PD, which a pending pod asks for
        # too, are on no node
        resident("r-unknown", "gone", port=9001, pd="disk-b", cpu_m=200,
                 priority=7),
        resident("r-unset", "", port=9001, pd="disk-b", cpu_m=200),
        resident("r-unseen-ns", "n2", ns="other", cpu_m=100, priority=3),
    ]
    pending = [
        k.pod("p-high", cpu_m=300, priority=10,
              labels=web if services == "match" else None,
              host_ports=(9000, 9001) if ports else (),
              pds=("disk-a", "disk-b") if pds else ()),
        k.pod("p-plain", cpu_m=100, mem=32 << 20),
    ]
    svcs = {"": [], "match": [k.svc("web", web)],
            "miss": [k.svc("db", {"app": "db"})]}[services]
    return nodes, existing, pending, svcs


# case -> (wave options, the walks that run: labels, ports, volumes)
RESIDENT_CASES = {
    "no_vocabularies": ({}, (0, 0, 0)),
    "services_matching": ({"services": "match"}, (1, 0, 0)),
    "services_unmatched": ({"services": "miss"}, (1, 0, 0)),
    "host_ports": ({"ports": True}, (0, 1, 0)),
    "pds": ({"pds": True}, (0, 0, 1)),
    "all_vocabularies": ({"services": "match", "ports": True, "pds": True},
                         (1, 1, 1)),
}


@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_residents_pass_matches_reference(case):
    opts, _walks = RESIDENT_CASES[case]
    port = encode_snapshot(*_wave_residents(PORT, **opts))
    ref = ref_encode(*_wave_residents(REF, **opts))
    _assert_same(port, ref, _snapshot_fields(), "snapshot")
    _assert_same(bs.snapshot_to_host_inputs(port),
                 ref_bs.snapshot_to_host_inputs(ref),
                 bs.SolverInputs._fields, "host inputs")
    # the fixture reaches what it was built for
    assert "fpga" in port.resource_names and port.band_prio.size
    assert port.fit_exceeded[0]


@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_residents_span_counts_the_walks(case):
    from kubernetes_tpu_torch.util import tracing
    opts, (labels, ports, volumes) = RESIDENT_CASES[case]
    wave = _wave_residents(PORT, **opts)
    rows = sum(len(c.resources.limits)
               for p in wave[1] for c in p.spec.containers)
    tracing.enable("test")
    try:
        tracing.drain()
        encode_snapshot(*wave)
        spans = tracing.drain()["spans"]
    finally:
        tracing.disable()
    (scatter,) = [s for s in spans if "rows" in s["attrs"]]
    assert scatter["name"] == "encode.residents"
    assert scatter["attrs"] == {"pods": len(wave[1]), "labels": labels,
                                "services": len(wave[3]), "ports": ports,
                                "volumes": volumes, "rows": rows}


def test_residents_row_cache_is_made_once_and_reused():
    """The first encode stores every resident's rows on its spec, those
    on no listed node included; the second reads the same entries, so a
    row planted in the cache is what it encodes."""
    wave = _wave_residents(PORT, services="match", ports=True, pds=True)
    residents = wave[1]
    assert not any("_ktpu_rows" in p.spec.__dict__ for p in residents)
    first = encode_snapshot(*wave)
    entries = [p.spec.__dict__["_ktpu_rows"] for p in residents]
    second = encode_snapshot(*wave)
    assert all(p.spec.__dict__["_ktpu_rows"] is c
               for p, c in zip(residents, entries))
    _assert_same(second, first, _snapshot_fields(), "second")
    lr, pr = entries[0]
    residents[0].spec.__dict__["_ktpu_rows"] = (
        [(name, v + 7) for name, v in lr], pr)
    planted = encode_snapshot(*wave)
    cpu = planted.resource_names.index("cpu")
    assert planted.score_used[0, cpu] == first.score_used[0, cpu] + 7


@pytest.mark.parametrize("who", ["resident", "pending"])
def test_debug_rows_catch_an_in_place_mutation(monkeypatch, who):
    from kubernetes_tpu_torch.models import snapshot
    monkeypatch.setattr(snapshot, "_DEBUG_VERIFY_ROWS", True)
    wave = _wave_residents(PORT, ports=True)
    encode_snapshot(*wave)                  # stores every pod's rows
    encode_snapshot(*wave)                  # verified hits: fine
    pod = wave[1][0] if who == "resident" else wave[2][0]
    pod.spec.containers[0].resources.limits["cpu"] = PORT.Q("2")
    with pytest.raises(AssertionError, match="_ktpu_rows cache stale"):
        encode_snapshot(*wave)
