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
