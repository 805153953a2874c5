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
