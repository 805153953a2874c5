"""The plain version of the port's sequential-commit solve against the JAX
package's Pallas kernel (interpret mode) and its XLA scan.

Each wave is encoded once by the JAX package; ``inputs_from_reference``
carries its host inputs into the port, so both packages solve the identical
wave. Chosen nodes and winning scores must be equal exactly. The fixtures
are the default-policy ones of test_pallas_solver.py and
test_batch_solver.py; the extension and gang fixtures are in
test_torch_policy.py.
"""

import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.ops import pallas_solver
from kubernetes_tpu_torch.models.carry import inputs_from_reference
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.ops import commit_solver
from test_pallas_solver import fuzz_wave, mk_node, mk_pod
from test_torch_batch_solver import REF, WAVES


def _solve_all(snap):
    """-> (port plain, solve_jit, solve_pallas interpret), each a pair of
    numpy arrays, plus the port's CommitInputs."""
    pol = BatchPolicy(**dataclasses.asdict(snap.policy))
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    ci = commit_solver.prepare(inp, pol)
    port = tuple(t.numpy() for t in commit_solver.solve_commit_reference(ci))
    rinp = ref_bs.snapshot_to_inputs(snap)
    jit = tuple(np.asarray(t) for t in ref_bs.solve_jit(rinp, pol=snap.policy))
    pallas = tuple(np.asarray(t) for t in pallas_solver.solve_pallas(
        rinp, pol=snap.policy, interpret=True))
    return port, jit, pallas, ci, inp, rinp


def _assert_all_equal(snap):
    port, jit, pallas, _, _, _ = _solve_all(snap)
    for name, ref in (("solve_jit", jit), ("solve_pallas", pallas)):
        assert np.array_equal(port[0], ref[0]), f"chosen vs {name}"
        assert np.array_equal(port[1], ref[1]), f"scores vs {name}"


@pytest.mark.parametrize("seed", range(14))
def test_fuzz_matches_pallas_and_scan(seed):
    _assert_all_equal(ref_encode(*fuzz_wave(seed)))


def test_custom_weights_match_pallas_and_scan():
    pol = RefPolicy(w_lr=2, w_spread=3, w_equal=1)
    _assert_all_equal(ref_encode(*fuzz_wave(99), policy=pol))


def test_unschedulable_pods_get_minus_one():
    snap = ref_encode([mk_node("n-0", cpu_m=1000)], [],
                      [mk_pod(f"p-{i}", cpu_m=800) for i in range(3)], [])
    port, _, _, _, _, _ = _solve_all(snap)
    assert port[0].tolist() == [0, -1, -1]
    assert port[1][1:].tolist() == [-1, -1]
    _assert_all_equal(snap)


@pytest.mark.parametrize("name", [
    "host_ports", "selector_and_host", "pd_conflicts", "cordoned",
    "third_dimension", "extra_dimension_average", "request_only",
    "zero_quantity_advertisement", "divisor_follows_filter",
    "overcommitted_node", "zero_request", "unassigned_peers"])
def test_fixture_matches_pallas_and_scan(name):
    _assert_all_equal(ref_encode(*WAVES[name](REF)))


def _eligible_both(snap, gangs=False, peers=None):
    """(port, reference) kernel-domain verdicts on one wave."""
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    peers = ref_bs.peer_bound_of(snap) if peers is None else peers
    return (commit_solver.eligible(
                inp, BatchPolicy(**dataclasses.asdict(snap.policy)), peers),
            pallas_solver.eligible(ref_bs.snapshot_to_inputs(snap),
                                   snap.policy, gangs, peers))


def _zoned_wave(n_zones, n_labels):
    """fuzz_wave(1) with n_labels zone labels of n_zones values each."""
    nodes, existing, pending, services = fuzz_wave(1, n_nodes=n_zones + 2)
    for i, n in enumerate(nodes):
        for a in range(n_labels):
            n.metadata.labels[f"zone{a}"] = f"z{i % n_zones}"
    return nodes, existing, pending, services


def test_eligibility_agrees_with_reference():
    snap = ref_encode(*fuzz_wave(1))
    _, _, _, _, inp, rinp = _solve_all(snap)
    pol = BatchPolicy()
    peers = ref_bs.peer_bound_of(snap)
    assert commit_solver.eligible(inp, pol, peers)
    assert pallas_solver.eligible(rinp, snap.policy, False, peers)
    # the spread-count domain: peers plus commits must stay below 2^15
    assert not commit_solver.eligible(inp, pol, 1 << 15)
    assert not pallas_solver.eligible(rinp, snap.policy, False, 1 << 15)
    # a policy whose planes the wave was not encoded with
    assert not commit_solver.eligible(inp, BatchPolicy(
        anti_affinity=(("zone", 1),)), peers)
    assert not commit_solver.eligible(inp, BatchPolicy(all_infeasible=True),
                                      peers)
    # extension and gang waves are in both domains
    kitchen = RefPolicy(affinity_labels=("zone",),
                        anti_affinity=(("zone", 2),),
                        label_prefs=(("zone", True, 1),),
                        label_presence=((("zone",), False),))
    assert _eligible_both(ref_encode(*fuzz_wave(2), policy=kitchen)) == \
        (True, True)
    wave = WAVES["host_ports"](REF)
    gang_snap = ref_encode(*_gang(wave))
    assert gang_snap.has_gangs
    assert _eligible_both(gang_snap, gangs=True) == (True, True)


def _gang(wave):
    from kubernetes_tpu.models import gang
    nodes, existing, pending, services = wave
    for p in pending:
        p.metadata.annotations = {gang.GANG_NAME_ANNOTATION: "g"}
    return nodes, existing, pending, services


@pytest.mark.parametrize("n_labels,n_zones,inside", [
    (4, 64, True),     # A = 4 labels of V = 64 zones: the limits
    (5, 3, False),     # A = 5 > 4
    (1, 65, False),    # V = 65 > 64
])
def test_eligibility_at_the_anti_affinity_limits(n_labels, n_zones, inside):
    pol = RefPolicy(anti_affinity=tuple((f"zone{a}", 1)
                                        for a in range(n_labels)))
    snap = ref_encode(*_zoned_wave(n_zones, n_labels), policy=pol)
    assert _eligible_both(snap) == (inside, inside)


@pytest.mark.parametrize("n_labels,inside", [(4, True), (5, False)])
def test_eligibility_at_the_affinity_label_limit(n_labels, inside):
    pol = RefPolicy(affinity_labels=tuple(f"zone{a}"
                                          for a in range(n_labels)))
    snap = ref_encode(*_zoned_wave(3, n_labels), policy=pol)
    assert _eligible_both(snap) == (inside, inside)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    snap = ref_encode(*fuzz_wave(4))
    port, _, _, ci, _, _ = _solve_all(snap)
    before = commit_solver.solve_commit.launches
    chosen, win = commit_solver.solve_commit(ci)
    assert commit_solver.solve_commit.launches == before
    assert np.array_equal(chosen.numpy(), port[0])
    assert np.array_equal(win.numpy(), port[1])


def test_wrapper_checks_its_inputs():
    snap = ref_encode(*fuzz_wave(5))
    _, _, _, ci, _, _ = _solve_all(snap)
    with pytest.raises(ValueError, match="smask"):
        commit_solver.solve_commit(ci._replace(smask=ci.smask.int()))
    with pytest.raises(ValueError, match="contiguous"):
        commit_solver.solve_commit(ci._replace(cap=ci.cap.T.contiguous().T))


def test_carry_refuses_waves_outside_the_slice():
    # preemption waves are the one part of the reference's wave the port
    # does not carry yet
    from test_torch_encode import _wave_priority_bands
    snap = ref_encode(*_wave_priority_bands(REF))
    assert snap.band_prio.size
    with pytest.raises(NotImplementedError, match="preemption"):
        inputs_from_reference(
            ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
