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
import torch

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.policy import BatchPolicy as RefPolicy
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.ops import pallas_solver
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models.carry import inputs_from_reference
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
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


def _port_and_scan(snap):
    """(port plain, solve_jit) decisions of a wave outside the Pallas
    kernel's domain, and the port's CommitInputs."""
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    ci = commit_solver.prepare(
        inp, BatchPolicy(**dataclasses.asdict(snap.policy)))
    port = tuple(t.numpy() for t in commit_solver.solve_commit_reference(ci))
    jit = tuple(np.asarray(t) for t in ref_bs.solve_jit(
        ref_bs.snapshot_to_inputs(snap), pol=snap.policy))
    return port, jit, ci, inp


def test_carry_refuses_waves_outside_the_slice():
    # the waves once refused at the carry — band planes, int64 planes —
    # now carry across whole, and the plain version solves them as the
    # reference's scan does
    from test_torch_encode import _wave_priority_bands
    snap = ref_encode(*_wave_priority_bands(REF))
    assert snap.band_prio.size
    port, jit, ci, inp = _port_and_scan(snap)
    assert inp.band_prio.shape[0] == ci.band.shape[0] > 0
    assert np.array_equal(port[0], jit[0]) and np.array_equal(port[1], jit[1])
    assert port[1][0] <= commit_solver.PREEMPT_SCORE_BASE
    wide = ref_encode([mk_node("big", mem=(1 << 40) + 3), mk_node("n1")], [],
                      [mk_pod(f"p{i}", mem=1 + i) for i in range(3)])
    port, jit, ci, _ = _port_and_scan(wide)
    assert ci.cap.dtype == torch.int64
    assert np.array_equal(port[0], jit[0]) and np.array_equal(port[1], jit[1])


# ---- the kernel's state layout and its arithmetic --------------------------

def _shape_widths(name):
    """(N, R, Wp, Wd, G) of a full shape. The widths do not depend on the
    cluster's size (the fixture cycles 5 host ports, 8 services), so they
    are read from a 64-node build of the same fixture."""
    from kubernetes_tpu_torch.models import fixtures
    from kubernetes_tpu_torch.models.policy import batch_policy_from
    from kubernetes_tpu_torch.scheduler.plugins import load_policy
    n_nodes, n_pods, kw, policy_json = fixtures.FULL_SHAPES[name]
    if kw.get("gang_groups"):
        kw = dict(kw, gang_groups=12)
    cluster = fixtures.build_cluster(64, min(n_pods, 200), **kw)
    policy = (batch_policy_from(policy=load_policy(policy_json))
              if policy_json else None)
    snap = encode_snapshot(*cluster, policy=policy)
    inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
    ci = commit_solver.prepare(inp, snap.policy, snap.has_gangs)
    return (n_nodes, ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0],
            ci.counts0.shape[0])


@pytest.mark.parametrize("name", ["north_star", "affinity", "binpack3",
                                  "gang"])
def test_full_shapes_keep_their_state_on_chip(name):
    N, R, Wp, Wd, G = _shape_widths(name)
    on_chip, nbytes = commit_solver.shared_layout(N, R, Wp, Wd, G)
    assert on_chip
    # the mask ring plus the state planes, counts as int16, no score plane
    assert nbytes == 2 * commit_solver.mask_pitch(N) + 4 * (R + Wp + Wd) * N \
        + 2 * G * N
    assert nbytes <= commit_solver.SMEM_PER_BLOCK - commit_solver.STATIC_SMEM


@pytest.mark.parametrize("widths", [
    (2, 0, 0, 0),      # the smallest state a wave has
    (2, 1, 1, 8),      # north_star's widths
    (3, 1, 1, 2),      # the seeded 32,640-node wave of chip_smoke phase 4
])
def test_widest_wave_keeps_its_state_in_global_memory(widths):
    on_chip, nbytes = commit_solver.shared_layout(commit_solver.MAX_N,
                                                  *widths)
    assert not on_chip
    # only the two-row mask ring is in shared memory
    assert nbytes == 2 * commit_solver.MAX_N


def test_prepare_pads_mask_rows_to_16_bytes():
    snap = ref_encode(*fuzz_wave(3))
    _, _, _, ci, inp, _ = _solve_all(snap)
    P, N = inp.req.shape[0], inp.cap.shape[0]
    assert N % 16
    assert ci.smask.shape == (P, commit_solver.mask_pitch(N))
    assert ci.smask.shape[1] % 16 == 0 and ci.smask.shape[1] - N < 16
    assert not ci.smask[:, N:].any()
    assert commit_solver.layout_of(ci) == commit_solver.shared_layout(
        N, ci.cap.shape[0], ci.ports0.shape[0], ci.pds0.shape[0],
        ci.counts0.shape[0])


def _gang_inputs(wave):
    snap = ref_encode(*wave)
    assert snap.has_gangs
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    return commit_solver.prepare(
        inp, BatchPolicy(**dataclasses.asdict(snap.policy)), True)


def _rolled_back_wave():
    from test_torch_batch_solver import _gang_wave
    return _gang_wave(REF)


@pytest.mark.parametrize("wave", ["fuzz0", "fuzz7", "fuzz2_gang",
                                  "rolled_back_gang"])
def test_off_plus_fit_is_score_used(wave):
    # the kernel keeps no all-pods usage plane: every commit and every
    # rollback moves it with the fit usage, so fit + off stays equal to it
    if wave == "fuzz2_gang":
        ci = _gang_inputs(_gang(fuzz_wave(2)))
    elif wave.startswith("fuzz"):
        _, _, _, ci, _, _ = _solve_all(ref_encode(*fuzz_wave(int(wave[4:]))))
    else:
        ci = _gang_inputs(_rolled_back_wave())
    assert torch.equal(ci.off, ci.score0 - ci.fit0)
    stats = {}
    chosen, _ = commit_solver.solve_commit_reference(ci, stats)
    assert (chosen >= 0).any()
    assert not torch.equal(stats["fit"], ci.fit0)      # something committed
    assert torch.equal(stats["fit"] + ci.off, stats["score_used"])
    if wave == "rolled_back_gang":
        # the second gang's last member found no node after its first
        # members placed: the state was rolled back to the checkpoint
        assert chosen[2] >= 0 and chosen[4] == -1


def test_float32_spread_expression_is_spread_score():
    # The kernel's spread device function is the reference's float32
    # expression: int(10 * (f32(total - count) / f32(total))) with IEEE
    # round-to-nearest-even steps. numpy's float32 arithmetic is IEEE, so
    # it must equal the plain version's exact int64 emulation on every
    # pair; the chip smoke test checks the device function itself on all
    # pairs below 2^15.
    from kubernetes_tpu_torch.ops.kernels import spread_score
    limit = 1 << 12
    totals = np.arange(limit, dtype=np.int64)
    total = np.repeat(totals, totals + 1)
    count = np.arange(total.size) - np.repeat(np.cumsum(totals + 1)
                                              - (totals + 1), totals + 1)
    assert count.min() == 0 and (count <= total).all()
    with np.errstate(invalid="ignore"):
        q = np.float32(total - count) / np.float32(total)
        got = np.where(total == 0, 10,
                       (np.float32(10) * q).astype(np.int32))
    want = np.concatenate([
        spread_score(torch.from_numpy(t), torch.from_numpy(c)).numpy()
        for t, c in zip(np.array_split(total, 8), np.array_split(count, 8))])
    assert got.size == limit * (limit + 1) // 2
    mismatch = np.nonzero(got != want)[0]
    assert mismatch.size == 0, (total[mismatch[:5]], count[mismatch[:5]])


def test_ptxas_report_keys_each_instance_by_branch_set_and_layout():
    # chip_smoke prints ptxas' registers and spills per kernel instance; two
    # instances that differ only in the state layout keep an entry each
    import chip_smoke
    mangled = ("_ZN4kgpu19commit_solve_kernelIiLb0ELb0ELb1ELb0ELb0ELb{}EEEvPKhP"
               "KiPKT_S7_S7_S2_S2_S4_S4_S4_S4_S4_S4_S4_S2_S4_S7_S4_S4_S4_PhS8_"
               "PiS9_NS_5ShapeE")
    log = ["ptxas info    : 0 bytes gmem"]
    for shared, spill in ((1, 8), (0, 0)):
        name = mangled.format(shared)
        log += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    80 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            "ptxas info    : Used 64 registers, used 1 barriers, 80 bytes "
            "cumulative stack size, 2096 bytes smem"]
    report = chip_smoke._ptxas_report("\n".join(log))
    on, off = ("commit_solve<int32,0,0,1,0,0,1>",
               "commit_solve<int32,0,0,1,0,0,0>")
    assert set(report) == {on, off}
    assert report[on].startswith("Used 64 registers")
    assert "8 bytes spill stores" in report[on]
    assert " 0 bytes spill stores" in report[off]
