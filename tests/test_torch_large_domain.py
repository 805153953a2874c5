"""The kernel's large-cluster domain on the CPU.

Every main path that once ran the plain version on a card for a wave the
kernel can take now hands that wave to the kernel's wrapper
(``commit_solver.solve_commit``, whose ``calls`` counter moves; on a CPU
tensor it runs the plain version): the submesh's compacted wave, the
mesh's one-shard program and the solver daemon's group. ``solve_scan`` is
replaced by a function that fails, so none of them reaches it directly.
Then chip_smoke.py's phase 20 at a small size (the planet and services64
shapes at 300 nodes, the loop at planet's two services, the spread
sample's first two octaves, the seeded large waves at 300 nodes), on the
plain version: launches are not counted.
"""

import numpy as np
import pytest

import chip_smoke
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import fixtures
from kubernetes_tpu_torch.models.snapshot import encode_snapshot
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.parallel import mesh as pm


@pytest.fixture
def no_scan(monkeypatch):
    def refuse(*_args, **_kw):
        raise AssertionError("solve_scan called for a wave inside the "
                             "kernel's domain")

    monkeypatch.setattr(bs, "solve_scan", refuse)


def _same(got, want):
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_submesh_compacted_wave_reaches_solve_commit(no_scan):
    from kubernetes_tpu_torch.solver.mesh_exec import MeshExecutor
    from kubernetes_tpu_torch.util import metrics

    snap = encode_snapshot(*chip_smoke._late_churn_cluster(400, 60, 24,
                                                           1314))
    host = bs.snapshot_to_host_inputs(snap)
    assert commit_solver.eligible(host, snap.policy, bs.peer_bound_of(snap))
    sm = metrics.solverd_submesh_metrics()
    waves = sm.waves.value()
    me = MeshExecutor(devices=["cpu"] * 3, dispatch="single", probe="off",
                      min_nodes=1)
    calls = commit_solver.solve_commit.calls
    got = me.solve(host, snap.policy, snap.has_gangs)
    assert me.submesh_waves == 1 and sm.waves.value() == waves + 1
    assert commit_solver.solve_commit.calls == calls + 1
    _same(got, bs.solve(snap, device="cpu"))


@pytest.mark.parametrize("n_services", [8, 64])
def test_mesh_one_shard_program_reaches_solve_commit(no_scan, n_services):
    snap = encode_snapshot(*fixtures.build_cluster(40, 60,
                                                   n_services=n_services))
    host = bs.snapshot_to_host_inputs(snap)
    mesh = pm.make_mesh(["cpu"])
    run = pm.sharded_program(mesh, snap.policy, snap.has_gangs)
    calls = commit_solver.solve_commit.calls
    got = run(pm.place_inputs(host, mesh, pm.RESIDENT_FIELDS),
              pm.place_inputs(host, mesh, pm.WAVE_FIELDS))
    assert commit_solver.solve_commit.calls == calls + 1
    _same(got, bs.solve(snap, device="cpu"))


def test_daemon_group_reaches_solve_commit(no_scan):
    from kubernetes_tpu_torch.solver.service import SolverService

    # a group of two 64-service waves (the large instances' domain)
    snap = encode_snapshot(*fixtures.build_cluster(30, 50, n_services=64))
    host = bs.snapshot_to_host_inputs(snap)
    assert host.group_counts.shape[0] == 64
    stacked = type(host)(*(np.stack([a, a]) for a in host))
    srv = SolverService(device="cpu")
    calls = commit_solver.solve_commit.calls
    chosen, scores = srv._device_solve(stacked, snap.policy, snap.has_gangs)
    assert commit_solver.solve_commit.calls == calls + 2
    assert srv.batched_solves == 1 and srv.scan_waves == 0
    want = bs.solve(snap, device="cpu")
    for k in range(2):
        _same((chosen[k], scores[k]), want)


def test_chip_smoke_large_phase_runs_on_the_cpu_at_a_small_size():
    """chip_smoke's phase 20 on the CPU: (a) planet and services64 at 300
    nodes through solve, each equal to the plain version; (b) the loop on
    planet's cluster in three waves of 32, full then delta encodes, each
    held against solve(encode_snapshot(...)); (c) the spread sample for k
    = 15, 16 and 4,096 seeded pairs, the float32 expression standing in
    for the device function; (d) the seeded large waves at 300 nodes (the
    33,000-node preemption wave takes 40 services instead)."""
    cases = []
    for family, seed, n_nodes, n_pods, kw in chip_smoke._LARGE_CASES:
        if n_nodes > 300:
            n_nodes = 300
            if "n_services" not in kw and "peers" not in kw:
                kw = dict(kw, n_services=40)
        cases.append((family, seed, n_nodes, n_pods, kw))
    lg = chip_smoke._large_phase(
        "cpu", kernel_runs=1,
        sizes={"planet": (300, 200), "services64": (300, 200)},
        loop_nodes=300, loop_waves=3, wave_size=32,
        spread_ks=range(15, 17), spread_random=1 << 12, large_cases=cases,
        count_launches=False)
    s64 = lg["waves"]["services64"]
    assert s64["groups"] == 64 and s64["max_abs_err"] == 0
    assert s64["instance"] == "commit_solve_large<int32,counts16,1>"
    assert lg["waves"]["planet"]["bound_pods"] == 200
    loop = lg["loop"]
    assert [w["path"] for w in loop["waves"]] == ["full", "delta", "delta"]
    assert sum(w["bound"] for w in loop["waves"]) == 96
    assert lg["spread"]["pairs"] == sum(3 * (1 << k) + 3
                                        for k in (15, 16)) + (1 << 12)
    seeded = lg["seeded"]
    assert len(seeded["waves"]) == len(cases)
    assert seeded["rolled_back_runs"] > 0 and seeded["preempting"] > 0
    assert {w["groups"] for w in seeded["waves"]} >= {64, 1024}
    assert {w["count_bytes"] for w in seeded["waves"]} == {2, 4}
