"""The port's device mesh on the CPU, against the single-device solve and
the JAX package's.

``tests/test_parallel.py`` runs against the port through ``port_twin``,
with meshes of eight CPU shards (``mesh_on_the_cpu``, the counterpart of
the reference suite's eight virtual XLA devices). Left out, each with a
port-own case below that replaces it:

- ``test_mesh_has_eight_devices`` asserts ``jax.devices()``;
  ``test_default_mesh_is_eight_cpu_shards`` asserts the port's default
  mesh devices;
- ``test_crossover_dispatch_runs_kernel_for_eligible_waves`` calls the
  Pallas kernel's four-argument ``eligible`` under
  ``KTPU_PALLAS=interpret``;
  ``test_crossover_dispatch_runs_commit_solve_for_eligible_waves`` counts
  the port's commit_solve calls;
- ``TestMeshExecutorDirect::test_resident_planes_survive_donated_solves``
  and ``::test_dispatch_calibration_persists_winner`` read
  ``is_deleted()`` of donated XLA buffers, and the port donates nothing;
  ``test_resident_planes_survive_solves`` and
  ``test_dispatch_calibration_persists_winner_and_keeps_residency`` hold
  the same contracts on the port's resident shard tensors.

The port-own cases (tolerance: exact, chosen and scores): the sharded
loop with 1, 2, 3 and 8 shards equals the port's ``solve_scan`` and the
JAX package's ``solve_sharded`` on the same numpy planes, for the default
policy at odd N, zone anti-affinity, service-affinity anchors, label
preferences, gangs with rollback, int64 planes and preemption; a host pin
on a node past shard 0; a group whose off-list peers set the spread max;
the executor's delta scatter onto zone, group and band planes.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.parallel import mesh as ref_pm
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import preempt
from kubernetes_tpu_torch.models.carry import inputs_from_reference
from kubernetes_tpu_torch.models.policy import BatchPolicy
from kubernetes_tpu_torch.ops import commit_solver
from kubernetes_tpu_torch.parallel import mesh as pm
from kubernetes_tpu_torch.parallel import sharded_scan
from test_torch_batch_solver import REF
from test_torch_policy import FIXTURES
from test_torch_twin import mesh_on_the_cpu, port_twin

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)

DONATION = "the port donates no buffer, so there is no is_deleted() to read"

globals().update(port_twin("test_parallel", {
    "test_mesh_has_eight_devices":
        "asserts jax.devices(); test_default_mesh_is_eight_cpu_shards",
    "test_crossover_dispatch_runs_kernel_for_eligible_waves":
        "the Pallas kernel's eligible() and KTPU_PALLAS=interpret; "
        "test_crossover_dispatch_runs_commit_solve_for_eligible_waves",
    "TestMeshExecutorDirect::test_resident_planes_survive_donated_solves":
        DONATION + "; test_resident_planes_survive_solves",
    "TestMeshExecutorDirect::test_dispatch_calibration_persists_winner":
        DONATION + "; test_dispatch_calibration_persists_winner_and_keeps_"
        "residency",
}, rename={"solve_jit": "solve_scan"}))


@pytest.fixture(autouse=True)
def _mesh_on_the_cpu(monkeypatch):
    mesh_on_the_cpu(monkeypatch)


def cpu_mesh(shards: int) -> pm.Mesh:
    return pm.make_mesh([torch.device("cpu")] * shards)


# ---- the replaced reference cases ------------------------------------------

def test_default_mesh_is_eight_cpu_shards():
    mesh = pm.make_mesh()
    assert mesh.shape == {"pods": 1, "nodes": 8}
    assert [d.type for d in mesh.node_devices] == ["cpu"] * 8
    assert pm.maybe_mesh("auto").shape["nodes"] == 8
    assert pm.maybe_mesh("off") is None


def test_crossover_dispatch_runs_commit_solve_for_eligible_waves(
        monkeypatch):
    """solve_sharded's default dispatch sends a wave inside the kernel's
    domain to one commit_solve call on the mesh's first device (the
    kernel on a card, its plain version here) and runs no sharded loop;
    prefer_kernel=False shards it, with the same decisions."""
    nodes, existing, pending, services = _cluster()
    snap = encode_snapshot(nodes, existing, pending, services)
    inp = snapshot_to_inputs(snap)
    assert commit_solver.eligible(inp, snap.policy or BatchPolicy(),
                                  bs.peer_bound_of(snap))
    calls = {"solve_commit": 0, "sharded": 0}
    real_commit = commit_solver.solve_commit
    real_shards = sharded_scan.solve_shards

    def count_commit(ci):
        calls["solve_commit"] += 1
        return real_commit(ci)

    def count_shards(*a, **kw):
        calls["sharded"] += 1
        return real_shards(*a, **kw)
    monkeypatch.setattr(commit_solver, "solve_commit", count_commit)
    monkeypatch.setattr(sharded_scan, "solve_shards", count_shards)
    mesh = pm.make_mesh()
    via_dispatch, _ = pm.solve_sharded(inp, mesh)
    assert calls == {"solve_commit": 1, "sharded": 0}
    via_shards, _ = pm.solve_sharded(inp, mesh, prefer_kernel=False)
    assert calls == {"solve_commit": 1, "sharded": 1}
    assert np.array_equal(via_dispatch, via_shards)
    assert decisions_to_names(snap, via_dispatch) == solve_serial(
        nodes, existing, pending, services)


def _executor(**kw):
    from kubernetes_tpu_torch.solver.mesh_exec import MeshExecutor
    kw.setdefault("min_nodes", 1)
    kw.setdefault("dispatch", "shard")
    kw.setdefault("probe", "off")
    return MeshExecutor(**kw)


def _host_wave(n_nodes=13, n_pods=9):
    nodes, existing, pending, services = _cluster(n_nodes=n_nodes,
                                                  n_pods=n_pods)
    snap = encode_snapshot(nodes, existing, pending, services)
    return snap, bs.snapshot_to_host_inputs(snap)


def test_resident_planes_survive_solves():
    """The resident node/group/zone planes stay the executor's own shard
    tensors across solves: the same host objects again cost no transfer,
    keep the very same tensors, and decide identically, three deep."""
    me = _executor()
    snap, inp = _host_wave()
    pol = snap.policy or BatchPolicy()
    key = ("w", "b0")
    first = me.solve(inp, pol, False, cache_key=key)
    planes = {name: rec[1] for name, rec in me._resident[key]["planes"].items()}
    tensors = {name: p.shards for name, p in planes.items()}
    assert planes and all(len(s) == 8 for s in tensors.values())
    before = me._m.transfer_bytes.value()
    for _ in range(2):
        again = me.solve(inp, pol, False, cache_key=key)
        assert np.array_equal(first[0], again[0])
        assert np.array_equal(first[1], again[1])
    entry = me._resident[key]
    for name, shards in tensors.items():
        assert all(a is b for a, b in zip(entry["planes"][name][1].shards,
                                          shards)), \
            f"resident plane {name} was re-established"
    # only the per-wave pod planes moved
    moved = me._m.transfer_bytes.value() - before
    assert moved == 2 * sum(getattr(inp, f).nbytes for f in pm.WAVE_FIELDS)


def test_dispatch_calibration_persists_winner_and_keeps_residency(
        tmp_path, monkeypatch):
    """dispatch='auto' times both layouts once (the probe doubles as a
    bit-identity check), persists the winner in the warm-start dir, and a
    fresh executor skips the probe by reading it back; the probed wave
    still installs residency."""
    monkeypatch.setenv("KTPU_WARM_START", "1")
    monkeypatch.setenv("KTPU_CACHE_DIR", str(tmp_path))
    snap, inp = _host_wave()
    pol = snap.policy or BatchPolicy()
    me = _executor(dispatch="auto")
    got = me.solve(inp, pol, False, cache_key=("w", "b0"))
    assert me.parity_checks == 1 and me.parity_divergent == 0
    assert np.array_equal(got[0], solve(snap)[0])
    assert len(me._cal) == 1
    planes = me._resident[("w", "b0")]["planes"]
    assert set(planes) == set(pm.RESIDENT_FIELDS)
    cal = next(iter(me._cal.values()))
    assert cal["winner"] in ("shard", "single")
    assert (tmp_path / "mesh_cal.json").exists()
    me2 = _executor(dispatch="auto")
    assert me2._cal == me._cal  # loaded, not re-probed
    me2.solve(inp, pol, False, cache_key=("w", "b0"))
    assert me2.parity_checks == 0


# ---- the sharded loop against both packages ---------------------------------

def _default_wave():
    nodes, existing, pending, services = REF.build_cluster(13, 30)
    return (nodes, existing, pending, services), None, False


def _int64_wave():
    nodes = [REF.node(f"n{i}", cpu_m=16000, mem=(64 + 64 * (i % 2)) << 30)
             for i in range(7)]
    existing = [REF.pod(f"e{i}", cpu_m=1000, mem=2 << 30, host=f"n{i % 7}")
                for i in range(5)]
    pending = [REF.pod(f"p{i}", cpu_m=500, mem=(100 + 200 * (i % 6)) * 10**6)
               for i in range(20)]
    return (nodes, existing, pending, []), None, False


def _preemption_wave():
    nodes = [REF.node(f"n{i:03d}", cpu_m=1000, mem=8 << 30)
             for i in range(11)]
    existing = [REF.pod(f"e{i}-{j}", cpu_m=450, mem=64 << 20,
                        host=f"n{i:03d}", priority=10 * (1 + (i + j) % 3))
                for i in range(11) for j in range(2)]
    pending = [REF.pod(f"h{k}", cpu_m=300 + 200 * (k % 3), mem=64 << 20,
                       priority=(5, 25, 100)[k % 3]) for k in range(14)]
    return (nodes, existing, pending, []), None, False


BRANCHES = {
    "default": _default_wave,
    "anti_affinity": FIXTURES["anti_affinity_0"],
    "affinity_anchors": FIXTURES["service_affinity_0"],
    "kitchen_sink": FIXTURES["kitchen_sink_0"],
    "label_prefs": FIXTURES["label_prefs_0"],
    "gang_rollback": FIXTURES["gang_rollback"],
    "gang_anti_affinity": FIXTURES["gang_anti_affinity_0"],
    "int64": _int64_wave,
    "preemption": _preemption_wave,
}


def _both_packages(name):
    """-> (reference snapshot, port inputs on the CPU, the port's policy,
    gangs): one wave encoded once, by the JAX package."""
    wave, ref_pol, gangs = BRANCHES[name]()
    snap = ref_encode(*wave, policy=ref_pol)
    host = ref_bs.snapshot_to_host_inputs(snap)
    inp = inputs_from_reference(host._asdict(), "cpu")
    pol = (BatchPolicy(**dataclasses.asdict(ref_pol)) if ref_pol is not None
           else BatchPolicy())
    return snap, inp, pol, snap.has_gangs


@pytest.mark.parametrize("name", list(BRANCHES))
def test_sharded_loop_equals_solve_scan_and_jax_solve_sharded(name):
    snap, inp, pol, gangs = _both_packages(name)
    want = [t.numpy() for t in bs.solve_scan(inp, pol, gangs)]
    if name == "int64":
        assert inp.cap.dtype == torch.int64
    if name == "preemption":
        assert inp.band_prio.shape[0] > 0
        assert (want[1] <= preempt.PREEMPT_SCORE_BASE).any()
    if name == "gang_rollback":
        assert (want[0] < 0).any()
    for shards in (1, 2, 3, 8):
        got = pm.solve_sharded(inp, cpu_mesh(shards), pol=pol, gangs=gangs,
                               prefer_kernel=False)
        assert np.array_equal(got[0], want[0]), f"{shards} shards: chosen"
        assert np.array_equal(got[1], want[1]), f"{shards} shards: scores"
    ref_bs.ensure_x64()
    ref_pol = BRANCHES[name]()[1]
    jc, js = ref_pm.solve_sharded(ref_bs.snapshot_to_inputs(snap),
                                  ref_pm.make_mesh(), pol=ref_pol,
                                  gangs=gangs, prefer_kernel=False)
    assert np.array_equal(np.asarray(jc), want[0])
    assert np.array_equal(np.asarray(js), want[1])


@pytest.mark.parametrize("seed", range(3))
def test_sharded_loop_on_seeded_extension_and_preemption_waves(seed):
    """chip_smoke's phase 4b and 4c generators (every extension, gangs,
    int64 planes, 5 bands) at odd node counts: sharded == solve_scan."""
    import chip_smoke
    from kubernetes_tpu_torch.models.incremental import IncrementalEncoder
    from kubernetes_tpu_torch.models.snapshot import encode_snapshot as enc
    rng = random.Random(900 + seed)
    ext, ext_pol = chip_smoke._ext_wave(
        rng, 31 + 2 * seed, 30, anti=1 + seed % 2, aff=seed % 2 + 1,
        prefs=True, gangs=seed != 1)
    pre, pre_pol = chip_smoke._pre_wave(rng, 27 + 2 * seed, 24, 5,
                                        wide=seed == 2, gangs=seed == 1,
                                        anti=seed % 2)
    for snap in (enc(*ext, policy=ext_pol),
                 IncrementalEncoder(pre_pol).encode(*pre)):
        inp = bs.ship_inputs(bs.snapshot_to_host_inputs(snap), "cpu")
        want = [t.numpy() for t in bs.solve_scan(inp, snap.policy,
                                                 snap.has_gangs)]
        for shards in (2, 3, 8):
            got = pm.solve_sharded(inp, cpu_mesh(shards), pol=snap.policy,
                                   gangs=snap.has_gangs, prefer_kernel=False)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])


def test_host_pin_past_shard_zero_lands_on_its_node():
    """Host pins are global node indices: a pod pinned to a node held by
    the last shard lands there, not on shard 0's node of the same local
    index."""
    nodes = [REF.node(f"n{i:02d}", cpu_m=4000) for i in range(13)]
    pending = [REF.pod(f"p{i}", cpu_m=500, mem=64 << 20,
                       host="n11" if i in (2, 5) else "")
               for i in range(10)]
    snap = ref_encode(nodes, [], pending, [])
    inp = inputs_from_reference(
        ref_bs.snapshot_to_host_inputs(snap)._asdict(), "cpu")
    want = bs.solve_scan(inp)[0].numpy()
    assert want[2] == want[5] == 11
    for shards in (2, 3, 8):
        got, _ = pm.solve_sharded(inp, cpu_mesh(shards), prefer_kernel=False)
        assert np.array_equal(got, want)
        assert got[2] == got[5] == 11


def test_off_list_peers_set_the_spread_max():
    """A service whose peers sit mostly on a host that is not a node (the
    off-list column of group_counts): its count sets the spread max, and
    every shard must see it."""
    nodes = [REF.node(f"n{i}", cpu_m=8000, labels={"app": "x"})
             for i in range(11)]
    svc = ref_api.Service(
        metadata=ref_api.ObjectMeta(name="web", namespace="default"),
        spec=ref_api.ServiceSpec(port=80, selector={"app": "web"}))
    existing = ([REF.pod(f"ghost{i}", cpu_m=100, host="gone",
                         labels={"app": "web"}) for i in range(4)]
                + [REF.pod("peer", cpu_m=100, host="n3",
                           labels={"app": "web"})])
    pending = [REF.pod(f"w{i}", cpu_m=200, labels={"app": "web"})
               for i in range(12)]
    snap = ref_encode(nodes, existing, pending, [svc])
    host = ref_bs.snapshot_to_host_inputs(snap)
    gc = np.asarray(host.group_counts)
    assert gc[0, -1] == 4 and gc[0, :-1].max() == 1
    inp = inputs_from_reference(host._asdict(), "cpu")
    want = [t.numpy() for t in bs.solve_scan(inp)]
    for shards in (2, 3, 8):
        padded, n = pm.pad_inputs_for_mesh(inp, cpu_mesh(shards))
        # the off-list slot stays the last column after padding
        assert int(padded.group_counts[0, -1]) == 4
        got = pm.solve_sharded(inp, cpu_mesh(shards), prefer_kernel=False)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_pad_plane_keeps_the_off_list_slot_last():
    gc = np.array([[1, 2, 3, 9], [0, 0, 1, 5]], np.int32)
    out = pm.pad_plane("group_counts", gc, 3)
    assert out.tolist() == [[1, 2, 3, 0, 0, 0, 9], [0, 0, 1, 0, 0, 0, 5]]
    t = pm.pad_plane("group_counts", torch.from_numpy(gc), 3)
    assert t.tolist() == out.tolist()
    zi = pm.pad_plane("zone_idx", np.array([[0, 1]], np.int32), 2)
    assert zi.tolist() == [[0, 1, -1, -1]]


def test_mesh_on_needs_more_than_one_device(monkeypatch):
    monkeypatch.setattr(pm, "default_devices",
                        lambda: [torch.device("cpu")])
    assert pm.maybe_mesh("auto") is None
    with pytest.raises(pm.MeshUnavailable, match=">1 device"):
        pm.maybe_mesh("on")
    monkeypatch.setattr(pm, "default_devices", lambda: [])
    with pytest.raises(pm.MeshUnavailable):
        pm.make_mesh()
    with pytest.raises(ValueError):
        pm.maybe_mesh("sometimes")


def test_grid_with_a_pods_axis_runs_on_its_first_row():
    mesh = pm.make_mesh([torch.device("cpu")] * 6, pods_axis=2)
    assert mesh.shape == {"pods": 2, "nodes": 3}
    assert len(mesh.node_devices) == 3
    with pytest.raises(ValueError):
        pm.make_mesh([torch.device("cpu")] * 6, pods_axis=4)


def test_shard_memory_report_counts_the_shards():
    snap, inp = _host_wave(n_nodes=61, n_pods=20)
    one = pm.shard_memory_report(inp, cpu_mesh(1))
    four = pm.shard_memory_report(inp, cpu_mesh(4))
    assert four["node_shards"] == 4 and four["devices"] == 4
    assert four["sharded_bytes_per_device"] < one["sharded_bytes_per_device"]
    assert four["replicated_bytes_per_device"] == \
        one["replicated_bytes_per_device"]
    assert four["total_bytes_per_device"] == sum(
        four[k] for k in ("sharded_bytes_per_device",
                          "replicated_bytes_per_device",
                          "carry_bytes_per_device",
                          "static_mask_bytes_per_device"))


def test_executor_scatters_zone_group_and_band_deltas():
    """Deltas of the planes whose node axis is not the first (zone_idx,
    group_counts) and of the replicated ones (zone_counts0, band_prio)
    scatter onto the resident shards and decide like a cold transfer."""
    from test_torch_policy import _port_policy
    wave, ref_pol, _ = FIXTURES["anti_affinity_0"]()
    snap = ref_encode(*wave, policy=ref_pol)
    host = bs.SolverInputs(**{
        f: np.asarray(a) for f, a in
        ref_bs.snapshot_to_host_inputs(snap)._asdict().items()})
    pol = _port_policy(ref_pol)
    me = _executor()
    key = ("w", "b0")
    me.solve(host, pol, False, cache_key=key)
    gc = np.array(host.group_counts, copy=True)
    gc[:, 1] += 1
    gc[:, -1] += 2
    zi = np.array(host.zone_idx, copy=True)
    zi[0, -1] = -1
    zc = np.array(host.zone_counts0, copy=True)
    zc[0] += 1
    new = host._replace(group_counts=gc, zone_idx=zi, zone_counts0=zc)
    rows_g = np.arange(gc.shape[0])
    delta = {"group_counts": (host.group_counts, rows_g, gc[rows_g]),
             "zone_idx": (host.zone_idx, np.array([0]), zi[[0]]),
             "zone_counts0": (host.zone_counts0, np.array([0]), zc[[0]])}
    before = me._m.reshard_bytes.value()
    via_delta = me.solve(new, pol, False, cache_key=key, delta=delta)
    assert me._m.reshard_bytes.value() == before
    cold = _executor()
    via_full = cold.solve(new, pol, False, cache_key=("w2", "b0"))
    want = [t.numpy() for t in bs.solve_scan(bs.ship_inputs(new, "cpu"),
                                             pol)]
    for got in (via_delta, via_full):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_chip_smoke_mesh_phase_runs_on_the_cpu_at_a_small_size():
    """chip_smoke's phase 13 on three CPU shards at a small size: (a) the
    sharded loop == single-device == commit_solve's plain version; (b) the
    crossover through solve(snap, mesh=) runs no sharded loop; (c) a wave
    of 40 services (64 groups) through the crossover to the kernel, a
    wave of 40 priority bands beyond the kernel's domain through the
    sharded loop, a preemption and a zone anti-affinity wave; (d) the
    executor's churn rides delta scatters; (e) a late-churn wave
    compacts."""
    import chip_smoke
    m = chip_smoke._mesh_phase(
        "cpu", shards=3, mesh_nodes=61, mesh_pods=40, cap_nodes=45,
        cap_pods=24, cap_services=40, ext_nodes=41, ext_pods=30,
        churn_nodes=53, churn_waves=3, churn_wave=16, late_nodes=400,
        late_free=60, late_pods=24, count_launches=False)
    assert m["b"]["sharded_loops"] == 0 and m["b"]["plain_calls"] == 1
    assert m["c"]["preemption"]["by_preemption"] > 0
    assert [w["reshard_bytes"] for w in m["d"]["waves"]] == [0, 0, 0]
    assert all(w["delta_planes"] for w in m["d"]["waves"][1:])
    assert m["d"]["parity_checks"] == 3 and m["d"]["parity_divergent"] == 0
    assert 0 < m["e"]["kept"] < m["e"]["nodes"]
    assert m["a"]["memory"]["node_shards"] == 3
