"""Active sub-meshing in the port (models/submesh.py), on the CPU.

``tests/test_submesh.py`` runs against the port through ``port_twin``:
its ``jax.numpy`` arrays are read as torch's (``torch.asarray``), its
``solve_jit`` as the port's ``solve_scan``, and ``ship_inputs(host)`` as
``ship_inputs(host, "cpu")``; meshes are eight CPU shards
(``mesh_on_the_cpu``). Every case runs, none is left out. Its
``zone_bf16`` case passes the flag through; the port sums zones exactly
either way.

Port-own cases (tolerance: exact, chosen and scores): the compacted solve
equals the full one and the JAX package's ``submesh_program`` on the same
numpy planes; the executor's compacted path rides the delta wire with
its residency intact and counts ``solverd_submesh_*``; a compacted
gang wave with rollback; ``compact_inputs`` keeps the off-list slot last.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models import submesh as ref_sm
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu.parallel.mesh import RESIDENT_FIELDS as REF_RESIDENT
from kubernetes_tpu.parallel.mesh import WAVE_FIELDS as REF_WAVE
from kubernetes_tpu_torch.models import batch_solver as bs
from kubernetes_tpu_torch.models import submesh
from kubernetes_tpu_torch.models.batch_solver import SolverInputs
from kubernetes_tpu_torch.util import metrics as port_metrics
from test_torch_policy import _port_policy
from test_torch_twin import mesh_on_the_cpu, port_twin

# the suite runs in parallel workers: one intra-op thread each
torch.set_num_threads(1)

globals().update(port_twin("test_submesh", rename={
    "import jax.numpy as jnp": "import torch as jnp",
    "solve_jit": "solve_scan",
    "ship_inputs(host)": 'ship_inputs(host, "cpu")',
}))


@pytest.fixture(autouse=True)
def _mesh_on_the_cpu(monkeypatch):
    mesh_on_the_cpu(monkeypatch)


def _ref_wave(**kw):
    """full_cluster's wave built with the JAX package's API types (the
    twin's full_cluster builds the port's)."""
    import test_submesh as ref_t
    return ref_t.full_cluster(**kw)


def test_compacted_solve_equals_jax_submesh_program():
    nodes, existing, pending, services = _ref_wave(peers=5, seed=21)
    snap = ref_encode(nodes, existing, pending, services)
    host = ref_bs.snapshot_to_host_inputs(snap)
    plan = ref_sm.plan_wave(host, snap.policy)
    assert plan is not None
    ref_bs.ensure_x64()
    rin = ref_bs.ship_inputs(host)
    res = tuple(getattr(rin, f) for f in REF_RESIDENT)
    import jax.numpy as jnp
    wav = tuple(jnp.asarray(ref_sm.remap_pod_host_idx(getattr(host, f), plan)
                            if f == "pod_host_idx" else getattr(host, f))
                for f in REF_WAVE)
    jc, js = ref_sm.submesh_program(snap.policy, False)(
        res, wav, plan.keep_idx, plan.valid)
    phost = SolverInputs(**{f: np.asarray(a)
                            for f, a in host._asdict().items()})
    pplan = submesh.plan_wave(phost, _port_policy(snap.policy))
    assert np.array_equal(pplan.keep_idx, plan.keep_idx)
    assert np.array_equal(pplan.valid, plan.valid)
    run = run_submesh(phost, _port_policy(snap.policy), False, pplan)
    full = [t.numpy() for t in bs.solve_scan(bs.ship_inputs(phost, "cpu"))]
    for got in (run, full):
        assert np.array_equal(got[0], np.asarray(jc))
        assert np.array_equal(got[1], np.asarray(js))


def test_compact_inputs_keeps_the_off_list_slot_last():
    nodes, existing, pending, services = full_cluster(peers=5, seed=2)
    snap = encode_snapshot(nodes, existing, pending, services)
    host = snapshot_to_host_inputs(snap)
    gc = np.array(host.group_counts, copy=True)
    gc[:, -1] = 7
    host = host._replace(group_counts=gc)
    plan = submesh.plan_wave(host, snap.policy)
    inp = ship_inputs(host, "cpu")
    comp = submesh.compact_inputs(inp, torch.from_numpy(plan.keep_idx),
                                  torch.from_numpy(plan.valid))
    assert comp.group_counts.shape[1] == plan.keep_idx.shape[0] + 1
    assert (comp.group_counts[:, -1] == 7).all()
    # pad rows hold no peers and no zone label, and can never be chosen
    pad = ~torch.from_numpy(plan.valid)
    assert not comp.group_counts[:, :-1][:, pad].any()
    assert not comp.node_extra_ok[pad].any()
    assert comp.fit_exceeded[pad].all()


def test_compacted_gang_wave_with_rollback_equals_full():
    from kubernetes_tpu_torch.models import gang
    nodes, existing, pending, services = full_cluster(n_free=40,
                                                      n_pending=0, seed=5)
    # two PodGroups that cannot both fit the 40 free nodes of 2 cpu: the
    # second rolls back
    for g, size in enumerate((30, 30)):
        for m in range(size):
            p = mkpod(f"g{g}-m{m}", mcpu=1500)
            p.metadata.annotations = {
                gang.GANG_NAME_ANNOTATION: f"grp{g}",
                gang.GANG_MIN_MEMBERS_ANNOTATION: str(size)}
            pending.append(p)
    snap = encode_snapshot(nodes, existing, pending, services)
    assert snap.has_gangs
    host = snapshot_to_host_inputs(snap)
    plan = submesh.plan_wave(host, snap.policy)
    assert plan is not None
    full = [t.numpy() for t in bs.solve_scan(ship_inputs(host, "cpu"),
                                             snap.policy, True)]
    sub = run_submesh(host, snap.policy, True, plan)
    assert np.array_equal(full[0], sub[0])
    assert np.array_equal(full[1], sub[1])
    assert (full[0] < 0).any() and (full[0] >= 0).any()


def test_executor_submesh_rides_the_delta_wire():
    """Two waves through the executor's single-device layout: the second
    arrives as a delta (fit_used rows of the first wave's binds); both
    compact, the resident planes are scattered, not re-established, and
    both equal the full solve."""
    from kubernetes_tpu_torch.solver.mesh_exec import MeshExecutor
    sm_m = port_metrics.solverd_submesh_metrics()
    waves0 = sm_m.waves.value()
    checks0 = sm_m.parity_checks.value()
    nodes, existing, pending, services = full_cluster(seed=31)
    snap = encode_snapshot(nodes, existing, pending, services)
    host = snapshot_to_host_inputs(snap)
    pol = snap.policy
    me = MeshExecutor(min_nodes=1, dispatch="single", probe="all")
    key = ("w", 0)
    c1, s1 = me.solve(host, pol, False, cache_key=key)
    want1 = [t.numpy() for t in bs.solve_scan(ship_inputs(host, "cpu"), pol)]
    assert np.array_equal(c1, want1[0]) and np.array_equal(s1, want1[1])
    fit = np.array(host.fit_used, copy=True)
    rows = np.unique(c1[c1 >= 0]).astype(np.int64)
    fit[rows] += host.req[0]
    host2 = host._replace(fit_used=fit)
    reshard0 = me._m.reshard_bytes.value()
    c2, s2 = me.solve(host2, pol, False, cache_key=key,
                      delta={"fit_used": (host.fit_used, rows, fit[rows])})
    assert me._m.reshard_bytes.value() == reshard0
    want2 = [t.numpy() for t in bs.solve_scan(ship_inputs(host2, "cpu"), pol)]
    assert np.array_equal(c2, want2[0]) and np.array_equal(s2, want2[1])
    assert me.submesh_waves == 2 and me.submesh_parity_divergent == 0
    assert me.parity_divergent == 0
    assert sm_m.waves.value() == waves0 + 2
    assert sm_m.parity_checks.value() == checks0 + 2
