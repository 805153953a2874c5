"""chip_smoke.py's phase 17 at a small size, on the plain version.

(a) The port's kube-apiserver as a process with 40 of north_star's nodes
and 60 residents, the scheduler binary in a thread, two nodes drained by
``kubectl drain`` processes, 20 pods created while the binary is held
and the port's kube-descheduler started as a process: it declines while
they are pending, they bind, and the drained nodes empty with no pod
moved twice or lost, no score regression and a fragmentation gauge that
never rises. (b) The apiserver, the controller manager, the binary and
three kubelet processes with the process runtime: an RC of 12 pods runs
as process groups under the native pause sandbox (600m and 1Gi nodes, so
that no node is a voluntary source), the endpoints name every pod,
``kubectl drain node-0`` and the descheduler move node-0's pods, its
runtime stops them and the other kubelets run them. Each of the
binary's waves is held against the plain version and
solve(encode_snapshot(...)) of its state by the phase, and here also
against the JAX package's ``batch_solver.solve`` of the same state, its
objects carried over the v1 wire. Launches are not counted (the plain
version runs instead of the kernel).
"""

import json

import chip_smoke
from kubernetes_tpu.api.latest import scheme as ref_scheme
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from kubernetes_tpu_torch.api.latest import scheme as port_scheme


def _to_ref(objs):
    return [ref_scheme.decode(json.dumps(port_scheme.encode_to_wire(o)))
            for o in objs]


def _held_against_the_reference(rows, svcs):
    svcs = _to_ref(svcs)
    for k, r in enumerate(rows):
        snap = ref_encode(_to_ref(r["nodes"]), _to_ref(r["existing"]),
                          _to_ref(r["order"]), svcs)
        chosen, _ = ref_bs.solve(snap)
        want = [(p.metadata.name, h) for p, h in
                zip(r["order"], ref_bs.decisions_to_names(snap, chosen)) if h]
        assert sorted(want) == sorted(r["placed"]), f"wave {k}"


def test_drain_through_the_descheduler():
    a = chip_smoke._descheduler_phase(
        "cpu", n_nodes=40, n_residents=60, n_drain=2, n_extra=20,
        seeders=4, wave_size=32, count_launches=False, keep_rows=True)
    assert len(a["drained"]) == 2 and a["on_drained"] == 4
    assert a["mandatory"] == 4 and a["migrations"] >= 4
    assert a["descheduler"]["declined"]["pending_work"] >= 1
    assert a["descheduler"]["score_regressions_total"] == 0
    assert a["descheduler"]["nodes_drained_total"] == 2
    assert a["scores"] and a["scores"] == sorted(a["scores"], reverse=True)
    assert len(a["rows"]) == len(a["waves"]) >= 1
    _held_against_the_reference(a["rows"], a["svcs"])


def test_kubelets_run_the_pods_and_a_drain_moves_them():
    b = chip_smoke._kubelet_phase(
        "cpu", kubelets=3, replicas=12, node_cpu="600m", node_memory="1Gi",
        wave_size=32, count_launches=False, keep_rows=True)
    assert b["per_node"] == {"node-0": 4, "node-1": 4, "node-2": 4}
    assert b["moved"] == 4 and b["per_node_after"]["node-0"] == 0
    assert sum(b["per_node_after"].values()) == 12
    assert b["runtime_processes"] == 24
    assert "/pause" in b["sandbox"]
    assert b["descheduler"]["migrations_total"] == 4
    _held_against_the_reference(b["rows"], b["svcs"])
