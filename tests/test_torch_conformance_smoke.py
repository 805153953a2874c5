"""chip_smoke.py's phase 19 on the CPU, on the plain version.

(a) The port's standalone cluster (3 nodes, ``--algorithm tpu-batch
--device cpu``) in a thread and the port's e2e driver at it with
``--master``: all nine suites pass, and each of the scheduler's waves is
held against the plain version and solve(encode_snapshot(...)) of the
encoder's state by the phase, and here also against the JAX package's
``batch_solver.solve`` of the same state with the wave's own services.
(b) The port's stress harness in this process with the tpu-batch
scheduler on the CPU: CLEAN, every wave equal to the plain version, the
switch interval restored. Launches are not counted (the plain version
runs instead of the kernel).
"""

import sys

import chip_smoke
from kubernetes_tpu.models import batch_solver as ref_bs
from kubernetes_tpu.models.snapshot import encode_snapshot as ref_encode
from test_torch_descheduler_smoke import _to_ref


def test_e2e_suites_against_the_standalone_on_tpu_batch():
    a = chip_smoke._e2e_phase("cpu", count_launches=False, keep_rows=True)
    assert sorted(a["suites_s"]) == sorted(
        ["pods", "replication", "services", "events", "secrets", "watch",
         "kubectl", "guestbook", "update-demo"])
    assert a["max_abs_err"] == 0
    rows = a["rows"]
    assert len(rows) == len(a["waves"]) >= 5
    # the guestbook's 1 + 2 + 3 (+ 2 on the resize) and the update demo's
    # 2 + 2 (+ 2) pods are among the placed
    assert a["pods_placed"] >= 14
    for k, r in enumerate(rows):
        snap = ref_encode(_to_ref(r["nodes"]), _to_ref(r["existing"]),
                          _to_ref(r["order"]), _to_ref(r["services"]))
        chosen, _ = ref_bs.solve(snap)
        want = [(p.metadata.name, h) for p, h in
                zip(r["order"], ref_bs.decisions_to_names(snap, chosen)) if h]
        assert sorted(want) == sorted(r["placed"]), f"wave {k}"


def test_stress_harness_in_process_on_tpu_batch():
    before = sys.getswitchinterval()
    b = chip_smoke._stress_phase("cpu", seconds=3, writers=2,
                                 count_launches=False)
    assert b["verdict"].endswith("CLEAN")
    assert b["restored"] == before == sys.getswitchinterval()
    assert b["waves"] >= 1 and b["max_abs_err"] == 0
    assert b["plain_calls"] >= b["waves"]
